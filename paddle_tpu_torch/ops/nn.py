"""Dense NN ops: layer_norm, add_position_encoding,
label_smoothed_softmax_xent (counterpart of paddle_tpu/ops/nn.py)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("layer_norm")
def layer_norm(ctx):
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    axes = list(range(begin, x.ndim))
    # float32 statistics for bf16/fp16 inputs
    reduced = x.dtype in (torch.bfloat16, torch.float16)
    xf = x.float() if reduced else x
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    ctx.set_output("Y", y.to(x.dtype) if reduced else y)
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


@register_op("add_position_encoding")
def add_position_encoding(ctx):
    """Sinusoid table [T, D] (sin half then cos half), computed in
    float64 on the input's device and cast to its dtype, as the JAX
    package computes it in numpy."""
    x = ctx.input("X")  # [B, T, D]
    alpha = ctx.attr("alpha", 1.0)
    beta = ctx.attr("beta", 1.0)
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float64, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / d)
    enc = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    ctx.set_output("Out", alpha * x + beta * enc.to(x.dtype)[None, :, :])


@register_op("label_smoothed_softmax_xent")
def label_smoothed_softmax_xent(ctx):
    """CE against y_j = (1-eps)*[j==y] + eps/K over hard labels:
    lse(l) - (1-eps)*l_y - eps*mean_j(l_j), with no one-hot tensor."""
    logits, label = ctx.input("Logits"), ctx.input("Label")
    eps = ctx.attr("epsilon", 0.0)
    lf = logits.float()
    ids = label.long()
    if ids.ndim == logits.ndim:
        ids = ids.squeeze(-1)
    lse = torch.logsumexp(lf, dim=-1)
    l_y = torch.gather(logits, -1, ids[..., None]).squeeze(-1).float()
    loss = lse - (1.0 - eps) * l_y - eps * lf.mean(dim=-1)
    ctx.set_output("Loss", loss[..., None])
