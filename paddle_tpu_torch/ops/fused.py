"""fused_attention forward (counterpart of paddle_tpu/ops/fused.py).

The op always goes through kernels/flash_attention.fused_attention_forward:
on a CUDA tensor that launches the hand-written kernel, on a CPU tensor
it runs the plain version. The JAX package's TPU block-size policy and
its kernel-vs-composed crossover were measured on a TPU and are not
carried over: the CUDA kernel picks its own tiles, and block_q/block_k
stay in the Program only for parity."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..kernels.flash_attention import fused_attention_forward


def _attn_args(ctx):
    """One parse of the op for forward (and, later, grad): scale,
    layout, causal and the dropout spec."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    bias = ctx.input("BiasQK") if ctx.has_input("BiasQK") else None
    if bias is not None:
        bias = bias.float()   # the kernel reads the mask in float32
    layout = ctx.attr("layout", "bhsd") or "bhsd"
    scale = ctx.attr("scale", None)
    if scale is None or scale <= 0:
        scale = float(q.shape[-1]) ** -0.5
    causal = bool(ctx.attr("causal", False))
    p_drop = float(ctx.attr("dropout_prob", 0.0) or 0.0)
    drop_t = None
    if p_drop and not ctx.attr("is_test", False):
        # u8 keep-threshold, both edges as in the dropout op: t >= 256
        # keeps everything (no dropout), t <= 0 drops everything
        t = int(round((1.0 - p_drop) * 256.0))
        if t < 256:
            drop_t = max(t, 0)
    return q, k, v, bias, layout, scale, causal, p_drop, drop_t


@register_op("fused_attention")
def fused_attention(ctx):
    """Q/K/V: [B, H, S, D] ("bhsd") or [B, S, H, D] ("bshd"); optional
    BiasQK [B, 1|H, Sq|1, Sk] additive. attrs: scale (default d^-0.5),
    layout, dropout_prob (off under is_test), causal (masks cols > rows
    in absolute positions)."""
    q, k, v, bias, layout, scale, causal, p_drop, drop_t = _attn_args(ctx)
    if drop_t == 0:
        # dropout_prob ~ 1.0: everything dropped
        ctx.set_output("Out", torch.zeros_like(q))
        return
    out = fused_attention_forward(
        q, k, v, bias, scale, causal, layout,
        dropout_prob=p_drop if drop_t is not None else 0.0)
    ctx.set_output("Out", out)
