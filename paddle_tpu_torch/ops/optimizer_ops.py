"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py:
adam, dense gradients). Updates write ParamOut/...Out, which name the
same vars as their inputs; the engine writes them back to the scope.
Gradients never flow through updates (register_no_grad_op).

adam computes the bias-corrected rate lr_t = lr*sqrt(1-b2^t)/(1-b1^t) on
the device, hands the update to kernels/fused_optimizer.fused_adam (on
the card: the CUDA kernel, in place) and folds the beta-power updates
Beta1PowOut = b1^t*b1, Beta2PowOut = b2^t*b2 into the op. Nothing is
read back to the host: 255 host syncs a step would stall the stream.
"""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op
from ..kernels.fused_optimizer import fused_adam


@register_no_grad_op("adam")
def adam(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p_in, b2p_in = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    lr = ctx.input("LearningRate").reshape(()).to(p.dtype)
    b1p = b1p_in.reshape(()).to(p.dtype)
    b2p = b2p_in.reshape(()).to(p.dtype)
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    if g.layout != torch.strided:
        raise NotImplementedError("adam with a sparse gradient is not "
                                  "ported")
    lr_t = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(1)
    g = g.to(p.dtype).contiguous()
    p_new, m_new, v_new = fused_adam(p, g, m, v, lr_t, beta1=b1, beta2=b2,
                                     epsilon=eps)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("Moment1Out", m_new)
    ctx.set_output("Moment2Out", v_new)
    ctx.set_output("Beta1PowOut", (b1p * b1).reshape(b1p_in.shape))
    ctx.set_output("Beta2PowOut", (b2p * b2).reshape(b2p_in.shape))
