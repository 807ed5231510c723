"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py:
sgd and adam, dense gradients). Updates write ParamOut/...Out, which
name the same vars as their inputs; the engine writes them back to the
scope. Gradients never flow through updates (register_no_grad_op).

Each op asks the kernel registry (kernels/registry.py) as the JAX
lowerings do: ``routable`` first, then ``select`` on the operands'
signature. A selected kernel (fused_adam, fused_sgd: float32, at least
PT_KERNEL_MIN_NUMEL elements) runs, in place on the card; otherwise the
op computes the plain update on whatever device it is on. Either way
the arithmetic is the JAX lowering's, bit for bit. The engine hands a
run of sgd ops that share a LearningRate to sgd_group: each op still
asks the registry (and is counted) on its own, and every parameter a
kernel with a list entry (run_many) takes is updated in one call of it.

adam computes the bias-corrected rate lr_t = lr*sqrt(1-b2^t)/(1-b1^t) on
the device and folds the beta-power updates Beta1PowOut = b1^t*b1,
Beta2PowOut = b2^t*b2 into the op. Nothing is read back to the host:
hundreds of host syncs a step would stall the stream.
"""
from __future__ import annotations

import torch

from ..core.registry import register_group, register_no_grad_op
from ..kernels import registry as kreg
from ..kernels.fused_optimizer import adam_plain, sgd_plain


def _select(op_type, *tensors):
    """The registry's kernel for this update, or None for the plain
    update."""
    if not kreg.routable(op_type, tensors[0].device):
        return None
    return kreg.select(op_type, kreg.signature(op_type, *tensors))


def _dense(op_type, g):
    if g.layout != torch.strided:
        raise NotImplementedError(f"{op_type} with a sparse gradient is "
                                  f"not ported")


def _sgd_operands(ctx):
    """(p, g, lr, the registry's kernel or None) of one sgd op."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    _dense("sgd", g)
    lr = ctx.input("LearningRate").reshape(1).to(p.dtype)
    sel = _select("sgd", p, g)
    return p, g.to(p.dtype).contiguous(), lr, sel


@register_no_grad_op("sgd")
def sgd(ctx):
    p, g, lr, sel = _sgd_operands(ctx)
    if sel is not None:
        ctx.set_output("ParamOut", sel.run(p, g, lr))
    else:
        ctx.set_output("ParamOut", sgd_plain(p, g, lr.reshape(())))


@register_group("sgd", key=lambda op: tuple(op.input("LearningRate")))
def sgd_group(ctxs):
    """A run of sgd ops with one LearningRate var: the parameters each
    kernel with a list entry takes go to it in one call (lr from the
    first of them), every other parameter as through sgd()."""
    lists = {}
    for ctx in ctxs:
        p, g, lr, sel = _sgd_operands(ctx)
        if sel is not None and sel.run_many is not None:
            entry = lists.setdefault(sel.name, (sel, lr, [], [], []))
            entry[2].append(ctx)
            entry[3].append(p)
            entry[4].append(g)
        elif sel is not None:
            ctx.set_output("ParamOut", sel.run(p, g, lr))
        else:
            ctx.set_output("ParamOut", sgd_plain(p, g, lr.reshape(())))
    for sel, lr, cs, ps, gs in lists.values():
        for ctx, p_new in zip(cs, sel.run_many(ps, gs, lr)):
            ctx.set_output("ParamOut", p_new)


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
    _dense("adam", g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    sel = _select("adam", p, g, m, v)
    g = g.to(p.dtype).contiguous()
    if sel is not None:
        p_new, m_new, v_new = sel.run(p, g, m, v, lr_t.reshape(1),
                                      beta1=b1, beta2=b2, epsilon=eps)
    else:
        p_new, m_new, v_new = adam_plain(p, g, m, v, lr_t, b1, b2, eps)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("Moment1Out", m_new)
    ctx.set_output("Moment2Out", v_new)
    ctx.set_output("Beta1PowOut", (b1p * b1).reshape(b1p_in.shape))
    ctx.set_output("Beta2PowOut", (b2p * b2).reshape(b2p_in.shape))
