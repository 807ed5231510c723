"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py:
sgd, momentum and adam, dense gradients). Updates write ParamOut/...Out, which
name the same vars as their inputs; the engine writes them back to the
scope. Gradients never flow through updates (register_no_grad_op).

Each op asks the kernel registry (kernels/registry.py) as the JAX
lowerings do: ``routable`` first, then ``select`` on the operands'
signature. A selected kernel (fused_adam, fused_sgd: float32, at least
PT_KERNEL_MIN_NUMEL elements) runs, in place on the card; otherwise the
op computes the plain update on whatever device it is on. Either way
the arithmetic is the JAX lowering's, bit for bit. The engine hands a
run of sgd ops that share a LearningRate to sgd_group, and a run of adam
ops that share a LearningRate, beta1, beta2 and epsilon to adam_group:
each op still asks the registry (and is counted) on its own, and every
parameter a kernel with a list entry (run_many) takes is updated in one
call of it.

adam computes the bias-corrected rate lr_t = lr*sqrt(1-b2^t)/(1-b1^t) on
the device and folds the beta-power updates Beta1PowOut = b1^t*b1,
Beta2PowOut = b2^t*b2 into the op (adam_group's list kernel computes
both itself, with the same roundings). Nothing is read back to the host:
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


@register_no_grad_op("momentum")
def momentum(ctx):
    """v' = mu*v + g; p' = p - lr*v', or with use_nesterov
    p' = p - (g + mu*v')*lr: the JAX lowering's operations in its order,
    each rounded once (no kernel: the JAX package has none)."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    _dense("momentum", g)
    lr = ctx.input("LearningRate").reshape(()).to(p.dtype)
    mu = ctx.attr("mu")
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


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


def _adam_operands(ctx):
    """(p, g, m, v, lr, b1p, b2p, the registry's kernel or None) of one
    adam op: lr, b1p and b2p one-element tensors in p's dtype."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    _dense("adam", g)
    lr = ctx.input("LearningRate").reshape(1).to(p.dtype)
    b1p = ctx.input("Beta1Pow").reshape(1).to(p.dtype)
    b2p = ctx.input("Beta2Pow").reshape(1).to(p.dtype)
    sel = _select("adam", p, g, m, v)
    return p, g.to(p.dtype).contiguous(), m, v, lr, b1p, b2p, sel


def _adam_hyper(ctx):
    return (ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999),
            ctx.attr("epsilon", 1e-8))


def _set_adam_outputs(ctx, p, m, v, b1p_out, b2p_out):
    ctx.set_output("ParamOut", p)
    ctx.set_output("Moment1Out", m)
    ctx.set_output("Moment2Out", v)
    ctx.set_output("Beta1PowOut",
                   b1p_out.reshape(ctx.input("Beta1Pow").shape))
    ctx.set_output("Beta2PowOut",
                   b2p_out.reshape(ctx.input("Beta2Pow").shape))


@register_no_grad_op("adam")
def adam(ctx):
    _adam_update(ctx, *_adam_operands(ctx))


def _adam_update(ctx, p, g, m, v, lr, b1p, b2p, sel):
    """One adam op's update from its operands: the selected kernel's
    single entry, or the plain update."""
    b1, b2, eps = _adam_hyper(ctx)
    lr_t = lr.reshape(()) * torch.sqrt(1 - b2p.reshape(())) / \
        (1 - b1p.reshape(()))
    if sel is not None:
        p_new, m_new, v_new = sel.run(p, g, m, v, lr_t.reshape(1),
                                      beta1=b1, beta2=b2, epsilon=eps)
    else:
        p_new, m_new, v_new = adam_plain(p, g, m, v, lr_t, b1, b2, eps)
    _set_adam_outputs(ctx, p_new, m_new, v_new, b1p * b1, b2p * b2)


@register_group("adam", key=lambda op: (tuple(op.input("LearningRate")),
                                        op.attr("beta1"), op.attr("beta2"),
                                        op.attr("epsilon")))
def adam_group(ctxs):
    """A run of adam ops with one LearningRate var and equal betas and
    epsilon: the parameters each kernel with a list entry takes go to it
    in one call (lr from the first of them; the kernel computes each
    parameter's rate and beta powers), every other parameter as through
    adam()."""
    lists = {}
    for ctx in ctxs:
        p, g, m, v, lr, b1p, b2p, sel = _adam_operands(ctx)
        if sel is not None and sel.run_many is not None:
            entry = lists.setdefault(sel.name, (sel, lr, _adam_hyper(ctx),
                                                [], [[] for _ in range(6)]))
            entry[3].append(ctx)
            for lst, t in zip(entry[4], (p, g, m, v, b1p, b2p)):
                lst.append(t)
        else:
            _adam_update(ctx, p, g, m, v, lr, b1p, b2p, sel)
    for sel, lr, (b1, b2, eps), cs, (ps, gs, ms, vs, b1ps, b2ps) in \
            lists.values():
        outs = sel.run_many(ps, gs, ms, vs, lr, b1ps, b2ps, beta1=b1,
                            beta2=b2, epsilon=eps)
        for ctx, *new in zip(cs, *outs):
            _set_adam_outputs(ctx, *new)
