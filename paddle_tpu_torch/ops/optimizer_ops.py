"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py:
sgd, momentum, adagrad and adam, on dense and on SelectedRows
gradients; lars_momentum, adamax, decayed_adagrad, proximal_adagrad,
proximal_gd, adadelta, rmsprop, ftrl and lamb on dense ones). Updates write ParamOut/...Out, which name the same vars as
their inputs; the engine writes them back to the scope. Gradients never
flow through updates (register_no_grad_op).

Each dense sgd and adam op asks the kernel registry
(kernels/registry.py) as the JAX lowerings do: ``routable`` first, then
``select`` on the operands' signature. A selected kernel (fused_adam,
fused_sgd: float32, at least PT_KERNEL_MIN_NUMEL elements) runs, in
place on the card; otherwise the op computes the plain update on
whatever device it is on. Either way the arithmetic is the JAX
lowering's, bit for bit. The engine hands a run of sgd ops that share a
LearningRate to sgd_group, and a run of adam ops that share a
LearningRate, beta1, beta2 and epsilon to adam_group: each op still asks
the registry (and is counted) on its own, and every parameter a kernel
with a list entry (run_many) takes is updated in one call of it.
momentum and adagrad have no kernel (nor have they in the JAX package).

adam computes the bias-corrected rate lr_t = lr*sqrt(1-b2^t)/(1-b1^t) on
the device and folds the beta-power updates Beta1PowOut = b1^t*b1,
Beta2PowOut = b2^t*b2 into the op (adam_group's list kernel computes
both itself, with the same roundings). Nothing is read back to the host:
hundreds of host syncs a step would stall the stream.

A SelectedRows gradient (core/selected_rows.py) takes the JAX package's
sparse branch before any kernel is asked: sgd adds -lr*g into the rows
(duplicates and all); momentum, adagrad and adam merge the rows, gather
the state of the touched rows, update those and write them back, in
place. Each parked slot of the merge (core/selected_rows.py) is
redirected so that no index out of range reaches a torch kernel and no
parked slot overwrites a live row (_touched_rows).
"""
from __future__ import annotations

import torch

from ..core.registry import register_group, register_no_grad_op
from ..core.selected_rows import is_selected_rows, parked_to_row0
from ..kernels import registry as kreg
from ..kernels.fused_optimizer import _sqrt_rn, adam_plain, sgd_plain


def _select(op_type, *tensors):
    """The registry's kernel for this update, or None for the plain
    update."""
    if not kreg.routable(op_type, tensors[0].device):
        return None
    return kreg.select(op_type, kreg.signature(op_type, *tensors))


def _grad(ctx, op_type):
    """The op's gradient: a dense tensor or a SelectedRows. A tensor in
    one of torch's sparse layouts is refused: the port's sparse gradient
    is a SelectedRows."""
    g = ctx.input("Grad")
    if not is_selected_rows(g) and g.layout != torch.strided:
        raise NotImplementedError(
            f"{op_type}: a sparse gradient in torch's {g.layout} layout; "
            f"the port's sparse gradient is a SelectedRows")
    return g


def _touched_rows(g, dtype):
    """(idx, gv, frozen) of SelectedRows gradient g, merged: idx [n] the
    row each slot reads and writes, gv [n, ...] its gradient slice in
    `dtype`, frozen a one-element bool, True when no slot is live.

    The merge sorts parked slots last, so slot 0 is live unless all are
    parked. A parked slot takes slot 0's row and gradient: it computes
    and writes exactly what slot 0 does, so the order of the writes
    cannot matter. When every slot is parked, each reads row 0 and, by
    `frozen`, writes back what it read."""
    m = g.merged()
    rows, gv = m.rows, m.values.to(dtype)
    parked = rows == m.height
    first = rows[:1]
    frozen = first == m.height
    idx = torch.where(parked, first.masked_fill(frozen, 0), rows)
    wide = (-1,) + (1,) * (gv.ndim - 1)
    gv = torch.where(parked.reshape(wide), gv[:1], gv)
    return idx, gv, frozen.reshape((1,) * gv.ndim)


def _write_rows(t, idx, new, old, frozen):
    """Rows idx of t set to `new` in place (to `old`, what they held,
    when frozen); returns t."""
    return t.index_copy_(0, idx, torch.where(frozen, old, new))


@register_no_grad_op("momentum")
def momentum(ctx):
    """v' = mu*v + g; p' = p - lr*v', or with use_nesterov
    p' = p - (g + mu*v')*lr: the JAX lowering's operations in its order,
    each rounded once (no kernel: the JAX package has none); on a
    SelectedRows gradient, for the touched rows only."""
    p, v = ctx.input("Param"), ctx.input("Velocity")
    g = _grad(ctx, "momentum")
    lr = ctx.input("LearningRate").reshape(()).to(p.dtype)
    mu = ctx.attr("mu")
    nesterov = ctx.attr("use_nesterov", False)
    sparse = is_selected_rows(g)
    if sparse:
        idx, g, frozen = _touched_rows(g, p.dtype)
        p_old, v_old = p.index_select(0, idx), v.index_select(0, idx)
    else:
        p_old, v_old = p, v
    v_new = mu * v_old + g
    if nesterov:
        p_new = p_old - (g + mu * v_new) * lr
    else:
        p_new = p_old - lr * v_new
    if sparse:
        p_new = _write_rows(p, idx, p_new, p_old, frozen)
        v_new = _write_rows(v, idx, v_new, v_old, frozen)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_no_grad_op("adagrad")
def adagrad(ctx):
    """m' = m + g*g; p' = p - lr*g/(sqrt(m') + eps): the JAX lowering's
    operations in its order (no kernel: the JAX package has none); on a
    SelectedRows gradient, for the touched rows only."""
    p, m = ctx.input("Param"), ctx.input("Moment")
    g = _grad(ctx, "adagrad")
    lr = ctx.input("LearningRate").reshape(()).to(p.dtype)
    eps = ctx.attr("epsilon", 1e-6)
    sparse = is_selected_rows(g)
    if sparse:
        idx, g, frozen = _touched_rows(g, p.dtype)
        p_old, m_old = p.index_select(0, idx), m.index_select(0, idx)
    else:
        p_old, m_old = p, m
    m_new = m_old + g * g
    p_new = p_old - lr * g / (torch.sqrt(m_new) + eps)
    if sparse:
        p_new = _write_rows(p, idx, p_new, p_old, frozen)
        m_new = _write_rows(m, idx, m_new, m_old, frozen)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("MomentOut", m_new)


def _sgd_operands(ctx):
    """(p, g, lr, the registry's kernel or None) of one sgd op; g is a
    SelectedRows (and the kernel None) for a sparse gradient."""
    p, g = ctx.input("Param"), _grad(ctx, "sgd")
    lr = ctx.input("LearningRate").reshape(1).to(p.dtype)
    if is_selected_rows(g):
        return p, g, lr, None
    sel = _select("sgd", p, g)
    return p, g.to(p.dtype).contiguous(), lr, sel


def _sgd_one(ctx, p, g, lr, sel):
    """One sgd op's update. On a SelectedRows gradient -lr*g is added
    into the rows in place, duplicates one by one, each parked slot
    adding -0.0 to row 0."""
    if is_selected_rows(g):
        rows, upd = parked_to_row0(
            g.rows, (-lr.reshape(())) * g.values.to(p.dtype), g.height)
        ctx.set_output("ParamOut", p.index_add_(0, rows, upd))
    elif sel is not None:
        ctx.set_output("ParamOut", sel.run(p, g, lr))
    else:
        ctx.set_output("ParamOut", sgd_plain(p, g, lr.reshape(())))


@register_no_grad_op("sgd")
def sgd(ctx):
    _sgd_one(ctx, *_sgd_operands(ctx))


@register_group("sgd", key=lambda op: tuple(op.input("LearningRate")))
def sgd_group(ctxs):
    """A run of sgd ops with one LearningRate var: the parameters each
    kernel with a list entry takes go to it in one call (lr from the
    first of them), every other parameter (a sparse gradient's among
    them) as through sgd()."""
    lists = {}
    for ctx in ctxs:
        p, g, lr, sel = _sgd_operands(ctx)
        if sel is not None and sel.run_many is not None:
            entry = lists.setdefault(sel.name, (sel, lr, [], [], []))
            entry[2].append(ctx)
            entry[3].append(p)
            entry[4].append(g)
        else:
            _sgd_one(ctx, p, g, lr, sel)
    for sel, lr, cs, ps, gs in lists.values():
        for ctx, p_new in zip(cs, sel.run_many(ps, gs, lr)):
            ctx.set_output("ParamOut", p_new)


def _adam_operands(ctx):
    """(p, g, m, v, lr, b1p, b2p, the registry's kernel or None) of one
    adam op: lr, b1p and b2p one-element tensors in p's dtype; g is a
    SelectedRows (and the kernel None) for a sparse gradient."""
    p, g = ctx.input("Param"), _grad(ctx, "adam")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    lr = ctx.input("LearningRate").reshape(1).to(p.dtype)
    b1p = ctx.input("Beta1Pow").reshape(1).to(p.dtype)
    b2p = ctx.input("Beta2Pow").reshape(1).to(p.dtype)
    if is_selected_rows(g):
        return p, g, m, v, lr, b1p, b2p, None
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
    single entry, the plain update, or on a SelectedRows gradient the
    plain update of the touched rows."""
    b1, b2, eps = _adam_hyper(ctx)
    lr_t = lr.reshape(()) * torch.sqrt(1 - b2p.reshape(())) / \
        (1 - b1p.reshape(()))
    if is_selected_rows(g):
        idx, g, frozen = _touched_rows(g, p.dtype)
        old = [t.index_select(0, idx) for t in (p, m, v)]
        new = adam_plain(*old[:1], g, *old[1:], lr_t, b1, b2, eps)
        p_new, m_new, v_new = (_write_rows(t, idx, n, o, frozen)
                               for t, n, o in zip((p, m, v), new, old))
    elif sel is not None:
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
    adam() (a sparse gradient's among them)."""
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


# ---------------------------------------------------------------------------
# lars_momentum, adamax, decayed_adagrad, proximal_adagrad, proximal_gd,
# adadelta, rmsprop, ftrl, lamb: dense updates with no kernel (none in the
# JAX package), each the JAX lowering's operations in its order, each
# rounded once; every square root correctly rounded (_sqrt), so that the
# CPU update equals the JAX one bit for bit
# ---------------------------------------------------------------------------

def _sqrt(x):
    """The correctly rounded square root: the card's is; torch's float32
    one on the CPU is not in about 0.7 % of inputs (_sqrt_rn)."""
    return torch.sqrt(x) if x.is_cuda else _sqrt_rn(x)


def _lr(ctx, p):
    return ctx.input("LearningRate").reshape(()).to(p.dtype)


def _norm(x):
    """sqrt(sum(x*x)) over every element."""
    return _sqrt(torch.sum(x * x))


@register_no_grad_op("lars_momentum")
def lars_momentum(ctx):
    """local_lr = lr*coeff*|p| / (|g| + decay*|p| + 1e-18);
    v' = mu*v + local_lr*(g + decay*p); p' = p - v'."""
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    lr = _lr(ctx, p)
    mu = ctx.attr("mu")
    coeff = ctx.attr("lars_coeff", 0.001)
    decay = ctx.attr("lars_weight_decay", 0.0005)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = lr * coeff * p_norm / (g_norm + decay * p_norm + 1e-18)
    v_new = mu * v + local_lr * (g + decay * p)
    ctx.set_output("ParamOut", p - v_new)
    ctx.set_output("VelocityOut", v_new)


@register_no_grad_op("adamax")
def adamax(ctx):
    """m' = b1*m + (1-b1)*g; u' = max(b2*u, |g|);
    p' = p - (lr/(1-b1^t))*m'/(u' + eps). Beta1Pow moves in the scale op
    the optimizer appends after the updates."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    lr = _lr(ctx, p)
    b1p = ctx.input("Beta1Pow").reshape(()).to(p.dtype)
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    ctx.set_output("ParamOut",
                   p - (lr / (1 - b1p)) * m_new / (inf_new + eps))
    ctx.set_output("MomentOut", m_new)
    ctx.set_output("InfNormOut", inf_new)


@register_no_grad_op("decayed_adagrad")
def decayed_adagrad(ctx):
    """m' = decay*m + (1-decay)*g*g; p' = p - lr*g/(sqrt(m') + eps)."""
    p, g, mom = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    lr = _lr(ctx, p)
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_new = decay * mom + (1 - decay) * g * g
    ctx.set_output("ParamOut", p - lr * g / (_sqrt(m_new) + eps))
    ctx.set_output("MomentOut", m_new)


def _proximal(prox, lr_t, l1, l2):
    """sign(prox) * max(|prox| - lr_t*l1, 0) / (1 + lr_t*l2)."""
    return torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr_t * l1, 0.0) / (1.0 + lr_t * l2)


@register_no_grad_op("proximal_adagrad")
def proximal_adagrad(ctx):
    """m' = m + g*g; lr_t = lr/sqrt(m'); the proximal step of
    p - lr_t*g."""
    p, g, mom = ctx.input("Param"), ctx.input("Grad"), ctx.input("Moment")
    lr = _lr(ctx, p)
    m_new = mom + g * g
    lr_t = lr / _sqrt(m_new)
    ctx.set_output("ParamOut", _proximal(p - lr_t * g, lr_t,
                                         ctx.attr("l1", 0.0),
                                         ctx.attr("l2", 0.0)))
    ctx.set_output("MomentOut", m_new)


@register_no_grad_op("proximal_gd")
def proximal_gd(ctx):
    """The proximal step of p - lr*g."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = _lr(ctx, p)
    ctx.set_output("ParamOut", _proximal(p - lr * g, lr,
                                         ctx.attr("l1", 0.0),
                                         ctx.attr("l2", 0.0)))


@register_no_grad_op("adadelta")
def adadelta(ctx):
    """E[g^2]' = rho*E[g^2] + (1-rho)*g*g;
    upd = -sqrt((E[u^2] + eps)/(E[g^2]' + eps))*g;
    E[u^2]' = rho*E[u^2] + (1-rho)*upd*upd; p' = p + upd (no rate)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    asg, asu = ctx.input("AvgSquaredGrad"), ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    g2 = rho * asg + (1 - rho) * g * g
    upd = -_sqrt((asu + eps) / (g2 + eps)) * g
    ctx.set_output("ParamOut", p + upd)
    ctx.set_output("AvgSquaredGradOut", g2)
    ctx.set_output("AvgSquaredUpdateOut", rho * asu + (1 - rho) * upd * upd)


@register_no_grad_op("rmsprop")
def rmsprop(ctx):
    """ms' = decay*ms + (1-decay)*g*g; centered: mg' = decay*mg +
    (1-decay)*g and denominator ms' - mg'^2 + eps, else ms' + eps;
    mom' = momentum*mom + lr*g/sqrt(denominator); p' = p - mom'."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    lr = _lr(ctx, p)
    eps = ctx.attr("epsilon", 1e-10)
    decay = ctx.attr("decay", 0.9)
    momentum = ctx.attr("momentum", 0.0)
    ms_new = decay * ms + (1 - decay) * g * g
    if ctx.attr("centered", False):
        mg_new = decay * ctx.input("MeanGrad") + (1 - decay) * g
        denom = ms_new - mg_new * mg_new + eps
        ctx.set_output("MeanGradOut", mg_new)
    else:
        denom = ms_new + eps
    mom_new = momentum * mom + lr * g / _sqrt(denom)
    ctx.set_output("ParamOut", p - mom_new)
    ctx.set_output("MeanSquareOut", ms_new)
    ctx.set_output("MomentOut", mom_new)


@register_no_grad_op("ftrl")
def ftrl(ctx):
    """FTRL-proximal with the reference's 2*l2 denominator: n' = n + g*g;
    sigma = (n'^-power - n^-power)/lr; z' = z + g - sigma*p;
    p' = (clip(z', -l1, l1) - z') / (2*l2 + n'^-power/lr) (square roots
    for the default power -0.5)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    sq, lin = ctx.input("SquaredAccumulator"), ctx.input("LinearAccumulator")
    lr = _lr(ctx, p)
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    power = ctx.attr("lr_power", -0.5)
    new_sq = sq + g * g
    if power == -0.5:
        root_new = _sqrt(new_sq)
        sigma = (root_new - _sqrt(sq)) / lr
    else:
        root_new = torch.pow(new_sq, -power)
        sigma = (root_new - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    x = 2.0 * l2 + root_new / lr
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    ctx.set_output("ParamOut", pre / x)
    ctx.set_output("SquaredAccumOut", new_sq)
    ctx.set_output("LinearAccumOut", new_lin)


@register_no_grad_op("lamb")
def lamb(ctx):
    """Adam's moments, their bias-corrected ratio plus wd*p as r, and the
    trust ratio |p|/|r| (1 where either is 0): p' = p - lr*trust*r; the
    beta powers fold into the op as adam's do."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    lr = _lr(ctx, p)
    b1p = ctx.input("Beta1Pow").reshape(()).to(p.dtype)
    b2p = ctx.input("Beta2Pow").reshape(()).to(p.dtype)
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-6)
    wd = ctx.attr("weight_decay", 0.0)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    r = (m_new / (1 - b1p)) / (_sqrt(v_new / (1 - b2p)) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones((), dtype=p.dtype, device=p.device))
    ctx.set_output("ParamOut", p - lr * trust * r)
    ctx.set_output("Moment1Out", m_new)
    ctx.set_output("Moment2Out", v_new)
    ctx.set_output("Beta1PowOut",
                   (b1p * b1).reshape(ctx.input("Beta1Pow").shape))
    ctx.set_output("Beta2PowOut",
                   (b2p * b2).reshape(ctx.input("Beta2Pow").shape))
