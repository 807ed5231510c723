"""Reductions (counterpart of paddle_tpu/ops/reduce.py): reduce_sum /
mean / max / min / prod / all / any over `dim` (or everything with
reduce_all) with keep_dim, mean, the norms (squared_l2_norm, l1_norm,
norm, frobenius_norm), squared_l2_distance, minus and cos_sim.
reduce_max / reduce_min split the gradient evenly among ties, as XLA's
reductions do (amax / amin)."""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op, register_op


def _dims(ctx, x):
    """The reduced dims, non-negative; None for all of them."""
    if ctx.attr("reduce_all", False):
        return None
    dims = ctx.attr("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    return [d if d >= 0 else d + x.ndim for d in dims]


# jnp.sum's accumulation type for an integer X (torch would widen every
# one to int64): bool, int8 and int16 sum to int32, int32 and int64 keep
# their type. uint8 and uint16 sum to uint32 there; torch has no uint32
# sum, so here they take int64, which holds every such sum exactly.
_SUM_TYPE = {torch.bool: torch.int32, torch.int8: torch.int32,
             torch.int16: torch.int32, torch.uint8: torch.int64,
             torch.uint16: torch.int64}


@register_op("reduce_sum")
def reduce_sum(ctx):
    """The sum in jnp.sum's type (`_SUM_TYPE`): an int32 X sums to int32,
    as in the JAX op and the reference."""
    x = ctx.input("X")
    keep = ctx.attr("keep_dim", False)
    dt = None if x.is_floating_point() else _SUM_TYPE.get(x.dtype, x.dtype)
    if ctx.attr("reduce_all", False):
        out = x.sum(dtype=dt)
        if keep:
            out = out.reshape([1] * x.ndim)
    else:
        out = x.sum(dim=_dims(ctx, x), keepdim=keep, dtype=dt)
    ctx.set_output("Out", out)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = x.prod(dim=d, keepdim=keepdim)
    return x


def _reduce(op_type, fn, grad=True):
    reg = register_op if grad else register_no_grad_op

    @reg(op_type)
    def _lower(ctx, _fn=fn):
        x = ctx.input("X")
        dims = _dims(ctx, x)
        keep = ctx.attr("keep_dim", False)
        out = _fn(x, list(range(x.ndim)) if dims is None else dims, keep)
        ctx.set_output("Out", out)
    _lower.__name__ = op_type
    return _lower


_reduce("reduce_mean", lambda x, d, k: x.mean(dim=d, keepdim=k))
_reduce("reduce_max", lambda x, d, k: x.amax(dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: x.amin(dim=d, keepdim=k))
_reduce("reduce_prod", _prod)
_reduce("reduce_all", lambda x, d, k: torch.all(x, dim=d, keepdim=k),
        grad=False)
_reduce("reduce_any", lambda x, d, k: torch.any(x, dim=d, keepdim=k),
        grad=False)


@register_op("mean")
def mean(ctx):
    """The mean of every element, a 0-d tensor (as the JAX op gives)."""
    ctx.set_output("Out", ctx.input("X").mean())


@register_op("squared_l2_norm")
def squared_l2_norm(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", (x * x).sum())


@register_op("squared_l2_distance")
def squared_l2_distance(ctx):
    """Row-wise sum of (X - Y)^2 over the last axis; sub_result is
    X - Y."""
    d = ctx.input("X") - ctx.input("Y")
    ctx.set_output("sub_result", d)
    ctx.set_output("Out", (d * d).sum(-1, keepdim=True))


@register_op("l1_norm")
def l1_norm(ctx):
    ctx.set_output("Out", ctx.input("X").abs().sum())


@register_op("norm")
def norm(ctx):
    """X / sqrt(sum(X^2, axis) + epsilon), with that norm in Norm."""
    x = ctx.input("X")
    n = torch.sqrt((x * x).sum(ctx.attr("axis", -1), keepdim=True)
                   + ctx.attr("epsilon", 1e-10))
    ctx.set_output("Norm", n)
    ctx.set_output("Out", x / n)


@register_op("frobenius_norm")
def frobenius_norm(ctx):
    x = ctx.input("X")
    dims = _dims(ctx, x)
    ctx.set_output("Out", torch.sqrt((x * x).sum(
        dim=list(range(x.ndim)) if dims is None else dims,
        keepdim=ctx.attr("keep_dim", False))))


@register_op("minus")
def minus(ctx):
    ctx.set_output("Out", ctx.input("X") - ctx.input("Y"))


@register_op("cos_sim")
def cos_sim(ctx):
    """Row-wise cosine similarity over the last axis, with the norms of
    X and Y (Y may be one row, broadcast to X's)."""
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt((x * x).sum(-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(-1, keepdim=True))
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)
    ctx.set_output("Out", (x * y).sum(-1, keepdim=True) / (xn * yn))
