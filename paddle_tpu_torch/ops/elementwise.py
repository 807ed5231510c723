"""Elementwise binary ops with fluid's axis broadcast (counterpart of
paddle_tpu/ops/elementwise.py): Y's shape aligns to a contiguous run of
X's dims starting at `axis`; axis == -1 aligns trailing dims; a
Scale_out attr other than 1 scales the result. elementwise_floordiv has
no gradient (floor's is zero, as the JAX package's vjp gives), mod the
remainder's. The comparisons and the logical ops give bool tensors and
no gradient."""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op, register_op


def _broadcast_y(x, y, axis):
    if x.shape == y.shape:
        return y
    if axis is None or axis == -1:
        if y.ndim <= x.ndim:
            return y
        return y.reshape(y.shape[-x.ndim:]) if x.ndim else y
    y_shape = list(y.shape)
    # trim trailing 1s (fluid permits e.g. y=[C,1,1] matched to axis=1)
    while y_shape and y_shape[-1] == 1:
        y_shape.pop()
    new_shape = [1] * axis + y_shape + \
        [1] * (x.ndim - axis - len(y_shape))
    return y.reshape(new_shape)


def _binary(op_type, fn):
    @register_op(op_type)
    def _lower(ctx, _fn=fn):
        x = ctx.input("X")
        y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
        out = _fn(x, y)
        scale = ctx.attr("Scale_out", 1.0) or 1.0
        if scale != 1.0:
            out = out * scale
        ctx.set_output("Out", out)
    _lower.__name__ = op_type
    return _lower


def _floordiv(x, y):
    """Python's floor division (numpy's); a step function, so no
    gradient flows through it."""
    return torch.floor_divide(x.detach(), y.detach())


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_pow", torch.pow)
_binary("elementwise_mod", torch.remainder)
_binary("elementwise_floordiv", _floordiv)


def _compare(op_type, fn):
    @register_no_grad_op(op_type)
    def _lower(ctx, _fn=fn):
        x = ctx.input("X")
        y = _broadcast_y(x, ctx.input("Y"), ctx.attr("axis", -1))
        ctx.set_output("Out", _fn(x, y))
    _lower.__name__ = op_type
    return _lower


_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
_compare("equal", torch.eq)
_compare("not_equal", torch.ne)


def _logical(op_type, fn):
    @register_no_grad_op(op_type)
    def _lower(ctx, _fn=fn):
        ctx.set_output("Out", _fn(*[ctx.input(s) for s in ("X", "Y")
                                    if ctx.has_input(s)]))
    _lower.__name__ = op_type
    return _lower


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not)
