"""Activation ops (counterpart of paddle_tpu/ops/activations.py): the
reference's activation table, one torch expression each with the JAX
lowering's attrs and defaults, and prelu, selu and maxout. Gradients
are the generic ones (torch's reverse mode of the same expression)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _a(ctx, name, default):
    v = ctx.attr(name, default)
    return default if v is None else v


def _softshrink(x, lam):
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, torch.zeros_like(x)))


_TABLE = {
    "abs": lambda x, c: torch.abs(x),
    "acos": lambda x, c: torch.acos(x),
    "asin": lambda x, c: torch.asin(x),
    "atan": lambda x, c: torch.atan(x),
    "ceil": lambda x, c: torch.ceil(x),
    "cos": lambda x, c: torch.cos(x),
    "exp": lambda x, c: torch.exp(x),
    "floor": lambda x, c: torch.floor(x),
    "log": lambda x, c: torch.log(x),
    "reciprocal": lambda x, c: 1.0 / x,
    "relu": lambda x, c: torch.relu(x),
    "round": lambda x, c: torch.round(x),
    "rsqrt": lambda x, c: torch.rsqrt(x),
    "sigmoid": lambda x, c: torch.sigmoid(x),
    "sin": lambda x, c: torch.sin(x),
    "softsign": lambda x, c: x / (1 + torch.abs(x)),
    "sqrt": lambda x, c: torch.sqrt(x),
    "square": lambda x, c: x * x,
    "tanh": lambda x, c: torch.tanh(x),
    "tanh_shrink": lambda x, c: x - torch.tanh(x),
    "logsigmoid": lambda x, c: F.logsigmoid(x),
    "softplus": lambda x, c: torch.logaddexp(x, torch.zeros_like(x)),
    "gelu": lambda x, c: F.gelu(x),
    "brelu": lambda x, c: torch.clamp(x, _a(c, "t_min", 0.0),
                                      _a(c, "t_max", 24.0)),
    "relu6": lambda x, c: torch.clamp(x, 0.0, _a(c, "threshold", 6.0)),
    "soft_relu": lambda x, c: torch.log(1 + torch.exp(torch.clamp(
        x, -_a(c, "threshold", 40.0), _a(c, "threshold", 40.0)))),
    "leaky_relu": lambda x, c: torch.where(x >= 0, x,
                                           x * _a(c, "alpha", 0.02)),
    "elu": lambda x, c: torch.where(
        x >= 0, x, _a(c, "alpha", 1.0) * (torch.exp(torch.clamp(x, max=0))
                                          - 1)),
    "hard_sigmoid": lambda x, c: torch.clamp(
        _a(c, "slope", 0.2) * x + _a(c, "offset", 0.5), 0.0, 1.0),
    "hard_shrink": lambda x, c: torch.where(
        torch.abs(x) > _a(c, "threshold", 0.5), x, torch.zeros_like(x)),
    "softshrink": lambda x, c: _softshrink(x, _a(c, "lambda", 0.5)),
    "thresholded_relu": lambda x, c: torch.where(
        x > _a(c, "threshold", 1.0), x, torch.zeros_like(x)),
    "stanh": lambda x, c: _a(c, "scale_b", 1.7159) * torch.tanh(
        _a(c, "scale_a", 2.0 / 3.0) * x),
    "swish": lambda x, c: x * torch.sigmoid(_a(c, "beta", 1.0) * x),
    "pow": lambda x, c: torch.pow(x, _a(c, "factor", 1.0)),
}


def _unary(op_type, fn):
    @register_op(op_type)
    def _lower(ctx, _fn=fn):
        ctx.set_output("Out", _fn(ctx.input("X"), ctx))
    _lower.__name__ = op_type
    return _lower


for _name, _fn in _TABLE.items():
    _unary(_name, _fn)


@register_op("prelu")
def prelu(ctx):
    """where(X > 0, X, alpha X) with one alpha ("all"), one a channel of
    NCHW ("channel") or one an element ("element")."""
    x = ctx.input("X")
    alpha = ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    ctx.set_output("Out", torch.where(x > 0, x, a * x))


@register_op("selu")
def selu(ctx):
    x = ctx.input("X")
    scale = ctx.attr("scale", 1.0507009873554805)
    alpha = ctx.attr("alpha", 1.6732632423543772)
    ctx.set_output("Out", scale * torch.where(
        x > 0, x, alpha * (torch.exp(torch.clamp(x, max=0)) - 1)))


@register_op("maxout")
def maxout(ctx):
    """NCHW X's channels in `groups`-wide groups, the max of each."""
    x = ctx.input("X")
    groups = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", x.reshape(n, c // groups, groups, h, w).amax(2))
