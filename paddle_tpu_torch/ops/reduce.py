"""Reductions (counterpart of paddle_tpu/ops/reduce.py: reduce_sum,
mean and cos_sim)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("reduce_sum")
def reduce_sum(ctx):
    x = ctx.input("X")
    keep = ctx.attr("keep_dim", False)
    if ctx.attr("reduce_all", False):
        out = x.sum()
        if keep:
            out = out.reshape([1] * x.ndim)
    else:
        dims = ctx.attr("dim", [0])
        if isinstance(dims, int):
            dims = [dims]
        out = x.sum(dim=[d if d >= 0 else d + x.ndim for d in dims],
                    keepdim=keep)
    ctx.set_output("Out", out)


@register_op("mean")
def mean(ctx):
    """The mean of every element, a 0-d tensor (as the JAX op gives)."""
    ctx.set_output("Out", ctx.input("X").mean())


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
