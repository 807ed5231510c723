"""Tensor ops: fill_constant, scale, reshape2, squeeze2, lookup_table
(counterpart of paddle_tpu/ops/basic.py). The "2"-suffixed ops carry an
XShape output, here a zero-size marker holding the input's shape."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import dtype_to_torch


@register_op("fill_constant")
def fill_constant(ctx):
    shape = [int(s) for s in ctx.attr("shape", [])]
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype_to_torch(
                                         ctx.attr("dtype", "float32")),
                                     device=ctx.device))


@register_op("scale")
def scale(ctx):
    x = ctx.input("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        out = x * s + b
    else:
        out = (x + b) * s
    ctx.set_output("Out", out.to(x.dtype))


def _reshape_shape(x, shape):
    """fluid reshape: 0 copies the input's dim at that position, one -1
    takes what is left."""
    shape = [x.shape[i] if d == 0 else int(d) for i, d in enumerate(shape)]
    if -1 in shape:
        known = 1
        for d in shape:
            if d != -1:
                known *= d
        shape[shape.index(-1)] = x.numel() // known
    return shape


def _xshape(ctx, x):
    if ctx.has_output("XShape"):
        ctx.set_output("XShape", torch.empty((0,) + tuple(x.shape),
                                             dtype=x.dtype,
                                             device=x.device))


@register_op("reshape2")
def reshape2(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x.reshape(_reshape_shape(x, ctx.attr("shape"))))
    _xshape(ctx, x)


@register_op("squeeze2")
def squeeze2(ctx):
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if axes:
        axes = [a if a >= 0 else a + x.ndim for a in axes]
    else:
        axes = [i for i, d in enumerate(x.shape) if d == 1]
    shape = [d for i, d in enumerate(x.shape)
             if not (i in axes and d == 1)]
    ctx.set_output("Out", x.reshape(shape))
    _xshape(ctx, x)


@register_op("lookup_table")
def lookup_table(ctx):
    w, ids = ctx.input("W"), ctx.input("Ids")
    padding_idx = ctx.attr("padding_idx", -1)
    ids = ids.long()   # int32 or int64 ids
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)   # fluid's trailing id dim of 1
    out = w.index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx)[..., None], 0)
    ctx.set_output("Out", out)
