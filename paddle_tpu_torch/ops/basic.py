"""Tensor ops: fill_constant, sum, scale, reshape2, squeeze2,
lookup_table and its dense grad (counterpart of paddle_tpu/ops/basic.py).
The "2"-suffixed ops carry an XShape output, here a zero-size marker
holding the input's shape."""
from __future__ import annotations

import torch

from ..core.registry import (GRAD_SUFFIX, override_grad_lowering,
                             register_no_grad_op, register_op)
from ..core.types import dtype_to_torch


@register_no_grad_op("fill_constant")
def fill_constant(ctx):
    shape = [int(s) for s in ctx.attr("shape", [])]
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype_to_torch(
                                         ctx.attr("dtype", "float32")),
                                     device=ctx.device))


@register_op("sum")
def sum_op(ctx):
    """Elementwise sum of the X inputs, added left to right (gray under
    AMP: bf16 when any input is)."""
    xs = ctx.inputs("X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output("Out", out)


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


def _ids(ids):
    ids = ids.long()   # int32 or int64 ids
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)   # fluid's trailing id dim of 1
    return ids


@register_op("lookup_table", no_grad_slots=("Ids",))
def lookup_table(ctx):
    w, ids = ctx.input("W"), ctx.input("Ids")
    padding_idx = ctx.attr("padding_idx", -1)
    ids = _ids(ids)
    out = w.index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(w.shape[1:]))
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx)[..., None], 0)
    ctx.set_output("Out", out)


@override_grad_lowering("lookup_table")
def lookup_table_grad(ctx):
    """Dense W@GRAD: the output cotangent's rows added into a zero table
    at their ids (index_add_), in W's dtype; rows looked up at
    padding_idx add nothing, as the forward zeroed them. The JAX package
    takes the generic vjp of its gather here, which is the same
    scatter-add. Duplicate ids add in an order that atomics leave open
    on the card, so the last bits of such rows may differ run to run.
    The sparse (SelectedRows) branch is not ported."""
    if ctx.attr("is_sparse", False):
        raise NotImplementedError(
            "lookup_table is_sparse=True (SelectedRows gradient) is not "
            "ported")
    out_names = ctx.op.output("W" + GRAD_SUFFIX)
    if not (out_names and out_names[0]):
        return
    w = ctx.env[ctx.op.input("W")[0]]
    ids = _ids(ctx.env[ctx.op.input("Ids")[0]]).reshape(-1)
    g_names = ctx.op.input("Out" + GRAD_SUFFIX)
    g = ctx.env.get(g_names[0]) if g_names and g_names[0] else None
    dw = torch.zeros_like(w)
    if g is not None:
        g = g.reshape(ids.shape[0], -1).to(w.dtype)
        padding_idx = ctx.attr("padding_idx", -1)
        if padding_idx is not None and padding_idx >= 0:
            g = g.masked_fill((ids == padding_idx)[:, None], 0)
        dw.index_add_(0, ids, g)
    ctx.env[out_names[0]] = dw
