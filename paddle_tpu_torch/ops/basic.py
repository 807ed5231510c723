"""Tensor ops: fill_constant, fill_constant_batch_size_like,
fill_zeros_like, assign, assign_value, increment, is_empty, sum, cast,
scale, reshape2, squeeze2, unsqueeze, unsqueeze2, flatten, flatten2,
concat, stack, gather, top_k, lookup_table with its dense and
SelectedRows grads, merge_selected_rows and
get_tensor_from_selected_rows (counterpart of paddle_tpu/ops/basic.py).
The "2"-suffixed ops carry an XShape output, here a zero-size marker
holding the input's shape. sum and scale take SelectedRows too
(core/selected_rows.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import (GRAD_SUFFIX, override_grad_lowering,
                             register_no_grad_op, register_op)
from ..core.selected_rows import (SelectedRows, is_selected_rows,
                                  maybe_to_dense)
from ..core.types import dtype_to_torch


@register_no_grad_op("fill_constant")
def fill_constant(ctx):
    shape = [int(s) for s in ctx.attr("shape", [])]
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype_to_torch(
                                         ctx.attr("dtype", "float32")),
                                     device=ctx.device))


@register_no_grad_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx):
    """A fill of `shape` whose dim output_dim_idx is Input's dim
    input_dim_idx."""
    shape = [int(s) for s in ctx.attr("shape", [])]
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.input("Input").shape[ctx.attr("input_dim_idx", 0)]
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype_to_torch(
                                         ctx.attr("dtype", "float32")),
                                     device=ctx.device))


@register_no_grad_op("fill_zeros_like")
def fill_zeros_like(ctx):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


@register_op("assign")
def assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_no_grad_op("assign_value")
def assign_value(ctx):
    """The values of the op's attrs (int32_values, int64_values or
    fp32_values by dtype) in `shape`: a host constant, made once a plan
    (ExecContext.host_table) so a captured block copies nothing."""
    shape = [int(s) for s in ctx.attr("shape", [])]
    dt = dtype_to_torch(ctx.attr("dtype", "float32"))
    slot = {torch.int32: "int32_values", torch.int64: "int64_values"}.get(
        dt, "fp32_values")
    vals = tuple(ctx.attr(slot, []))
    npdt = {torch.int32: np.int32, torch.int64: np.int64}.get(dt,
                                                             np.float32)
    ctx.set_output("Out", ctx.host_table(
        "assign_value", (vals, tuple(shape), slot),
        lambda: np.asarray(vals, npdt).reshape(shape)).to(dt))


@register_no_grad_op("increment")
def increment(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", (x + ctx.attr("step", 1.0)).to(x.dtype))


@register_no_grad_op("is_empty")
def is_empty(ctx):
    """[1] bool: whether X has no element (its shape, not its values)."""
    x = ctx.input("X")
    ctx.set_output("Out", torch.full((1,), x.numel() == 0,
                                     dtype=torch.bool, device=ctx.device))


@register_op("sum")
def sum_op(ctx):
    """Elementwise sum of the X inputs, added left to right (gray under
    AMP: bf16 when any input is). SelectedRows inputs, all of them,
    give their rows and values concatenated (the optimizer merges the
    duplicates); mixed with dense inputs they are made dense."""
    xs = ctx.inputs("X")
    if any(is_selected_rows(x) for x in xs):
        if all(is_selected_rows(x) for x in xs):
            ctx.set_output("Out", SelectedRows(
                torch.cat([x.rows for x in xs]),
                torch.cat([x.values for x in xs]), xs[0].height))
            return
        xs = [maybe_to_dense(x) for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output("Out", out)


@register_op("cast")
def cast(ctx):
    """X converted to `out_dtype`."""
    ctx.set_output("Out", ctx.input("X").to(
        dtype_to_torch(ctx.attr("out_dtype"))))


@register_op("scale")
def scale(ctx):
    x = ctx.input("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    if is_selected_rows(x):
        # a bias on the rows that are absent would make it dense
        if b != 0.0:
            raise ValueError("scale with a bias is not defined for a "
                             "SelectedRows input")
        ctx.set_output("Out", x.map_values(lambda v: (v * s).to(v.dtype)))
        return
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


@register_op("unsqueeze")
def unsqueeze(ctx):
    """X with a dim of 1 inserted at each of `axes`, in ascending
    order, as the JAX lowering expands them."""
    out = ctx.input("X")
    for a in sorted(ctx.attr("axes")):
        out = out.unsqueeze(a)
    ctx.set_output("Out", out)


@register_op("unsqueeze2")
def unsqueeze2(ctx):
    unsqueeze(ctx)
    _xshape(ctx, ctx.input("X"))


@register_op("flatten")
def flatten(ctx):
    """X as a matrix: the dims before `axis` make the rows."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 1)
    lead = 1
    for d in x.shape[:axis]:
        lead *= d
    ctx.set_output("Out", x.reshape(lead, -1))


@register_op("flatten2")
def flatten2(ctx):
    flatten(ctx)
    _xshape(ctx, ctx.input("X"))


@register_op("concat")
def concat(ctx):
    ctx.set_output("Out", torch.cat(ctx.inputs("X"),
                                    dim=ctx.attr("axis", 0)))


@register_op("stack")
def stack(ctx):
    ctx.set_output("Y", torch.stack(ctx.inputs("X"),
                                    dim=ctx.attr("axis", 0)))


@register_op("gather", no_grad_slots=("Index",))
def gather(ctx):
    """Rows of X by Index along axis 0: Index's shape then X's trailing
    dims (jnp.take's), the index read as int32 as the JAX op casts it."""
    x, idx = ctx.input("X"), ctx.input("Index").to(torch.int32)
    out = x.index_select(0, idx.reshape(-1).long())
    ctx.set_output("Out", out.reshape(tuple(idx.shape) + tuple(x.shape[1:])))


@register_no_grad_op("top_k")
def top_k(ctx):
    """The k largest values of the last axis, in descending order, and
    their int64 indices. No gradient: the JAX op has one, but no program
    of the port differentiates through top_k (accuracy reads it)."""
    vals, idx = torch.topk(ctx.input("X"), int(ctx.attr("k", 1)), dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx.long())


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
    """W@GRAD in W's dtype. Dense: the output cotangent's rows added into
    a zero table at their ids (index_add_); rows looked up at
    padding_idx add nothing, as the forward zeroed them. The JAX package
    takes the generic vjp of its gather here, which is the same
    scatter-add. Duplicate ids add in an order that atomics leave open
    on the card, so the last bits of such rows may differ run to run.
    is_sparse=True: a SelectedRows whose rows are the looked-up ids and
    whose values are the cotangent's slices, each padding_idx slot
    parked at the table's height; the dense table is never built. A
    missing cotangent gives the dense zero table in both modes, as in
    the JAX package."""
    out_names = ctx.op.output("W" + GRAD_SUFFIX)
    if not (out_names and out_names[0]):
        return
    w = ctx.env[ctx.op.input("W")[0]]
    ids = _ids(ctx.env[ctx.op.input("Ids")[0]]).reshape(-1)
    g_names = ctx.op.input("Out" + GRAD_SUFFIX)
    g = ctx.env.get(g_names[0]) if g_names and g_names[0] else None
    padding_idx = ctx.attr("padding_idx", -1)
    padded = padding_idx is not None and padding_idx >= 0
    if g is not None and ctx.attr("is_sparse", False):
        values = g.reshape((ids.shape[0],) + tuple(w.shape[1:])).to(w.dtype)
        rows = ids.masked_fill(ids == padding_idx, w.shape[0]) if padded \
            else ids
        ctx.env[out_names[0]] = SelectedRows(rows, values, w.shape[0])
        return
    dw = torch.zeros_like(w)
    if g is not None:
        g = g.reshape(ids.shape[0], -1).to(w.dtype)
        if padded:
            g = g.masked_fill((ids == padding_idx)[:, None], 0)
        dw.index_add_(0, ids, g)
    ctx.env[out_names[0]] = dw


@register_no_grad_op("merge_selected_rows")
def merge_selected_rows(ctx):
    """Duplicate rows summed into one slot each (core/selected_rows.py
    merge_rows)."""
    x = ctx.input("X")
    if not is_selected_rows(x):
        raise TypeError("merge_selected_rows needs a SelectedRows input")
    ctx.set_output("Out", x.merged())


@register_no_grad_op("get_tensor_from_selected_rows")
def get_tensor_from_selected_rows(ctx):
    """The values tensor of a SelectedRows."""
    x = ctx.input("X")
    if not is_selected_rows(x):
        raise TypeError("get_tensor_from_selected_rows needs a "
                        "SelectedRows input")
    ctx.set_output("Out", x.values)
