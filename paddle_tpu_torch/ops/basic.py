"""Tensor ops (counterpart of paddle_tpu/ops/basic.py): creation
(fill_constant, fill_constant_batch_size_like, fill_zeros_like,
fill_any_like, assign_value, range, linspace, eye, diag), copy, cast and
scale (assign, cast, scale, sum, increment, clip, clip_by_norm,
label_smooth), shapes (reshape, reshape2, transpose, transpose2,
squeeze, squeeze2, unsqueeze, unsqueeze2, flatten, flatten2, concat,
split, stack, unstack, expand, slice, strided_slice, reverse, pad,
pad2d, crop), indexing (gather, gather_nd, scatter, lookup_table with
its dense and SelectedRows grads, one_hot, multiplex, where_op_select,
shard_index, hash), search (top_k, argsort, arg_max, arg_min, cumsum),
tests (is_empty, isfinite, shape, size), the SelectedRows ops
(merge_selected_rows, get_tensor_from_selected_rows) and `where`, the
indices of the true elements.

The "2"-suffixed ops carry an XShape output, here a zero-size marker
holding the input's shape. sum and scale take SelectedRows too
(core/selected_rows.py). range, linspace and where read values on the
host (their output's shape depends on them): a block holding one runs
eagerly (the engine's capture rule). Integer results keep the
reference's widths (arg_max, arg_min, argsort, size, one_hot's input:
int64; shape: int32), where the JAX package without 64-bit types writes
int32."""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import (GRAD_SUFFIX, override_grad_lowering,
                             register_no_grad_op, register_op)
from ..core.selected_rows import (SelectedRows, is_selected_rows,
                                  maybe_to_dense)
from ..core.types import dtype_to_torch
from ..kernels.flash_attention import _M32, _mul32


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


@register_op("reshape")
def reshape(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x.reshape(_reshape_shape(x, ctx.attr("shape"))))


@register_op("squeeze")
def squeeze(ctx):
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if axes:
        axes = [a if a >= 0 else a + x.ndim for a in axes]
    else:
        axes = [i for i, d in enumerate(x.shape) if d == 1]
    shape = [d for i, d in enumerate(x.shape)
             if not (i in axes and d == 1)]
    ctx.set_output("Out", x.reshape(shape))


@register_op("squeeze2")
def squeeze2(ctx):
    squeeze(ctx)
    _xshape(ctx, ctx.input("X"))


@register_op("transpose")
def transpose(ctx):
    ctx.set_output("Out", ctx.input("X").permute(*ctx.attr("axis")))


@register_op("transpose2")
def transpose2(ctx):
    transpose(ctx)
    _xshape(ctx, ctx.input("X"))


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


def _fill_value(dtype):
    """jnp.take's fill for an index out of range: NaN for a float, the
    type's minimum for a signed int, its maximum for an unsigned one,
    True for bool."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _wrap(idx, n):
    """(idx wrapped into [0, n) where it lies in [-n, 0), in range)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


@register_op("gather", no_grad_slots=("Index",))
def gather(ctx):
    """Rows of X by Index along axis 0: Index's shape then X's trailing
    dims, the index read as int32 as the JAX op casts it, by jnp.take's
    rule: an index in [-n, 0) counts from the end, one outside [-n, n)
    gives _fill_value rows (and sends no gradient). No index out of
    range reaches index_select: those rows read row 0, then are
    replaced."""
    x, idx = ctx.input("X"), ctx.input("Index").to(torch.int32)
    flat, ok = _wrap(idx.reshape(-1).long(), x.shape[0])
    out = x.index_select(0, torch.where(ok, flat, 0))
    out = torch.where(ok.reshape((-1,) + (1,) * (x.ndim - 1)), out,
                      out.new_full((), _fill_value(x.dtype)))
    ctx.set_output("Out", out.reshape(tuple(idx.shape) + tuple(x.shape[1:])))


@register_op("top_k", no_grad_slots=("K",))
def top_k(ctx):
    """The k largest values of the last axis, in descending order, and
    their int64 indices; k is the K input where one is given (read on
    the host: a block that holds it is not captured), else the attr.
    The gradient scatters Out's cotangent to Indices along the last
    axis (torch.topk's, the JAX op's lax.top_k vjp)."""
    k = ctx.input("K")
    k = int(k.reshape(-1)[0].item()) if k is not None \
        else int(ctx.attr("k", 1))
    vals, idx = torch.topk(ctx.input("X"), k, dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx.long())
    lod = ctx.get_lod("X")
    if lod:     # the reference's ShareLoD(X, Out) (top_k_op.cc)
        ctx.set_lod("Out", lod)
        ctx.set_lod("Indices", lod)


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


# -- creation ----------------------------------------------------------------

@register_no_grad_op("fill_any_like")
def fill_any_like(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.full_like(x, ctx.attr("value", 0.0)))


@register_no_grad_op("range")
def range_op(ctx):
    """arange(Start, End, Step) in Start's dtype: the three are read on
    the host."""
    s, e, st = ctx.input("Start"), ctx.input("End"), ctx.input("Step")
    ctx.set_output("Out", torch.arange(float(s), float(e), float(st),
                                       dtype=s.dtype, device=ctx.device))


@register_no_grad_op("linspace")
def linspace(ctx):
    """Num float32 points from Start to Stop: read on the host."""
    s, e, n = ctx.input("Start"), ctx.input("Stop"), ctx.input("Num")
    ctx.set_output("Out", torch.linspace(float(s), float(e), int(n),
                                         dtype=torch.float32,
                                         device=ctx.device))


@register_no_grad_op("eye")
def eye(ctx):
    rows = int(ctx.attr("num_rows"))
    cols = ctx.attr("num_columns", None) or rows
    ctx.set_output("Out", torch.eye(rows, int(cols), dtype=dtype_to_torch(
        ctx.attr("dtype", "float32")), device=ctx.device))


@register_no_grad_op("diag")
def diag(ctx):
    ctx.set_output("Out", torch.diag(ctx.input("Diagonal")))


# -- values -----------------------------------------------------------------

@register_op("clip")
def clip(ctx):
    ctx.set_output("Out", torch.clamp(ctx.input("X"), ctx.attr("min"),
                                      ctx.attr("max")))


@register_op("clip_by_norm")
def clip_by_norm(ctx):
    """X scaled by max_norm / ||X|| where its L2 norm exceeds max_norm."""
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt((x * x).sum())
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    ctx.set_output("Out", x * scale)


@register_op("label_smooth")
def label_smooth(ctx):
    """(1 - epsilon) X + epsilon PriorDist, or epsilon / its last dim
    without a prior."""
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 0.0)
    dist = ctx.input("PriorDist")
    if dist is not None:
        out = (1 - eps) * x + eps * dist
    else:
        out = (1 - eps) * x + eps / x.shape[-1]
    ctx.set_output("Out", out)


# -- shapes -----------------------------------------------------------------

@register_op("split")
def split(ctx):
    """X cut along `axis` into `num` equal parts, or into `sections`."""
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    num = ctx.attr("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of {tuple(x.shape)} does "
                             f"not divide into {num}")
        sizes = [x.shape[axis] // num] * num
    else:
        sizes = [int(v) for v in ctx.attr("sections", [])]
    ctx.set_outputs("Out", list(torch.split(x, sizes, dim=axis)))


@register_op("unstack")
def unstack(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    ctx.set_outputs("Y", list(x.unbind(axis)))


@register_op("expand")
def expand(ctx):
    """X tiled `expand_times` times along each dim (np.tile's rule)."""
    x = ctx.input("X")
    times = [int(t) for t in ctx.attr("expand_times")]
    if len(times) < x.ndim:
        times = [1] * (x.ndim - len(times)) + times
    ctx.set_output("Out", x.repeat(*times))


def _clamped(v, dim):
    """A slice bound as fluid's slice takes it: negative counts from the
    end, both clamped into [0, dim]."""
    return max(v + dim, 0) if v < 0 else min(v, dim)


@register_op("slice")
def slice_op(ctx):
    x = ctx.input("Input")
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        dim = x.shape[a]
        idx[a] = slice(_clamped(s, dim), _clamped(e, dim))
    ctx.set_output("Out", x[tuple(idx)])


@register_op("strided_slice")
def strided_slice(ctx):
    """Python slicing start:end:stride on each of `axes`; a negative
    stride walks backwards (an index_select: torch slices take positive
    steps only)."""
    x = ctx.input("Input")
    for a, s, e, st in zip(ctx.attr("axes"), ctx.attr("starts"),
                           ctx.attr("ends"), ctx.attr("strides")):
        start, stop, step = slice(s, e, st).indices(x.shape[a])
        if step > 0:
            idx = [slice(None)] * x.ndim
            idx[a] = slice(start, stop, step)
            x = x[tuple(idx)]
        else:
            x = x.index_select(a, torch.arange(start, stop, step,
                                               device=x.device))
    ctx.set_output("Out", x)


@register_op("reverse")
def reverse(ctx):
    out = ctx.input("X")
    for a in ctx.attr("axis"):
        out = torch.flip(out, dims=[a])
    ctx.set_output("Out", out)


def _torch_pads(cfg):
    """[(before, after)] per dim, first dim first -> F.pad's list, last
    dim first."""
    return [v for before, after in reversed(cfg) for v in (before, after)]


@register_op("pad")
def pad(ctx):
    x = ctx.input("X")
    p = ctx.attr("paddings")
    cfg = [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    ctx.set_output("Out", torch.nn.functional.pad(
        x, _torch_pads(cfg), value=ctx.attr("pad_value", 0.0)))


@register_op("pad2d")
def pad2d(ctx):
    """NCHW X padded [top, bottom, left, right]: constant, reflect or
    edge."""
    x = ctx.input("X")
    p = ctx.attr("paddings")
    pads = [p[2], p[3], p[0], p[1]]
    mode = ctx.attr("mode", "constant")
    if mode == "constant":
        out = torch.nn.functional.pad(x, pads,
                                      value=ctx.attr("pad_value", 0.0))
    else:
        out = torch.nn.functional.pad(
            x, pads, mode="reflect" if mode == "reflect" else "replicate")
    ctx.set_output("Out", out)


@register_op("crop")
def crop(ctx):
    x = ctx.input("X")
    idx = tuple(slice(o, o + s) for o, s in zip(ctx.attr("offsets"),
                                                 ctx.attr("shape")))
    ctx.set_output("Out", x[idx])


# -- indexing ---------------------------------------------------------------

@register_op("scatter", no_grad_slots=("Ids",))
def scatter(ctx):
    """X with the rows at Ids replaced by Updates' (overwrite), or set to
    the sum of the Updates rows sent there. As the JAX op's x.at[ids]:
    an id in [-n, 0) counts from the end, an update to an id outside
    [-n, n) is dropped (written to a spare row past the end, then cut
    off)."""
    x, upd = ctx.input("X"), ctx.input("Updates")
    n = x.shape[0]
    ids, ok = _wrap(ctx.input("Ids").reshape(-1).long(), n)
    ids = torch.where(ok, ids, n)
    xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if ctx.attr("overwrite", True):
        out = xp.index_put((ids,), upd)
    else:
        out = xp.index_fill(0, ids, 0).index_add(0, ids, upd)
    ctx.set_output("Out", out[:n])


@register_op("gather_nd", no_grad_slots=("Index",))
def gather_nd(ctx):
    """X at the leading coordinates of Index's last axis, as the JAX
    op's x[tuple(idx)]: a coordinate in [-n, 0) counts from the end, one
    further out is clamped into [0, n) and sends no gradient (the JAX
    gather's vjp drops an update out of range)."""
    x, idx = ctx.input("X"), ctx.input("Index").long()
    coords, ok = [], None
    for i in range(idx.shape[-1]):
        c, fits = _wrap(idx[..., i], x.shape[i])
        ok = fits if ok is None else ok & fits
        coords.append(torch.clamp(c, 0, x.shape[i] - 1))
    out = x[tuple(coords)]
    if ok is not None:
        out = torch.where(ok.reshape(ok.shape + (1,) * (out.ndim - ok.ndim)),
                          out, out.detach())
    ctx.set_output("Out", out)


@register_no_grad_op("one_hot")
def one_hot(ctx):
    """float32 [.., depth] of X's ids (a trailing dim of 1 dropped); an id
    outside [0, depth) gives a row of zeros."""
    ids = ctx.input("X").long()
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    depth = int(ctx.attr("depth"))
    cols = torch.arange(depth, device=ids.device)
    ctx.set_output("Out", (ids[..., None] == cols).to(torch.float32))


@register_op("multiplex", no_grad_slots=("Ids",))
def multiplex(ctx):
    """Row i of X[Ids[i]]."""
    xs = torch.stack(ctx.inputs("X"), dim=0)
    ids = ctx.input("Ids").reshape(-1).long()
    rows = torch.arange(ids.shape[0], device=ids.device)
    ctx.set_output("Out", xs[ids, rows])


@register_op("where_op_select")
def where_select(ctx):
    ctx.set_output("Out", torch.where(ctx.input("Condition"),
                                      ctx.input("X"), ctx.input("Y")))


@register_no_grad_op("where")
def where_index(ctx):
    """int64 [N, rank]: the coordinates of Condition's true elements,
    whose count is read on the host."""
    ctx.set_output("Out", torch.nonzero(ctx.input("Condition")).long())


@register_no_grad_op("shard_index")
def shard_index(ctx):
    x = ctx.input("X")
    shard_size = (ctx.attr("index_num") + ctx.attr("nshards") - 1) // \
        ctx.attr("nshards")
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == \
        ctx.attr("shard_id")
    ctx.set_output("Out", torch.where(
        in_shard, torch.remainder(x, shard_size),
        torch.full_like(x, ctx.attr("ignore_value", -1))))


def _rotl32(h, r):
    return ((h << r) | (h >> (32 - r))) & _M32


@register_no_grad_op("hash")
def hash_op(ctx):
    """Each row of X hashed into `num_hash` bucket ids in [0, mod_by):
    [N, num_hash, 1] int64, X's LoD. The JAX package's murmur3-style
    32-bit mix (its hash is a well-mixed bucketing hash, not the
    reference's XXH64), on uint32 values carried in int64."""
    x = ctx.input("X")
    num_hash = int(ctx.attr("num_hash", 1))
    mod_by = int(ctx.attr("mod_by", 100000))
    n = x.shape[0]
    d = int(np.prod(x.shape[1:])) if x.ndim > 1 else 1
    vals = x.reshape(n, d).long() & _M32
    k = _mul32(vals, 0xCC9E2D51)
    k = _mul32(_rotl32(k, 15), 0x1B873593)
    seeds = torch.arange(num_hash, dtype=torch.int64,
                         device=x.device)[None, :]
    h = ((_mul32(seeds, 0x9E3779B9) + 4 * d) & _M32).expand(n, num_hash)
    for i in range(d):
        h = _rotl32(h ^ k[:, i:i + 1], 13)
        h = (_mul32(h, 5) + 0xE6546B64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    ctx.set_output("Out", (h % mod_by).reshape(n, num_hash, 1))
    lod = ctx.get_lod("X")
    if lod:
        ctx.set_lod("Out", lod)


# -- search -----------------------------------------------------------------

@register_no_grad_op("argsort")
def argsort(ctx):
    """X sorted along `axis`, ascending and stable, with int64
    indices."""
    vals, idx = torch.sort(ctx.input("X"), dim=ctx.attr("axis", -1),
                           stable=True)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx)


@register_no_grad_op("arg_max")
def arg_max(ctx):
    ctx.set_output("Out", torch.argmax(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


@register_no_grad_op("arg_min")
def arg_min(ctx):
    ctx.set_output("Out", torch.argmin(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)))


@register_op("cumsum")
def cumsum(ctx):
    """Running sums along `axis` in X's dtype; `exclusive` leaves each
    element out of its own, `reverse` runs from the end."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    if ctx.attr("reverse", False):
        x = torch.flip(x, dims=[axis])
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if ctx.attr("exclusive", False):
        out = out - x
    if ctx.attr("reverse", False):
        out = torch.flip(out, dims=[axis])
    ctx.set_output("Out", out)


# -- tests ------------------------------------------------------------------

@register_no_grad_op("isfinite")
def isfinite(ctx):
    """[1] bool: whether every element of X is finite."""
    ctx.set_output("Out", torch.isfinite(ctx.input("X")).all().reshape(1))


@register_no_grad_op("shape")
def shape_op(ctx):
    """Input's shape, int32 (the reference's shape op)."""
    shape = tuple(ctx.input("Input").shape)
    ctx.set_output("Out", ctx.host_table(
        "shape", shape, lambda: np.asarray(shape, np.int32)))


@register_no_grad_op("size")
def size_op(ctx):
    """Input's element count, a 0-d int64."""
    n = int(ctx.input("Input").numel())
    ctx.set_output("Out", ctx.host_table(
        "size", n, lambda: np.asarray([n], np.int64)).reshape(()))
