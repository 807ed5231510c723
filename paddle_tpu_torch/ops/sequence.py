"""Sequence (LoD) ops over packed rows (counterpart of
paddle_tpu/ops/sequence.py).

A LoD batch is the rows of all its sequences stacked, [total rows, ...],
with host-side offsets (core/scope.py LoDTensor). As in the JAX package,
the offsets are static for an engine plan (they are in its feed
signature), so every op here whose output shape the LoD fixes lowers to
gathers by index tables built from the offsets, masks and dense
reductions: no shape depends on a value, and a captured CUDA graph
replays the step. The index tables are made through
ExecContext.host_table: once a plan, before any capture, and kept by the
plan, so that no run after the first copies one to the card.

The reductions over a sequence (sequence_pool's AVERAGE, SUM, SQRT and
MAX, sequence_softmax) gather the rows into a padded [sequences, longest,
...] block, mask the padding and reduce over time: the same bits every
run (no atomic adds), and MAX's gradient split evenly between tied
maxima, as torch.amax and JAX's segment_max both split it.

Three ops read values on the host, because their output's rows depend
on them: sequence_erase (the tokens found), sequence_slice (its Offset
and Length tensors) and edit_distance (a dynamic program over the ids).
They cannot run on the meta device, so the engine's capture rule keeps
a block that holds one eager, and names the op in Engine.eager_reasons.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_no_grad_op, register_op
from ..core.types import dtype_to_torch


# ---------------------------------------------------------------------------
# host-side offsets and the index tables made from them
# ---------------------------------------------------------------------------

def _last_level(lod) -> List[int]:
    if not lod:
        raise ValueError("sequence op requires a LoD: feed a LoDTensor "
                         "(create_lod_tensor) for this input")
    return [int(v) for v in lod[-1]]


def _lengths(offsets: Sequence[int]) -> np.ndarray:
    off = np.asarray(offsets, np.int64)
    return off[1:] - off[:-1]


def _segment_ids(offsets) -> np.ndarray:
    lens = _lengths(offsets)
    return np.repeat(np.arange(len(lens)), lens)


def _pad_gather(off, rows, maxT) -> np.ndarray:
    """[N, maxT] row indices: row j of sequence i at off[i] + j, the
    padding clamped to the sequence's last row (and into [0, rows))."""
    off = np.asarray(off, np.int64)
    lens = _lengths(off)
    j = np.arange(maxT)
    g = off[:-1, None] + np.minimum(j[None, :],
                                    np.maximum(lens[:, None] - 1, 0))
    return np.clip(g, 0, max(rows - 1, 0))


def _pad_mask(off, maxT) -> np.ndarray:
    return np.arange(maxT)[None, :] < _lengths(off)[:, None]


def _unpack(off, maxT) -> np.ndarray:
    """[rows] indices into a flattened [N, maxT] block of each packed
    row."""
    lens = _lengths(off)
    if not len(lens):
        return np.zeros(0, np.int64)
    return np.concatenate([i * maxT + np.arange(n)
                           for i, n in enumerate(lens)]).astype(np.int64)


def _max_len(off) -> int:
    lens = _lengths(off)
    return int(lens.max()) if len(lens) else 0


def _padded(ctx, x, off):
    """(x gathered to [N, maxT, ...], mask [N, maxT, 1, ...]): the packed
    rows of each sequence, padded to the longest."""
    key = tuple(off)
    n, maxT, rows = len(off) - 1, _max_len(off), x.shape[0]
    mask = ctx.host_table("pad_mask", key, lambda: _pad_mask(off, maxT))
    mask = mask.reshape((n, maxT) + (1,) * (x.dim() - 1))
    if rows == 0:
        return x.new_zeros((n, maxT) + tuple(x.shape[1:])), mask
    gather = ctx.host_table("pad_gather", (key, rows),
                           lambda: _pad_gather(off, rows, maxT).reshape(-1))
    return x[gather].reshape((n, maxT) + tuple(x.shape[1:])), mask


def _lens_column(ctx, off, kind, fn, x):
    """fn(lengths) as float32 [N, 1, ...] in x's dtype."""
    t = ctx.host_table(kind, tuple(off), lambda: fn(
        _lengths(off)).astype(np.float32))
    t = t.reshape((-1,) + (1,) * (x.dim() - 1))
    return t if t.dtype == x.dtype else t.to(x.dtype)


# ---------------------------------------------------------------------------
# pooling / softmax / reverse / reshape
# ---------------------------------------------------------------------------

@register_op("sequence_pool", no_grad_slots=("MaxIndex",))
def sequence_pool(ctx):
    x = ctx.input("X")
    off = _last_level(ctx.get_lod("X"))
    n = len(off) - 1
    ptype = str(ctx.attr("pooltype", "AVERAGE")).upper()
    pad_value = ctx.attr("pad_value", 0.0)
    if ptype in ("AVERAGE", "SUM", "SQRT", "MAX"):
        xp, mask = _padded(ctx, x, off)
        if ptype == "MAX":
            # every sequence empty: no time step to reduce (the rows
            # become pad_value below)
            out = torch.where(mask, xp, float("-inf")).amax(1) \
                if xp.shape[1] else xp.new_zeros((n,) + tuple(x.shape[1:]))
            ctx.set_output("MaxIndex", torch.zeros(
                (n,) + tuple(x.shape[1:]), dtype=torch.int32,
                device=x.device))
        else:
            out = torch.where(mask, xp, 0.0).sum(1)
            if ptype == "AVERAGE":
                out = out / _lens_column(
                    ctx, off, "pool_avg", lambda n: np.maximum(n, 1), x)
            elif ptype == "SQRT":
                out = out / _lens_column(
                    ctx, off, "pool_sqrt",
                    lambda n: np.sqrt(np.maximum(n, 1)), x)
    elif ptype in ("LAST", "FIRST"):
        rows = x.shape[0]
        if rows == 0:
            out = x.new_zeros((n,) + tuple(x.shape[1:]))
        else:
            a = np.asarray(off, np.int64)
            pick = a[1:] - 1 if ptype == "LAST" else a[:-1]
            idx = ctx.host_table("pool_" + ptype.lower(), tuple(off),
                                lambda: np.clip(pick, 0, rows - 1))
            out = x[idx]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    empty = ctx.host_table("pool_empty", tuple(off),
                          lambda: _lengths(off) == 0)
    empty = empty.reshape((-1,) + (1,) * (x.dim() - 1))
    out = torch.where(empty, float(pad_value), out)
    ctx.set_output("Out", out)
    ctx.set_lod("Out", [])


@register_op("sequence_softmax")
def sequence_softmax(ctx):
    x = ctx.input("X")
    off = _last_level(ctx.get_lod("X"))
    flat = x.reshape(-1)
    xp, mask = _padded(ctx, flat, off)
    sm = torch.softmax(torch.where(mask, xp, torch.finfo(x.dtype).min),
                       dim=1)
    idx = ctx.host_table("unpack", tuple(off),
                        lambda: _unpack(off, _max_len(off)))
    ctx.set_output("Out", sm.reshape(-1)[idx].reshape(x.shape))
    ctx.set_lod("Out", ctx.get_lod("X"))


@register_op("sequence_reverse")
def sequence_reverse(ctx):
    x = ctx.input("X")
    off = _last_level(ctx.get_lod("X"))

    def build():
        a = np.asarray(off, np.int64)
        return np.concatenate([np.arange(s, e)[::-1]
                               for s, e in zip(a[:-1], a[1:])]) \
            if len(a) > 1 else np.arange(0)

    ctx.set_output("Y", x[ctx.host_table("reverse", tuple(off), build)])
    ctx.set_lod("Y", ctx.get_lod("X"))


@register_op("sequence_reshape")
def sequence_reshape(ctx):
    x = ctx.input("X")
    new_dim = int(ctx.attr("new_dim"))
    off = np.asarray(_last_level(ctx.get_lod("X")), np.int64)
    old_dim = x.shape[-1]
    ctx.set_output("Out", x.reshape(-1, new_dim))
    ctx.set_lod("Out", [list(map(int, off * old_dim // new_dim))])


# ---------------------------------------------------------------------------
# expand / concat
# ---------------------------------------------------------------------------

@register_op("sequence_expand", no_grad_slots=("Y",))
def sequence_expand(ctx):
    x = ctx.input("X")
    x_lod = ctx.get_lod("X")
    y_lod = ctx.get_lod("Y")
    ref_level = int(ctx.attr("ref_level", -1))
    if not y_lod:
        raise ValueError("sequence_expand needs Y lod")
    ref = y_lod[ref_level if ref_level >= 0 else len(y_lod) - 1]
    rep = _lengths(ref)
    if x_lod:
        x_off = np.asarray(_last_level(x_lod), np.int64)
        idx, out_off = [], [0]
        for i, r in enumerate(rep):
            seq = np.arange(x_off[i], x_off[i + 1])
            for _ in range(int(r)):
                idx.append(seq)
                out_off.append(out_off[-1] + len(seq))
        idx = np.concatenate(idx) if idx else np.arange(0)
        key = (tuple(x_off), tuple(ref))
        ctx.set_output("Out", x[ctx.host_table("expand", key, lambda: idx)])
        ctx.set_lod("Out", [list(map(int, out_off))])
    else:
        ctx.set_output("Out", x[ctx.host_table(
            "expand_rows", (x.shape[0], tuple(ref)),
            lambda: np.repeat(np.arange(x.shape[0]), rep))])
        ctx.set_lod("Out", [])


@register_op("sequence_expand_as", no_grad_slots=("Y",))
def sequence_expand_as(ctx):
    x = ctx.input("X")
    y_off = _last_level(ctx.get_lod("Y"))
    rep = _lengths(y_off)
    if x.shape[0] != len(rep):
        raise ValueError(f"sequence_expand_as: X has {x.shape[0]} rows for "
                         f"{len(rep)} sequences of Y")
    idx = ctx.host_table("expand_rows", (x.shape[0], tuple(y_off)),
                        lambda: np.repeat(np.arange(x.shape[0]), rep))
    ctx.set_output("Out", x[idx])
    ctx.set_lod("Out", [list(map(int, y_off))])


@register_op("sequence_concat")
def sequence_concat(ctx):
    xs = ctx.inputs("X")
    lods = [tuple(_last_level(ctx.get_lod(n))) for n in ctx.op.input("X")]
    n_seq = len(lods[0]) - 1
    bases = np.cumsum([0] + [x.shape[0] for x in xs[:-1]])
    idx, out_off = [], [0]
    for i in range(n_seq):
        total = 0
        for off, b in zip(lods, bases):
            idx.append(np.arange(off[i], off[i + 1]) + b)
            total += int(off[i + 1] - off[i])
        out_off.append(out_off[-1] + total)
    idx = np.concatenate(idx) if idx else np.arange(0)
    key = (tuple(lods), tuple(int(b) for b in bases))
    ctx.set_output("Out", torch.cat(xs, 0)[ctx.host_table("concat", key,
                                                         lambda: idx)])
    ctx.set_lod("Out", [list(map(int, out_off))])


# ---------------------------------------------------------------------------
# pad / unpad / mask
# ---------------------------------------------------------------------------

@register_op("sequence_pad", no_grad_slots=("PadValue", "Length"))
def sequence_pad(ctx):
    x = ctx.input("X")
    pad_value = ctx.input("PadValue")
    off = _last_level(ctx.get_lod("X"))
    lens = _lengths(off)
    padded_len = int(ctx.attr("padded_length", -1))
    if padded_len <= 0:
        padded_len = int(lens.max()) if len(lens) else 0
    n, feat = len(lens), tuple(x.shape[1:])
    key, rows = tuple(off), x.shape[0]
    mask = ctx.host_table("seqpad_mask", (key, padded_len),
                         lambda: _pad_mask(off, padded_len))
    mask = mask.reshape((n, padded_len) + (1,) * len(feat))
    if rows == 0:
        out = x.new_zeros((n, padded_len) + feat)
    else:
        gather = ctx.host_table(
            "seqpad_gather", (key, rows, padded_len),
            lambda: _pad_gather(off, rows, padded_len).reshape(-1))
        out = x[gather].reshape((n, padded_len) + feat)
    pv = pad_value.to(x.dtype).reshape((1, 1) + (1,) * len(feat))
    ctx.set_output("Out", torch.where(mask, out, pv))
    ctx.set_output("Length", ctx.host_table(
        "lengths", key, lambda: lens.astype(np.int64)).clone())
    # host metadata so sequence_unpad can invert statically
    ctx.set_lod(ctx.op.output("Out")[0], [])
    if ctx.op.output("Length"):
        ctx.set_lod(ctx.op.output("Length")[0], [list(off)])


@register_op("sequence_unpad", no_grad_slots=("Length",))
def sequence_unpad(ctx):
    x = ctx.input("X")
    lod = ctx.get_lod("Length") or ctx.get_lod("X")
    if not lod:
        raise NotImplementedError(
            "sequence_unpad needs the LoD of its Length (sequence_pad's "
            "output): lengths read from values are not ported")
    off = _last_level(lod)
    padded_len = x.shape[1]
    idx = ctx.host_table("unpack", (tuple(off), padded_len),
                        lambda: _unpack(off, padded_len))
    ctx.set_output("Out", x.reshape((-1,) + tuple(x.shape[2:]))[idx])
    ctx.set_lod("Out", [list(off)])


@register_no_grad_op("sequence_mask")
def sequence_mask(ctx):
    """maxlen <= 0 takes the largest length, read from the card: a host
    read, which keeps the block eager (the capture rule)."""
    x = ctx.input("X")
    maxlen = int(ctx.attr("maxlen", -1))
    if maxlen <= 0:
        maxlen = int(x.max()) if x.numel() else 0
    dt = dtype_to_torch(ctx.attr("out_dtype", "int64"))
    rng = torch.arange(maxlen, device=x.device)
    out = (rng[None, :] < x.reshape(-1, 1)).to(dt)
    ctx.set_output("Y", out.reshape(tuple(x.shape) + (maxlen,)))


# ---------------------------------------------------------------------------
# conv / enumerate / im2sequence / scatter
# ---------------------------------------------------------------------------

def _window(off, rows, start, length):
    """(sources [rows, length], valid [rows, length]): row r's window
    rows r + start + c for c < length, valid where inside r's
    sequence."""
    off = np.asarray(off, np.int64)
    lens = _lengths(off)
    starts = np.repeat(off[:-1], lens)[:, None]
    ends = np.repeat(off[1:], lens)[:, None]
    src = np.arange(rows)[:, None] + start + np.arange(length)[None, :]
    ok = (src >= starts) & (src < ends)
    return np.clip(src, 0, max(rows - 1, 0)), ok


@register_op("sequence_conv", no_grad_slots=("PaddingData",))
def sequence_conv(ctx):
    x = ctx.input("X")
    filt = ctx.input("Filter")
    ctx_len = int(ctx.attr("contextLength"))
    ctx_start = int(ctx.attr("contextStart", -ctx_len // 2))
    if int(ctx.attr("contextStride", 1)) != 1:
        raise ValueError("sequence_conv: contextStride must be 1, as in "
                         "the reference")
    off = _last_level(ctx.get_lod("X"))
    T, D = x.shape
    key = (tuple(off), ctx_start, ctx_len)
    src = ctx.host_table("conv_src", key, lambda: _window(
        off, T, ctx_start, ctx_len)[0].reshape(-1))
    ok = ctx.host_table("conv_ok", key, lambda: _window(
        off, T, ctx_start, ctx_len)[1][:, :, None])
    col = torch.where(ok, x[src].reshape(T, ctx_len, D), 0.0)
    ctx.set_output("Out", col.reshape(T, ctx_len * D) @ filt)
    ctx.set_lod("Out", ctx.get_lod("X"))


@register_no_grad_op("sequence_enumerate")
def sequence_enumerate(ctx):
    x = ctx.input("X")
    win = int(ctx.attr("win_size"))
    pad = ctx.attr("pad_value", 0)
    off = _last_level(ctx.get_lod("X"))
    T = x.shape[0]
    key = (tuple(off), win)

    def build(part):
        src, ok = _window(off, T, 0, win)
        return src.reshape(-1) if part == 0 else ok

    src = ctx.host_table("enum_src", key, lambda: build(0))
    ok = ctx.host_table("enum_ok", key, lambda: build(1))
    vals = x.reshape(T)[src].reshape(T, win)
    ctx.set_output("Out", torch.where(ok, vals, pad))
    ctx.set_lod("Out", ctx.get_lod("X"))


@register_op("im2sequence")
def im2sequence(ctx):
    x = ctx.input("X")
    kh, kw = [int(k) for k in ctx.attr("kernels")]
    strides = [int(s) for s in ctx.attr("strides", [1, 1])]
    paddings = [int(p) for p in ctx.attr("paddings", [0, 0, 0, 0])]
    N, C, H, W = x.shape
    ph0, pw0 = paddings[0], paddings[1]
    ph1 = paddings[2] if len(paddings) > 2 else paddings[0]
    pw1 = paddings[3] if len(paddings) > 3 else paddings[1]
    xp = F.pad(x, (pw0, pw1, ph0, ph1))
    oh = (H + ph0 + ph1 - kh) // strides[0] + 1
    ow = (W + pw0 + pw1 - kw) // strides[1] + 1
    # [N, C*kh*kw, oh*ow] (channel-major, as the JAX patches) -> rows
    patches = F.unfold(xp, (kh, kw), stride=tuple(strides))
    ctx.set_output("Out", patches.transpose(1, 2).reshape(N * oh * ow,
                                                          C * kh * kw))
    ctx.set_lod("Out", [[i * oh * ow for i in range(N + 1)]])


@register_op("sequence_scatter", no_grad_slots=("Ids",))
def sequence_scatter(ctx):
    x = ctx.input("X")
    ids = ctx.input("Ids")
    upd = ctx.input("Updates")
    off = _last_level(ctx.get_lod("Ids"))
    # row r of updates goes to x[seq_of(r), ids[r]] += updates[r]
    seg = ctx.host_table("segment_ids", tuple(off),
                        lambda: _segment_ids(off))
    ctx.set_output("Out", x.index_put(
        (seg, ids.reshape(-1).long()), upd.reshape(-1).to(x.dtype),
        accumulate=True))


# ---------------------------------------------------------------------------
# value-dependent: read on the host, the block stays eager
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A tensor's values on the host (a sync; refused on meta)."""
    if t.device.type == "meta":
        raise RuntimeError("a value read on the host: no meta run")
    return t.detach().cpu().numpy()


@register_no_grad_op("sequence_erase")
def sequence_erase(ctx):
    """X's rows without those whose id is in `tokens`; the LoD shrinks
    with them."""
    x = ctx.input("X")
    tokens = [int(t) for t in ctx.attr("tokens", [])]
    off = np.asarray(_last_level(ctx.get_lod("X")), np.int64)
    keep = ~np.isin(_host(x).reshape(-1), tokens)
    out_off = [0]
    for a, b in zip(off[:-1], off[1:]):
        out_off.append(out_off[-1] + int(keep[a:b].sum()))
    idx = torch.from_numpy(np.nonzero(keep)[0]).to(x.device)
    ctx.set_output("Out", x.reshape(-1).index_select(0, idx).reshape(
        (-1,) + tuple(x.shape[1:])))
    ctx.set_lod("Out", [out_off])


@register_op("sequence_slice", no_grad_slots=("Offset", "Length"))
def sequence_slice(ctx):
    """Of each sequence i, Length[i] rows from its row Offset[i]."""
    x = ctx.input("X")
    off = np.asarray(_last_level(ctx.get_lod("X")), np.int64)
    o = _host(ctx.input("Offset")).reshape(-1)
    ln = _host(ctx.input("Length")).reshape(-1)
    idx, out_off = [], [0]
    for i in range(len(off) - 1):
        start = off[i] + int(o[i])
        idx.append(np.arange(start, start + int(ln[i])))
        out_off.append(out_off[-1] + int(ln[i]))
    idx = np.concatenate(idx) if idx else np.arange(0)
    ctx.set_output("Out", x.index_select(
        0, torch.from_numpy(idx.astype(np.int64)).to(x.device)))
    ctx.set_lod("Out", [out_off])


def _levenshtein(a, b) -> float:
    """The edit distance of a to b, one row of the dynamic program a
    token of a: row[j] = min(up + 1, diagonal + (tok != b[j-1]),
    row[j-1] + 1), the last term as a running minimum of base[k] - k
    (plus j), so a row is a few numpy ops."""
    b = np.asarray(b)
    cols = np.arange(len(b) + 1, dtype=np.float32)
    dp = cols.copy()
    for tok in a:
        base = np.empty_like(dp)
        base[0] = dp[0] + 1
        base[1:] = np.minimum(dp[1:] + 1, dp[:-1] + (b != tok))
        dp = np.minimum.accumulate(base - cols) + cols
    return float(dp[-1])


@register_no_grad_op("edit_distance")
def edit_distance(ctx):
    """[N, 1] float32: the Levenshtein distance of each hypothesis
    sequence to its reference (divided by the reference's length with
    `normalized`); SequenceNum [1] int64 = N."""
    h_off = np.asarray(_last_level(ctx.get_lod("Hyps")), np.int64)
    r_off = np.asarray(_last_level(ctx.get_lod("Refs")), np.int64)
    h = _host(ctx.input("Hyps")).reshape(-1)
    r = _host(ctx.input("Refs")).reshape(-1)
    n = len(h_off) - 1
    out = np.zeros((n, 1), np.float32)
    for i in range(n):
        b = r[r_off[i]:r_off[i + 1]]
        d = _levenshtein(h[h_off[i]:h_off[i + 1]], b)
        out[i, 0] = d / max(len(b), 1) if ctx.attr("normalized", False) \
            else d
    ctx.set_output("Out", torch.from_numpy(out).to(ctx.device))
    ctx.set_output("SequenceNum", torch.tensor([n], dtype=torch.int64,
                                               device=ctx.device))
