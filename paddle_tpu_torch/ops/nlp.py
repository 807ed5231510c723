"""Structured NLP ops: the linear-chain CRF and its Viterbi decoding
(counterpart of paddle_tpu/ops/nlp.py's linear_chain_crf and
crf_decoding).

The Transition parameter is [n+2, n]: row 0 the start scores, row 1 the
stop scores, rows 2.. the [n, n] tag-to-tag scores. Both ops pad the
packed [sum, n] emissions of a LoD batch into [B, T, n] by an index
table made from the offsets (ExecContext.host_table: once a plan, so a
captured block copies nothing), run the dynamic program as a torch loop
over the T padded steps, each step masked past each sequence's length
as the JAX op's lax.scan masks it, and write per-sequence results.
linear_chain_crf's gradient is the generic one: autograd through the
loop of logsumexp.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_no_grad_op, register_op


def _last_level(lod):
    return lod[-1] if lod else None


def _offsets(ctx, rows):
    off = _last_level(ctx.get_lod("Emission"))
    return [int(v) for v in off] if off is not None else [0, int(rows)]


def _pad_index(off, rows):
    """[B, T] rows of the packed input by (sequence, step); `rows` (one
    past the last) where a step lies past its sequence's end."""
    lens = [off[i + 1] - off[i] for i in range(len(off) - 1)]
    T = max(lens)
    return np.asarray([[off[i] + t if t < n else rows for t in range(T)]
                       for i, n in enumerate(lens)], np.int64)


def _pad_seqs(ctx, x, off):
    """Packed [sum, ...] + offsets -> padded [B, T, ...] (zeros past
    each length), as the JAX _pad_seqs fills."""
    rows = int(x.shape[0])
    idx = ctx.host_table("crf_pad", (tuple(off), rows),
                         lambda: _pad_index(off, rows))
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return ext[idx]


def _unpad_rows(ctx, padded, off):
    """Padded [B, T, ...] -> packed [sum, ...] by the offsets."""
    B, T = int(padded.shape[0]), int(padded.shape[1])

    def build():
        return np.asarray([i * T + t for i in range(len(off) - 1)
                           for t in range(off[i + 1] - off[i])], np.int64)
    idx = ctx.host_table("crf_unpad", (tuple(off), T), build)
    return padded.reshape((B * T,) + tuple(padded.shape[2:]))[idx]


def _lengths(ctx, off):
    """(lengths [B] int64, live [B, T] bool: step t < length) on the
    op's device."""
    lens = np.diff(np.asarray(off, np.int64))
    T = int(lens.max())
    key = tuple(off)
    return (ctx.host_table("crf_lens", key, lambda: lens),
            ctx.host_table("crf_live", key,
                           lambda: np.arange(T)[None, :] < lens[:, None]))


@register_op("linear_chain_crf", no_grad_slots=("Label",))
def linear_chain_crf(ctx):
    em = ctx.input("Emission")          # [sum, n] packed
    w = ctx.input("Transition")         # [n+2, n]
    label = ctx.input("Label")          # [sum, 1] int
    off = _offsets(ctx, em.shape[0])
    start, stop, trans = w[0], w[1], w[2:]

    em_p = _pad_seqs(ctx, em, off)                              # [B, T, n]
    lab_p = _pad_seqs(ctx, label.reshape(-1, 1), off)[..., 0].long()
    lens, live = _lengths(ctx, off)
    T = int(em_p.shape[1])

    # log partition: the forward algorithm, frozen past each length
    alpha = start[None] + em_p[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            em_p[:, t]
        alpha = torch.where(live[:, t, None], nxt, alpha)
    logz = torch.logsumexp(alpha + stop[None], dim=1)          # [B]

    # the gold path's score
    em_score = torch.where(
        live, em_p.gather(2, lab_p[..., None])[..., 0],
        em_p.new_zeros(())).sum(1)
    first = lab_p[:, 0]
    last = lab_p.gather(1, (lens - 1)[:, None])[:, 0]
    tr_score = torch.where(live[:, 1:], trans[lab_p[:, :-1], lab_p[:, 1:]],
                           em_p.new_zeros(())).sum(1)
    score = start[first] + em_score + tr_score + stop[last]

    ctx.set_output("LogLikelihood", (logz - score).reshape(-1, 1))
    ctx.set_output("EmissionExps", torch.exp(em))
    ctx.set_output("TransitionExps", torch.exp(w))
    ctx.set_output("Alpha", torch.zeros_like(em))


@register_no_grad_op("crf_decoding")
def crf_decoding(ctx):
    """Viterbi: the best tag path of each sequence, packed [sum, 1]
    int32 with the emission's LoD; with Label, 1 where the path's tag
    equals the label's, else 0."""
    em = ctx.input("Emission")
    w = ctx.input("Transition")
    off = _offsets(ctx, em.shape[0])
    start, stop, trans = w[0], w[1], w[2:]
    em_p = _pad_seqs(ctx, em, off)
    _, live = _lengths(ctx, off)
    B, T, n = (int(d) for d in em_p.shape)
    stay = torch.arange(n, device=em.device)[None].expand(B, n)

    # the delta recursion, keeping back-pointers (a step past a length
    # keeps its delta and points each tag at itself)
    delta = start[None] + em_p[:, 0]
    ptrs = []
    for t in range(1, T):
        scores = delta[:, :, None] + trans[None]               # [B, n, n]
        best, ptr = scores.max(dim=1)
        live_t = live[:, t, None]
        delta = torch.where(live_t, best + em_p[:, t], delta)
        ptrs.append(torch.where(live_t, ptr, stay))
    tag = torch.argmax(delta + stop[None], dim=1)              # [B]

    # back along the pointers: the tag at each step, last step first
    path = [tag]
    for p_t in reversed(ptrs):
        tag = p_t.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                      # [B, T]
    packed = _unpad_rows(ctx, path[..., None], off).to(torch.int32)

    if ctx.has_input("Label"):
        label = ctx.input("Label").reshape(-1, 1).to(torch.int32)
        packed = (packed == label).to(torch.int32)
    ctx.set_output("ViterbiPath", packed)
    ctx.set_lod(ctx.op.output("ViterbiPath")[0], [list(off)])
