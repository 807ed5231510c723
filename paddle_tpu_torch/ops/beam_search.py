"""beam_search / beam_search_decode, the seq2seq decoding ops
(counterpart of paddle_tpu/ops/beam_search.py, whose design this
follows rather than the original Fluid op's).

Every source keeps exactly `beam_size` rows throughout: a finished beam
(its last id is end_id) is frozen, not pruned. It carries one candidate,
(end_id, its unchanged score), and -1e9 (the JAX op's _NEG_INF) for the
others, so it selects itself again. Shapes then never depend on values,
and a decode program of statically unrolled steps is captured as one
CUDA graph a source LoD. beam_search_decode backtracks the stacked
parent pointers with a loop over the steps.

Grouping: rows are contiguous per source. The source count comes from
pre_ids' LoD (its first level) when it has one, else every row is its
own source (the layout of step 0).
"""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op

_NEG_INF = -1e9


@register_no_grad_op("beam_search")
def beam_search(ctx):
    pre_ids = ctx.input("pre_ids")
    pre_scores = ctx.input("pre_scores")
    ids = ctx.input("ids")
    scores = ctx.input("scores")
    K = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    is_accumulated = bool(ctx.attr("is_accumulated", True))

    rows, n_cand = int(scores.shape[0]), int(scores.shape[1])
    lod = ctx.get_lod("pre_ids")
    if lod:
        B = len(lod[0]) - 1
        Kg = rows // B      # the group width (the beam layout is static)
    else:
        B, Kg = rows, 1

    pids = pre_ids.reshape(rows)
    pscores = pre_scores.reshape(rows, 1).float()
    cand_ids = ids.reshape(rows, n_cand).to(torch.int32)
    cand_sc = scores.reshape(rows, n_cand).float()
    if not is_accumulated:
        # the candidates are probabilities: accumulate in log space
        cand_sc = torch.log(cand_sc.clamp_min(1e-30)) + pscores

    # a frozen beam: candidate 0 re-emits (end_id, pre_score), the rest
    # never win a slot
    finished = (pids == end_id)[:, None]
    first = torch.arange(n_cand, device=scores.device) == 0
    frozen = torch.where(first, pscores, torch.full_like(pscores,
                                                         _NEG_INF))
    cand_sc = torch.where(finished, frozen, cand_sc)
    cand_ids = torch.where(finished, torch.full_like(cand_ids, end_id),
                           cand_ids)

    # the top K of each source's Kg x n_cand candidates; among equal
    # scores the lower position first, as lax.top_k orders them
    flat_sc = cand_sc.reshape(B, Kg * n_cand)
    order = torch.sort(flat_sc, dim=1, descending=True, stable=True)[1]
    top_pos = order[:, :K]
    top_sc = flat_sc.gather(1, top_pos)
    sel_ids = cand_ids.reshape(B, Kg * n_cand).gather(1, top_pos)
    # the parent row: a global index into the pre rows
    parent = top_pos // n_cand + \
        (torch.arange(B, device=scores.device) * Kg)[:, None]

    ctx.set_output("selected_ids",
                   sel_ids.reshape(B * K, 1).to(pre_ids.dtype))
    ctx.set_output("selected_scores", top_sc.reshape(B * K, 1))
    if ctx.has_output("parent_idx"):
        ctx.set_output("parent_idx", parent.reshape(B * K).to(torch.int32))
    group_off = [i * K for i in range(B + 1)]
    ctx.set_lod(ctx.op.output("selected_ids")[0], [group_off])
    ctx.set_lod(ctx.op.output("selected_scores")[0], [group_off])


@register_no_grad_op("beam_search_decode")
def beam_search_decode(ctx):
    """Backtrack the stacked step selections into whole hypotheses.

    Inputs Ids / Scores / ParentIdx, each [T, B*K(, 1)] (the steps'
    outputs stacked). Outputs SentenceIds [B*K, T] int32, every position
    after a hypothesis's first end_id set to end_id (the static-shape
    stand-in for the reference's 2-level LoD sentences), and
    SentenceScores [B*K, 1], the last step's scores."""
    ids = ctx.input("Ids")
    scores = ctx.input("Scores")
    parents = ctx.input("ParentIdx")
    end_id = int(ctx.attr("end_id"))
    if ids.ndim == 3:
        ids = ids[..., 0]
    if scores.ndim == 3:
        scores = scores[..., 0]
    T, n = int(ids.shape[0]), int(ids.shape[1])
    ids = ids.to(torch.int32)
    parents = parents.reshape(T, n).long()

    ptr = torch.arange(n, device=ids.device)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(ids[t][ptr])
        ptr = parents[t][ptr]
    sent = torch.stack(toks[::-1], dim=1)                     # [n, T]
    ended = (sent == end_id).to(torch.int32).cumsum(1) > 0
    ended_before = torch.cat([torch.zeros_like(ended[:, :1]),
                              ended[:, :-1]], dim=1)
    sent = torch.where(ended_before, torch.full_like(sent, end_id), sent)
    ctx.set_output("SentenceIds", sent)
    ctx.set_output("SentenceScores",
                   scores[-1].reshape(n, 1).to(torch.float32))
