"""SSD's detection ops (counterpart of paddle_tpu/ops/detection.py:
prior_box, iou_similarity, box_coder, bipartite_match, target_assign,
mine_hard_examples, multiclass_nms and detection_map).

Every op but detection_map is shape-static for a LoD, so a block that
holds them is captured as one CUDA graph. The JAX lowerings unroll over
the LoD segments (one image each); these run batched over the images:
each image's rows are padded to the batch's largest count, through index
and mask tensors made from the LoD offsets by ExecContext.host_table
(once a plan: no host copy under capture), and each greedy loop runs once
for the batch, over [N, G_max, M] (bipartite_match) and [N, C-1, K]
(multiclass_nms). The results equal the JAX lowerings', ties included:
argmax takes the first maximum and every sort is stable, as jnp.argsort
of the negated scores is. On the meta device (build-time shape
inference, the engine's capture rule) the loops are skipped: they change
no shape.

detection_map reads its inputs on the host (value-dependent per-class
lists, as the reference registers it for the CPU only), so a block that
holds it stays eager; its evaluator state is a DetectionMAPState, a host
object in a persistable var.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.registry import register_no_grad_op, register_op
from ..core.scope import tensor_to_numpy

__all__ = ["DetectionMAPState"]


def _expand_aspect_ratios(ratios, flip):
    out = [1.0]
    for ar in ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _pairwise_iou(a, b, normalized=True):
    """IoU [..., N, M] of boxes a [..., N, 4] and b [..., M, 4]
    (x1, y1, x2, y2); 0 where the union is not positive."""
    off = 0.0 if normalized else 1.0
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    zero = a.new_zeros(())
    inter = torch.maximum(ix2 - ix1 + off, zero) * \
        torch.maximum(iy2 - iy1 + off, zero)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, zero)


def _segments(lod, n_rows):
    """Level-1 offsets -> [(start, end)]; one segment without a LoD."""
    if lod:
        offs = lod[0]
        return list(zip(offs[:-1], offs[1:]))
    return [(0, n_rows)]


def _padded_rows(ctx, kind, segs):
    """(index [N, R_max] int64, valid [N, R_max] bool) on the op's
    device: row r of image b is segs[b][0] + r where r < its count (row
    0 of the input where it is padding)."""
    r_max = max([e - s for s, e in segs] + [1])
    key = tuple(segs)

    def build():
        idx = np.zeros((len(segs), r_max), np.int64)
        valid = np.zeros((len(segs), r_max), bool)
        for b, (s, e) in enumerate(segs):
            idx[b, :e - s] = np.arange(s, e)
            valid[b, :e - s] = True
        return np.stack([idx, valid.astype(np.int64)])

    both = ctx.host_table(kind, key, build)
    return both[0], both[1].bool()


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------

def _prior_halves(min_sizes, max_sizes, ars, mm_order):
    """Each cell's prior half-extents (w/2, h/2), in the reference's
    order."""
    half = []
    for s, mn in enumerate(min_sizes):
        per_min = [(mn * math.sqrt(ar) / 2.0, mn / math.sqrt(ar) / 2.0)
                   for ar in ars if not (mm_order and abs(ar - 1.0) < 1e-6)]
        sq = []
        if max_sizes:
            d = math.sqrt(mn * max_sizes[s]) / 2.0
            sq.append((d, d))
        half.extend([(mn / 2.0, mn / 2.0)] + sq + per_min if mm_order
                    else per_min + sq)
    return half


def _prior_table(fh, fw, img_h, img_w, half, offset, step_w, step_h,
                 clip, variances):
    """(Boxes, Variances) [fh, fw, P, 4] float32 as numpy, each
    operation of the JAX lowering in float32 in its order."""
    f32 = torch.float32
    sw = step_w or img_w / fw
    sh = step_h or img_h / fh
    cx = (torch.arange(fw, dtype=f32) + offset) * sw
    cy = (torch.arange(fh, dtype=f32) + offset) * sh
    h = torch.tensor(half, dtype=f32)
    p = h.shape[0]
    cxg = cx[None, :, None].expand(fh, fw, p)
    cyg = cy[:, None, None].expand(fh, fw, p)
    hw = h[None, None, :, 0].expand(fh, fw, p)
    hh = h[None, None, :, 1].expand(fh, fw, p)
    boxes = torch.stack([(cxg - hw) / img_w, (cyg - hh) / img_h,
                         (cxg + hw) / img_w, (cyg + hh) / img_h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=f32).expand(fh, fw, p, 4)
    return torch.stack([boxes, var]).numpy()


@register_no_grad_op("prior_box")
def prior_box(ctx):
    """SSD priors of each cell of Input's [fh, fw] grid on Image: Boxes
    and Variances [fh, fw, P, 4], normalized by the image's size; the
    step is the image's size over the grid's unless step_w / step_h set
    it. A constant of the shapes and attrs: made once a plan."""
    feat, image = ctx.input("Input"), ctx.input("Image")
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", []) or []]
    ars = _expand_aspect_ratios(ctx.attr("aspect_ratios", [1.0]),
                                ctx.attr("flip", False))
    half = _prior_halves(min_sizes, max_sizes, ars,
                         ctx.attr("min_max_aspect_ratios_order", False))
    args = (int(feat.shape[2]), int(feat.shape[3]), int(image.shape[2]),
            int(image.shape[3]), tuple(half), ctx.attr("offset", 0.5),
            ctx.attr("step_w", 0.0), ctx.attr("step_h", 0.0),
            bool(ctx.attr("clip", False)),
            tuple(ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])))
    both = ctx.host_table("prior_box", args, lambda: _prior_table(*args))
    ctx.set_output("Boxes", both[0])
    ctx.set_output("Variances", both[1])


# ---------------------------------------------------------------------------
# box arithmetic
# ---------------------------------------------------------------------------

@register_no_grad_op("iou_similarity")
def iou_similarity(ctx):
    """Out [N, M] = IoU of each box of X [N, 4] with each of Y [M, 4]; Out
    keeps X's LoD."""
    out = _pairwise_iou(ctx.input("X"), ctx.input("Y"),
                        ctx.attr("box_normalized", True))
    ctx.set_output("Out", out)
    lod = ctx.get_lod("X")
    if lod:
        ctx.set_lod("Out", lod)


def _variance(ctx, variance, dtype):
    """The `variance` attr as a [4] tensor on the op's device."""
    return ctx.host_table("box_coder_variance", tuple(variance),
                          lambda: np.asarray(variance, np.float32)
                          ).to(dtype)


@register_op("box_coder", no_grad_slots=("PriorBox", "PriorBoxVar"))
def box_coder(ctx):
    """encode_center_size: TargetBox [N, 4] against PriorBox [M, 4] ->
    [N, M, 4] offsets (divided by the variance: PriorBoxVar [M, 4] or
    the `variance` attr); decode_center_size: TargetBox [N, M, 4] offsets
    -> boxes, the priors along `axis`. An encoded OutputBox keeps
    TargetBox's LoD, as the reference's op shares it (the JAX lowering
    sets none): ssd_loss's target_assign reads each image's rows from it.
    The gradient reaches TargetBox only."""
    prior, pvar = ctx.input("PriorBox"), ctx.input("PriorBoxVar")
    target = ctx.input("TargetBox")
    code_type = ctx.attr("code_type", "encode_center_size")
    off = 0.0 if ctx.attr("box_normalized", True) else 1.0
    axis = ctx.attr("axis", 0)
    variance = ctx.attr("variance", [])
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if code_type.lower() in ("encode_center_size", "encodecentersize"):
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = (target[:, 2] + target[:, 0]) / 2
        tcy = (target[:, 3] + target[:, 1]) / 2
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        oh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ox, oy, ow, oh], dim=-1)
        if pvar is not None:
            out = out / pvar[None, :, :]
        elif variance:
            out = out / _variance(ctx, variance, out.dtype)
        lod = ctx.get_lod("TargetBox")
        if lod:
            ctx.set_lod("OutputBox", lod)
    else:
        if axis == 0:
            pw_b, ph_b, pcx_b, pcy_b = (t[None, :] for t in (pw, ph, pcx,
                                                             pcy))
            var_b = pvar[None, :, :] if pvar is not None else None
        else:
            pw_b, ph_b, pcx_b, pcy_b = (t[:, None] for t in (pw, ph, pcx,
                                                             pcy))
            var_b = pvar[:, None, :] if pvar is not None else None
        t = target
        if var_b is not None:
            t = t * var_b
        elif variance:
            t = t * _variance(ctx, variance, t.dtype)
        ocx = t[..., 0] * pw_b + pcx_b
        ocy = t[..., 1] * ph_b + pcy_b
        ow = torch.exp(t[..., 2]) * pw_b
        oh = torch.exp(t[..., 3]) * ph_b
        out = torch.stack([ocx - ow / 2, ocy - oh / 2,
                           ocx + ow / 2 - off, ocy + oh / 2 - off], dim=-1)
    ctx.set_output("OutputBox", out)


# ---------------------------------------------------------------------------
# matching, targets, mining
# ---------------------------------------------------------------------------

@register_no_grad_op("bipartite_match")
def bipartite_match(ctx):
    """Greedy bipartite matching of each image's DistMat rows (its LoD
    segment; one segment without a LoD) to the M columns: repeatedly the
    largest entry above 1e-6 among unmatched rows and columns (the first
    in row-major order on a tie) matches its pair. per_prediction then
    gives each unmatched column its best row where that reaches
    dist_threshold. ColToRowMatchIndices [N, M] int32 (the row within
    the image, -1 unmatched) and ColToRowMatchDist [N, M]. Batched: the
    rows padded to the largest image's, min(G_max, M) steps for all (a
    step past an image's own count changes nothing)."""
    dist = ctx.input("DistMat")
    segs = _segments(ctx.get_lod("DistMat"), dist.shape[0])
    n, m = len(segs), dist.shape[1]
    idx, valid = _padded_rows(ctx, "bipartite_rows", segs)
    g_max = idx.shape[1]
    neg_inf = dist.new_full((), float("-inf"))
    d = torch.where(valid[:, :, None], dist[idx], neg_inf)   # [N, G, M]
    midx = torch.full((n, m), -1, dtype=torch.int32, device=dist.device)
    mdist = dist.new_zeros((n, m))
    if ctx.device.type != "meta":
        row_used = torch.zeros((n, g_max), dtype=torch.bool,
                               device=dist.device)
        eps = 1e-6
        minus_one = dist.new_full((), -1.0)
        row_ids = torch.arange(g_max, device=dist.device)[None, :]
        for _ in range(min(g_max, m)):
            live = (d > eps) & ~row_used[:, :, None] & (midx[:, None, :] < 0)
            flat = torch.where(live, d, minus_one).reshape(n, -1)
            k = torch.argmax(flat, dim=1, keepdim=True)
            val = torch.gather(flat, 1, k)
            i, j = k // m, k % m
            do = val > 0
            midx = torch.where(do, midx.scatter(1, j, i.to(torch.int32)),
                               midx)
            mdist = torch.where(do, mdist.scatter(1, j, val), mdist)
            row_used = row_used | (do & (row_ids == i))
    if ctx.attr("match_type", "bipartite") == "per_prediction":
        best, best_row = torch.amax(d, dim=1), torch.argmax(d, dim=1)
        fill = (midx < 0) & (best >= ctx.attr("dist_threshold", 0.5))
        midx = torch.where(fill, best_row.to(torch.int32), midx)
        mdist = torch.where(fill, best, mdist)
    ctx.set_output("ColToRowMatchIndices", midx)
    ctx.set_output("ColToRowMatchDist", mdist)


@register_no_grad_op("target_assign")
def target_assign(ctx):
    """Out [N, M, K]: with X viewed as [rows, P, K] (P = 1 for a 2-D X)
    and image b's rows its LoD segment, Out[b, w] = X[start_b +
    match[b, w], w % P] where match[b, w] >= 0, else mismatch_value;
    OutWeight [N, M, 1] is 1 there. NegIndices (each image's LoD
    segment, -1 entries dropped) set OutWeight to 1 at those priors. N
    is the number of segments, as in the JAX lowering."""
    x = ctx.input("X")
    match = ctx.input("MatchIndices")
    neg = ctx.input("NegIndices")
    x3 = x[:, None, :] if x.ndim == 2 else x
    p_dim = x3.shape[1]
    segs = _segments(ctx.get_lod("X"), x.shape[0])
    n, m = len(segs), match.shape[1]
    key = tuple(segs)
    starts = ctx.host_table("assign_starts", key, lambda: np.array(
        [[s, max(e - s - 1, 0)] for s, e in segs], np.int64))
    mt = match[:n].long()
    rows = starts[:, :1] + torch.minimum(torch.clamp_min(mt, 0),
                                         starts[:, 1:])
    w_idx = torch.arange(m, device=x.device) % p_dim
    gathered = x3[rows, w_idx[None, :]]                      # [N, M, K]
    matched = (mt >= 0)[:, :, None]
    out = torch.where(matched, gathered,
                      x.new_full((), ctx.attr("mismatch_value", 0)))
    wt = matched.to(torch.float32)
    if neg is not None:
        nsegs = _segments(ctx.get_lod("NegIndices"), neg.shape[0])
        nidx, nvalid = _padded_rows(ctx, "assign_neg", nsegs)
        ids = neg.reshape(-1).long()[nidx]
        ids = torch.where(nvalid & (ids >= 0), ids, m)   # dropped: column M
        w = torch.cat([wt[:len(nsegs), :, 0],
                       wt.new_zeros((len(nsegs), 1))], dim=1)
        wt = w.scatter(1, ids, 1.0)[:, :m, None]
    ctx.set_output("Out", out)
    ctx.set_output("OutWeight", wt)


@register_no_grad_op("mine_hard_examples")
def mine_hard_examples(ctx):
    """max_negative mining: each image keeps its num_neg = min(int(
    num_pos*neg_pos_ratio), #negatives) highest-loss negatives (priors
    unmatched with MatchDist below neg_dist_threshold), the loss
    ClsLoss (+ LocLoss). NegIndices [N*M, 1] int32, LoD [i*M]: image i's
    kept priors by descending loss (stable), then -1 padding;
    UpdatedMatchIndices is MatchIndices."""
    cls_loss, loc_loss = ctx.input("ClsLoss"), ctx.input("LocLoss")
    match, dist = ctx.input("MatchIndices"), ctx.input("MatchDist")
    ratio = ctx.attr("neg_pos_ratio", 3.0)
    if ctx.attr("mining_type", "max_negative") != "max_negative":
        raise NotImplementedError(
            "mine_hard_examples: only max_negative mining is supported "
            "(hard_example mining needs sample_size)")
    loss = cls_loss if loc_loss is None else cls_loss + loc_loss
    n, m = match.shape
    loss = loss[:n]                     # image b's losses: row b
    is_neg = (match < 0) & (dist < ctx.attr("neg_dist_threshold", 0.5))
    num_pos = torch.sum(match >= 0, dim=1, keepdim=True)
    num_neg = torch.minimum((num_pos * ratio).to(torch.float32)
                            .to(torch.int32),
                            torch.sum(is_neg, dim=1, keepdim=True)
                            .to(torch.int32))
    scores = torch.where(is_neg, loss, loss.new_full((), float("-inf")))
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    keep = torch.arange(m, device=match.device)[None, :] < num_neg
    neg = torch.where(keep, order, -1).to(torch.int32).reshape(-1, 1)
    ctx.set_output("NegIndices", neg)
    ctx.set_lod("NegIndices", [[i * m for i in range(n + 1)]])
    ctx.set_output("UpdatedMatchIndices", match)


# ---------------------------------------------------------------------------
# multiclass_nms
# ---------------------------------------------------------------------------

def _nms_thresholds(k, nms_threshold, eta):
    """The threshold of each of the K greedy steps, float32: it starts at
    nms_threshold and, with eta < 1, is multiplied by eta after each step
    while above 0.5 (the JAX lowering's fori_loop carry)."""
    t = np.float32(nms_threshold)
    out = np.empty(k, np.float32)
    for i in range(k):
        out[i] = t
        if eta < 1.0 and t > 0.5:
            t = np.float32(t * np.float32(eta))
    return out


@register_no_grad_op("multiclass_nms")
def multiclass_nms(ctx):
    """Per image and class (but background_label), greedy NMS over the
    nms_top_k best-scored of BBoxes [N, M, 4] by Scores [N, C, M]; then
    the keep_top_k best kept detections above score_threshold across the
    classes. Out [N*keep_top_k, 6] (label, score, x1, y1, x2, y2), rows
    of absent detections label -1, score 0, box 0; LoD
    [keep_top_k * i] (the JAX package's static contract). Batched over
    [N, C-1, K]: the candidates' IoU above each step's threshold once,
    then K steps for every image and class."""
    boxes, scores = ctx.input("BBoxes"), ctx.input("Scores")
    score_threshold = ctx.attr("score_threshold", 0.0)
    nms_top_k = ctx.attr("nms_top_k", -1)
    keep_top_k = ctx.attr("keep_top_k", -1)
    background = ctx.attr("background_label", 0)
    n, c, m = scores.shape
    if keep_top_k <= 0:
        keep_top_k = m
    k = nms_top_k if 0 < nms_top_k < m else m
    classes = [i for i in range(c) if i != background]
    if keep_top_k > len(classes) * k:
        raise ValueError(
            f"multiclass_nms: keep_top_k {keep_top_k} exceeds the "
            f"{len(classes)} x {k} candidates an image, so the static "
            f"contract of keep_top_k rows an image cannot hold")
    dev = scores.device
    cls = ctx.host_table("nms_classes", tuple(classes),
                         lambda: np.array(classes, np.int64))
    sc = scores[:, cls]                                      # [N, C', M]
    s_sorted, order = torch.sort(sc, dim=2, descending=True, stable=True)
    s_sorted, order = s_sorted[..., :k], order[..., :k]
    cand = torch.gather(boxes[:, None].expand(n, len(classes), m, 4), 2,
                        order[..., None].expand(-1, -1, -1, 4))
    keep = torch.ones(s_sorted.shape, dtype=torch.bool, device=dev)
    if ctx.device.type != "meta":
        thr = ctx.host_table("nms_thresholds", (
            k, ctx.attr("nms_threshold", 0.3), ctx.attr("nms_eta", 1.0)),
            lambda: _nms_thresholds(k, ctx.attr("nms_threshold", 0.3),
                                    ctx.attr("nms_eta", 1.0)))
        over = _pairwise_iou(cand, cand, ctx.attr("normalized", True)) > \
            thr[:, None]                                     # [N, C', K, K]
        for i in range(1, k):
            sup = torch.any(over[..., i, :i] & keep[..., :i], dim=-1)
            keep[..., i] &= ~sup
    valid = keep & (s_sorted > score_threshold)
    cs = torch.where(valid, s_sorted, s_sorted.new_full((), -1.0))
    cs = cs.reshape(n, -1)
    cl = cls[None, :, None].expand(n, len(classes), k).reshape(n, -1)
    cb = cand.reshape(n, -1, 4)
    top = torch.sort(cs, dim=1, descending=True, stable=True)[1][
        :, :keep_top_k]
    s_t = torch.gather(cs, 1, top)
    l_t = torch.gather(cl, 1, top)
    b_t = torch.gather(cb, 1, top[..., None].expand(-1, -1, 4))
    ok = s_t > 0
    row = torch.cat([torch.where(ok, l_t, -1).to(boxes.dtype)[..., None],
                     torch.where(ok, s_t, s_t.new_zeros(()))[..., None],
                     b_t * ok[..., None]], dim=-1)
    ctx.set_output("Out", row.reshape(-1, 6))
    ctx.set_lod("Out", [[keep_top_k * i for i in range(n + 1)]])


# ---------------------------------------------------------------------------
# detection_map (host)
# ---------------------------------------------------------------------------

class DetectionMAPState:
    """Host-side accumulation state of the DetectionMAP evaluator
    (per-class positive counts and scored true/false positive lists). It
    lives in a persistable scope var; the eager detection_map op reads
    and re-emits it."""

    def __init__(self):
        self.pos_count = {}
        self.true_pos = {}
        self.false_pos = {}
        self.empty = True


def _np_iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + \
        (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def _host(ctx, v):
    if ctx.device.type == "meta":
        raise NotImplementedError(
            "detection_map accumulates value-dependent per-class lists on "
            "the host: it runs eagerly only")
    return tensor_to_numpy(v)


def _map_state(ctx, class_num):
    """(pos_count, true_pos, false_pos) carried in: from a
    DetectionMAPState in PosCount, from HasState/PosCount/TruePos/
    FalsePos tensors, or empty."""
    pos_count = {c: 0 for c in range(class_num)}
    true_pos = {c: [] for c in range(class_num)}
    false_pos = {c: [] for c in range(class_num)}
    state = ctx.input("PosCount")
    has_state = ctx.input("HasState")
    if isinstance(state, DetectionMAPState):
        if not state.empty:
            pos_count = {c: int(v) for c, v in state.pos_count.items()}
            true_pos = {c: [list(r) for r in v]
                        for c, v in state.true_pos.items()}
            false_pos = {c: [list(r) for r in v]
                         for c, v in state.false_pos.items()}
    elif has_state is not None and int(_host(ctx, has_state).ravel()[0]):
        pc = _host(ctx, state).ravel()
        for c in range(min(class_num, pc.shape[0])):
            pos_count[c] = int(pc[c])
        for slot, lists in (("TruePos", true_pos), ("FalsePos", false_pos)):
            rows = _host(ctx, ctx.input(slot)).reshape(-1, 2)
            for c, (s, e) in enumerate(_segments(ctx.get_lod(slot),
                                                 rows.shape[0])):
                lists[c] = [list(r) for r in rows[s:e]]
    return pos_count, true_pos, false_pos


def _accumulate(det, label, det_segs, lab_segs, overlap_threshold,
                evaluate_difficult, pos_count, true_pos, false_pos):
    """Each image's detections, by descending score (stable), matched to
    its ground truth of their class (the best IoU at or above the
    threshold, once each): scored true/false positive rows appended."""
    for (ds, de), (ls, le) in zip(det_segs, lab_segs):
        per_class_gt = {}
        for row in label[ls:le]:
            c = int(row[0])
            difficult, box = (0.0, row[1:5]) if len(row) == 5 else \
                (row[1], row[2:6])
            if evaluate_difficult or not difficult:
                pos_count[c] = pos_count.get(c, 0) + 1
            per_class_gt.setdefault(c, []).append(
                (list(map(float, box)), bool(difficult)))
        dets = det[ds:de]
        matched = {c: [False] * len(v) for c, v in per_class_gt.items()}
        for i in np.argsort(-dets[:, 1], kind="stable"):
            c, score = int(dets[i, 0]), float(dets[i, 1])
            best, best_j = 0.0, -1
            for j, (gb, _) in enumerate(per_class_gt.get(c, [])):
                ov = _np_iou(dets[i, 2:6], gb)
                if ov > best:
                    best, best_j = ov, j
            tp = 0
            if best >= overlap_threshold:
                if not evaluate_difficult and per_class_gt[c][best_j][1]:
                    continue
                if not matched[c][best_j]:
                    matched[c][best_j] = True
                    tp = 1
            true_pos.setdefault(c, []).append([score, tp])
            false_pos.setdefault(c, []).append([score, 1 - tp])


def _mean_ap(pos_count, true_pos, false_pos, ap_type):
    """The mean over the classes with positives and detections of their
    AP: 11point (the best precision at recall >= j/10, j = 0..10) or
    integral (precision times each recall step)."""
    m_ap, count = 0.0, 0
    for c, npos in pos_count.items():
        if npos == 0 or not true_pos.get(c):
            continue
        tps = sorted(true_pos[c], key=lambda r: -r[0])
        fps = sorted(false_pos[c], key=lambda r: -r[0])
        tp_acc = np.cumsum([r[1] for r in tps])
        fp_acc = np.cumsum([r[1] for r in fps])
        precision = tp_acc / np.maximum(tp_acc + fp_acc, 1e-12)
        recall = tp_acc / npos
        if ap_type == "11point":
            max_p = np.zeros(11)
            for j in range(11):
                mask = recall >= j / 10.0
                if mask.any():
                    max_p[j] = precision[mask].max()
            m_ap += max_p.sum() / 11
        else:
            ap, prev_r = 0.0, 0.0
            for r, p in zip(recall, precision):
                if abs(r - prev_r) > 1e-6:
                    ap += p * abs(r - prev_r)
                    prev_r = r
            m_ap += ap
        count += 1
    return m_ap / count if count else 0.0


@register_no_grad_op("detection_map")
def detection_map(ctx):
    """VOC mAP over DetectRes rows (label, score, x1, y1, x2, y2) and
    Label rows (label, difficult, x1, y1, x2, y2) or (label, x1, y1, x2,
    y2), one LoD segment an image, with the state carried in (a
    DetectionMAPState in PosCount: the evaluator's; or the HasState
    tensors). MAP is a 0-d float32; AccumPosCount the state out
    (a DetectionMAPState where one came in, else int32 [class_num, 1]),
    AccumTruePos / AccumFalsePos the scored rows, a LoD segment a
    class. On the host: the block stays eager."""
    det = _host(ctx, ctx.input("DetectRes"))
    label = _host(ctx, ctx.input("Label"))
    class_num = ctx.attr("class_num")
    pos_count, true_pos, false_pos = _map_state(ctx, class_num)
    _accumulate(det, label, _segments(ctx.get_lod("DetectRes"),
                                      det.shape[0]),
                _segments(ctx.get_lod("Label"), label.shape[0]),
                ctx.attr("overlap_threshold", 0.5),
                ctx.attr("evaluate_difficult", True), pos_count, true_pos,
                false_pos)
    m_ap = _mean_ap(pos_count, true_pos, false_pos,
                    ctx.attr("ap_type", "integral"))
    dev = ctx.device
    ctx.set_output("MAP", torch.tensor(m_ap, dtype=torch.float32,
                                       device=dev))
    if isinstance(ctx.input("PosCount"), DetectionMAPState):
        state = DetectionMAPState()
        state.pos_count = dict(pos_count)
        state.true_pos = {c: [list(r) for r in v]
                          for c, v in true_pos.items()}
        state.false_pos = {c: [list(r) for r in v]
                           for c, v in false_pos.items()}
        state.empty = False
        ctx.set_output("AccumPosCount", state)
    else:
        ctx.set_output("AccumPosCount", torch.tensor(
            [[pos_count.get(c, 0)] for c in range(class_num)],
            dtype=torch.int32, device=dev))
    for slot, lists in (("AccumTruePos", true_pos),
                        ("AccumFalsePos", false_pos)):
        rows, offs = [], [0]
        for c in range(class_num):
            rows += lists.get(c, [])
            offs.append(len(rows))
        ctx.set_output(slot, torch.tensor(
            np.array(rows, np.float32).reshape(-1, 2), device=dev))
        ctx.set_lod(slot, [offs])
