"""The detection ops (counterpart of paddle_tpu/ops/detection.py): SSD's
prior_box, iou_similarity, box_coder, bipartite_match, target_assign,
mine_hard_examples, multiclass_nms and detection_map; and the
one-stage detectors' yolov3_loss, yolo_box, anchor_generator,
density_prior_box, sigmoid_focal_loss, retinanet_target_assign,
retinanet_detection_output, box_clip, box_decoder_and_assign and
polygon_box_transform.

Every op but detection_map is shape-static for a LoD, so a block that
holds them is captured as one CUDA graph. The JAX lowerings unroll over
the LoD segments (one image each) and yolov3_loss loops over the boxes;
these run batched over the images and the boxes: each image's rows are
padded to the batch's largest count, through index and mask tensors
made from the LoD offsets by ExecContext.host_table (once a plan: no
host copy under capture), and each greedy loop runs once for the batch,
over [N, G_max, M] (bipartite_match), [N, C-1, K] (multiclass_nms) and
[N, K] (retinanet_detection_output). The priors and anchors are
host-table constants. The results equal the JAX lowerings', ties
included: argmax takes the first maximum and every sort is stable, as
jnp.argsort of the negated scores is. On the meta device (build-time
shape inference, the engine's capture rule) the loops are skipped: they
change no shape.

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


def _greedy_keep(over, keep):
    """Greedy NMS over candidates sorted by descending score, batched
    over the leading dims: candidate i stays unless a kept one before it
    overlaps it (`over` [..., K, K], IoU above the step's threshold).
    Clears `keep` [..., K] in place and returns it."""
    for i in range(1, keep.shape[-1]):
        keep[..., i] &= ~torch.any(over[..., i, :i] & keep[..., :i], dim=-1)
    return keep


def _top_rows(score, label, boxes, keep_top_k):
    """The keep_top_k best rows an image of candidates `score` [N, K]
    (-1 where not kept), `label` [N, K] and `boxes` [N, K, 4], by
    descending score (stable on ties): [N * keep_top_k, 6] (label, score,
    x1, y1, x2, y2), the rows of a score at or below 0 label -1, score 0
    and box 0."""
    top = torch.sort(score, dim=1, descending=True, stable=True)[1][
        :, :keep_top_k]
    s_t = torch.gather(score, 1, top)
    l_t = torch.gather(label, 1, top)
    b_t = torch.gather(boxes, 1, top[..., None].expand(-1, -1, 4))
    ok = s_t > 0
    row = torch.cat([torch.where(ok, l_t, -1).to(boxes.dtype)[..., None],
                     torch.where(ok, s_t, s_t.new_zeros(()))[..., None],
                     b_t * ok[..., None]], dim=-1)
    return row.reshape(-1, 6)


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
        _greedy_keep(over, keep)
    valid = keep & (s_sorted > score_threshold)
    cs = torch.where(valid, s_sorted, s_sorted.new_full((), -1.0))
    cl = cls[None, :, None].expand(n, len(classes), k).reshape(n, -1)
    ctx.set_output("Out", _top_rows(cs.reshape(n, -1), cl,
                                    cand.reshape(n, -1, 4), keep_top_k))
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


# ---------------------------------------------------------------------------
# one-stage detectors: anchors and priors (host-table constants)
# ---------------------------------------------------------------------------

def _anchor_table(fh, fw, half, sw, sh, off, variances):
    """anchor_generator's (Anchors, Variances) [fh, fw, P, 4] float32 as
    numpy, each operation of the JAX lowering in float32 in its order."""
    f32 = torch.float32
    h = torch.tensor(half, dtype=f32)
    p = h.shape[0]
    cx = (torch.arange(fw, dtype=f32) * sw) + off * sw
    cy = (torch.arange(fh, dtype=f32) * sh) + off * sh
    cxg = cx[None, :, None].expand(fh, fw, p)
    cyg = cy[:, None, None].expand(fh, fw, p)
    hw = h[None, None, :, 0].expand(fh, fw, p)
    hh = h[None, None, :, 1].expand(fh, fw, p)
    anchors = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    var = torch.tensor(variances, dtype=f32).expand(fh, fw, p, 4)
    return torch.stack([anchors, var]).numpy()


@register_no_grad_op("anchor_generator")
def anchor_generator(ctx):
    """RCNN anchors of each cell of Input's [fh, fw] grid: for each
    aspect ratio, then each size, w = size / stride_w * round(sqrt(
    stride_w * stride_h / ar)) and h = size / stride_h * round(w_base *
    ar), Python's round (half to even), centred at (j + offset) *
    stride. Anchors and Variances [fh, fw, P, 4], in pixels. A constant
    of the shapes and attrs: made once a plan."""
    feat = ctx.input("Input")
    sizes = [float(s) for s in ctx.attr("anchor_sizes")]
    ratios = [float(r) for r in ctx.attr("aspect_ratios")]
    sw, sh = (float(s) for s in ctx.attr("stride"))
    half = []
    for ar in ratios:
        for sz in sizes:
            base_w = round(math.sqrt(sw * sh / ar))
            base_h = round(base_w * ar)
            half.append((sz / sw * base_w / 2.0, sz / sh * base_h / 2.0))
    args = (int(feat.shape[2]), int(feat.shape[3]), tuple(half), sw, sh,
            ctx.attr("offset", 0.5),
            tuple(ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])))
    both = ctx.host_table("anchor_generator", args,
                          lambda: _anchor_table(*args))
    ctx.set_output("Anchors", both[0])
    ctx.set_output("Variances", both[1])


def _density_table(fh, fw, img_h, img_w, entries, offset, step_w, step_h,
                   clip, variances):
    """density_prior_box's (Boxes, Variances) [fh, fw, P, 4] float32 as
    numpy, each operation of the JAX lowering in float32 in its order."""
    f32 = torch.float32
    sw = step_w or img_w / fw
    sh = step_h or img_h / fh
    ent = torch.tensor(entries, dtype=f32)
    p = ent.shape[0]
    cx = (torch.arange(fw, dtype=f32) + offset) * sw
    cy = (torch.arange(fh, dtype=f32) + offset) * sh
    cxg = (cx[None, :, None] + ent[None, None, :, 0]).expand(fh, fw, p)
    cyg = (cy[:, None, None] + ent[None, None, :, 1]).expand(fh, fw, p)
    hw = ent[None, None, :, 2].expand(fh, fw, p)
    hh = ent[None, None, :, 3].expand(fh, fw, p)
    boxes = torch.stack([(cxg - hw) / img_w, (cyg - hh) / img_h,
                         (cxg + hw) / img_w, (cyg + hh) / img_h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=f32).expand(fh, fw, p, 4)
    return torch.stack([boxes, var]).numpy()


@register_no_grad_op("density_prior_box")
def density_prior_box(ctx):
    """Densified square priors: for each (fixed_size, density) pair and
    each fixed_ratio, a density x density grid of boxes of fixed_size *
    sqrt(ratio) by fixed_size / sqrt(ratio), shifted by int(step /
    density) within the cell. Boxes and Variances [fh, fw, P, 4],
    normalized by Image's size. A constant of the shapes and attrs."""
    feat, image = ctx.input("Input"), ctx.input("Image")
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    step_w, step_h = ctx.attr("step_w", 0.0), ctx.attr("step_h", 0.0)
    sw = step_w or img_w / fw
    sh = step_h or img_h / fh
    densities = [int(d) for d in ctx.attr("densities", [])]
    entries = []
    for k, fs in enumerate(float(s) for s in ctx.attr("fixed_sizes", [])):
        shift = int(sw / densities[k])
        for ar in (float(r) for r in ctx.attr("fixed_ratios", [])):
            bw, bh = fs * math.sqrt(ar), fs / math.sqrt(ar)
            for di in range(densities[k]):
                for dj in range(densities[k]):
                    entries.append((-sw / 2.0 + shift / 2.0 + dj * shift,
                                    -sh / 2.0 + shift / 2.0 + di * shift,
                                    bw / 2.0, bh / 2.0))
    args = (fh, fw, img_h, img_w, tuple(entries), ctx.attr("offset", 0.5),
            step_w, step_h, bool(ctx.attr("clip", False)),
            tuple(ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])))
    both = ctx.host_table("density_prior_box", args,
                          lambda: _density_table(*args))
    ctx.set_output("Boxes", both[0])
    ctx.set_output("Variances", both[1])


# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------

def _clip(x, lo, hi):
    """jnp.clip's minimum(maximum(x, lo), hi), its gradient split at a
    tie as lax.max / lax.min split theirs."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _row_images(ctx, kind, segs, n_rows):
    """[n_rows] int64 on the op's device: each row's image (its LoD
    segment's number)."""
    def build():
        ids = np.zeros(n_rows, np.int64)
        for b, (s, e) in enumerate(segs):
            ids[s:e] = b
        return ids
    return ctx.host_table(kind, (tuple(segs), n_rows), build)


@register_op("box_clip", no_grad_slots=("ImInfo",))
def box_clip(ctx):
    """Input's boxes (x1, y1, x2, y2 in its last dim of 4k) clipped to
    [0, w - 1] x [0, h - 1] of their image, (h, w) = ImInfo's (height,
    width) / scale; image b's rows are Input's LoD segment b (all of
    them image 0 without a LoD). Output keeps Input's LoD."""
    boxes, im_info = ctx.input("Input"), ctx.input("ImInfo")
    lod = ctx.get_lod("Input")
    r = boxes.shape[0]
    info = im_info.index_select(0, _row_images(
        ctx, "box_clip_rows", _segments(lod, r), r))
    h = (info[:, 0] / info[:, 2] - 1)[:, None]
    w = (info[:, 1] / info[:, 2] - 1)[:, None]
    flat = boxes.reshape(r, -1, 4)
    zero = boxes.new_zeros(())
    out = torch.stack([_clip(flat[..., 0], zero, w),
                       _clip(flat[..., 1], zero, h),
                       _clip(flat[..., 2], zero, w),
                       _clip(flat[..., 3], zero, h)], dim=-1)
    ctx.set_output("Output", out.reshape(boxes.shape))
    if lod:
        ctx.set_lod("Output", lod)


@register_no_grad_op("box_decoder_and_assign")
def box_decoder_and_assign(ctx):
    """TargetBox [R, 4C] deltas decoded against PriorBox [R, 4] (pixel
    boxes, +1 widths) scaled by PriorBoxVar, the log-size deltas clipped
    to +-box_clip: DecodeBox [R, 4C]; OutputAssignBox [R, 4] is the box
    of each row's best-scored class in BoxScore [R, C] (the first on a
    tie)."""
    prior, pvar = ctx.input("PriorBox"), ctx.input("PriorBoxVar")
    target, score = ctx.input("TargetBox"), ctx.input("BoxScore")
    bc = ctx.attr("box_clip", 4.135)
    r, c = prior.shape[0], score.shape[1]
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    t = target.reshape(r, c, 4)
    v = pvar if pvar is not None else torch.ones_like(prior)
    dx = t[..., 0] * v[:, None, 0]
    dy = t[..., 1] * v[:, None, 1]
    dw = torch.clamp(t[..., 2] * v[:, None, 2], -bc, bc)
    dh = torch.clamp(t[..., 3] * v[:, None, 3], -bc, bc)
    cx = dx * pw[:, None] + pcx[:, None]
    cy = dy * ph[:, None] + pcy[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - 1,
                           cy + h / 2 - 1], dim=-1)          # [R, C, 4]
    ctx.set_output("DecodeBox", decoded.reshape(r, c * 4))
    best = torch.argmax(score, dim=1)
    ctx.set_output("OutputAssignBox", torch.gather(
        decoded, 1, best[:, None, None].expand(r, 1, 4))[:, 0])


@register_no_grad_op("polygon_box_transform")
def polygon_box_transform(ctx):
    """EAST's quads: Output = 4 * (column, row) of each cell - Input, the
    column at even channels, the row at odd ones."""
    x = ctx.input("Input")
    _, c, h, w = x.shape
    col = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
    row = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
    base_x = (col * 4.0).expand(h, w)
    base_y = (row * 4.0).expand(h, w)
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    ctx.set_output("Output", torch.where(is_x, base_x, base_y) - x)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@register_op("sigmoid_focal_loss", no_grad_slots=("Label", "FgNum"))
def sigmoid_focal_loss(ctx):
    """Out [N, C]: focal loss of each (sample, class) logit of X, the
    positive class label - 1 (label 0 is background, -1 ignored: no
    term), alpha * (1 - p)^gamma * -log p for it and (1 - alpha) * p^gamma
    * -log(1 - p) for the others, over max(FgNum, 1)."""
    x = ctx.input("X")
    label = ctx.input("Label").reshape(-1)
    fg = torch.clamp_min(ctx.input("FgNum").reshape(()).to(x.dtype), 1.0)
    gamma, alpha = ctx.attr("gamma", 2.0), ctx.attr("alpha", 0.25)
    c_pos = (label[:, None] - 1) == torch.arange(x.shape[1],
                                                 device=x.device)[None, :]
    p = torch.sigmoid(x)
    ce_pos = -torch.log(torch.clamp_min(p, 1e-12))
    ce_neg = -torch.log(torch.clamp_min(1 - p, 1e-12))
    loss = torch.where(
        c_pos, alpha * torch.pow(1 - p, gamma) * ce_pos,
        (1 - alpha) * torch.pow(p, gamma) * ce_neg *
        (label[:, None] >= 0))
    ctx.set_output("Out", loss / fg)


def _bce(logit, t):
    """Sigmoid cross entropy of a logit against target t, the stable
    form the JAX lowering takes."""
    return torch.clamp_min(logit, 0) - logit * t + \
        torch.log1p(torch.exp(-torch.abs(logit)))


@register_op("yolov3_loss",
             no_grad_slots=("GTBox", "GTLabel", "ObjectnessMask",
                            "GTMatchMask"))
def yolov3_loss(ctx):
    """YOLOv3's loss of one head, Loss [N]: X [N, A(5 + class_num), H, W]
    against GTBox [N, B, 4] (cx, cy, w, h relative to the input; w = 0 is
    padding) and GTLabel [N, B]. Each box goes to the anchor (of all
    `anchors`) whose shape fits it best; where that anchor is one of this
    head's (`anchor_mask`), the cell (gi, gj) = int(cx W), int(cy H)
    (truncated, clipped) of that anchor takes: sigmoid cross entropy of
    x and y against the box's offsets in the cell and |w - log(gw /
    anchor_w)|, |h - ...|, weighted by 2 - gw gh; sigmoid cross entropy
    of every class against the (smoothed) one-hot label; and objectness
    1. Every other cell and anchor whose predicted box reaches no box
    at IoU ignore_thresh takes objectness 0. Two boxes on one cell and
    anchor both add their terms. With GTScore [N, B], as the reference:
    a box's terms are weighted by its score, and its cell's objectness
    target by the score of the last box there (a score at or below 1e-5
    makes the cell a negative); the JAX lowering reads no GTScore, and
    equals this one without it. ObjectnessMask [N, A, H, W] is the
    not-ignored mask, GTMatchMask [N, B] int32 whether the box is this
    head's.

    Vectorized over the boxes: each box's prediction gathered from X
    (index_select, whose gradient is index_add_: deterministic on the
    card in deterministic mode), the objectness target written by
    index_put of equal values and of one score a cell."""
    x, gt_box = ctx.input("X"), ctx.input("GTBox")
    gt_label, gt_score = ctx.input("GTLabel"), ctx.input("GTScore")
    anchors = [int(a) for a in ctx.attr("anchors")]
    mask = [int(m) for m in ctx.attr("anchor_mask")]
    cls = ctx.attr("class_num")
    thresh = ctx.attr("ignore_thresh", 0.7)
    n, _, h, w = x.shape
    a_n, k, b_n = len(mask), 5 + cls, gt_box.shape[1]
    input_size = ctx.attr("downsample_ratio", 32) * h
    dev, dt = x.device, x.dtype
    an_all = ctx.host_table("yolo_anchors", tuple(anchors), lambda:
                            np.asarray(anchors, np.float32).reshape(-1, 2))
    mask_t = ctx.host_table("yolo_mask", tuple(mask),
                            lambda: np.asarray(mask, np.int64))
    an = an_all[mask_t].to(dt)                               # [A, 2]
    pred = x.reshape(n, a_n, k, h, w)

    # the ignore mask: each predicted box's best IoU with a valid box
    p = pred.detach()
    gx = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
    bx = (torch.sigmoid(p[:, :, 0]) + gx) / w
    by = (torch.sigmoid(p[:, :, 1]) + gy) / h
    bw = torch.exp(p[:, :, 2]) * an[None, :, 0, None, None] / input_size
    bh = torch.exp(p[:, :, 3]) * an[None, :, 1, None, None] / input_size
    valid = gt_box[:, :, 2] > 0                              # [N, B]
    pb = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                     dim=-1).reshape(n, -1, 4)
    g = gt_box
    gb = torch.stack([g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2,
                      g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2],
                     dim=-1)
    iou = torch.where(valid[:, None, :], _pairwise_iou(pb, gb),
                      pb.new_zeros(()))
    noobj = (torch.amax(iou, dim=2) < thresh).reshape(n, a_n, h, w)

    # each box's anchor (over all anchors), cell and targets
    gw_px, gh_px = g[..., 2] * input_size, g[..., 3] * input_size
    inter = torch.minimum(gw_px[..., None], an_all[:, 0]) * \
        torch.minimum(gh_px[..., None], an_all[:, 1])
    union = gw_px[..., None] * gh_px[..., None] + \
        (an_all[:, 0] * an_all[:, 1]) - inter
    best_n = torch.argmax(inter / torch.clamp_min(union, 1e-10), dim=-1)
    eq = best_n[..., None] == mask_t
    on_b = torch.any(eq, dim=-1) & valid                     # [N, B]
    best_a = torch.argmax(eq.to(torch.uint8), dim=-1)
    gi = torch.clamp((g[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((g[..., 1] * h).to(torch.int32), 0, h - 1).long()
    tx = g[..., 0] * w - gi
    ty = g[..., 1] * h - gj
    tw = torch.log(torch.clamp_min(gw_px / an_all[best_n, 0], 1e-9))
    th = torch.log(torch.clamp_min(gh_px / an_all[best_n, 1], 1e-9))
    score = gt_score.to(dt) if gt_score is not None else \
        torch.ones_like(tx)
    on = on_b.to(dt) * score

    # the boxes' predictions, gathered from X: element (n, a, c, j, i)
    img = torch.arange(n, device=dev)[:, None]
    cell = (img * a_n + best_a) * (h * w) + gj * w + gi     # [N, B]
    first = (img * a_n + best_a) * (k * h * w) + gj * w + gi
    idx = first[..., None] + torch.arange(k, device=dev) * (h * w)
    rows = x.reshape(-1).index_select(0, idx.reshape(-1)).reshape(
        n, b_n, k)
    loc = _bce(rows[..., 0], tx) + _bce(rows[..., 1], ty) + \
        torch.abs(rows[..., 2] - tw) + torch.abs(rows[..., 3] - th)
    pos_t, neg_t = 1.0, 0.0
    if ctx.attr("use_label_smooth", True) and cls > 1:
        pos_t, neg_t = 1.0 - 1.0 / cls, 1.0 / cls
    t_cls = torch.where(torch.arange(cls, device=dev) == gt_label[..., None],
                        pos_t, neg_t).to(dt)
    box_loss = torch.sum((2.0 - g[..., 2] * g[..., 3]) * on * loc +
                         on * torch.sum(_bce(rows[..., 5:], t_cls), dim=-1),
                         dim=1)

    # objectness: 1 (weighted by the score of the last box there) at the
    # boxes' cells, 0 where not ignored
    spare = n * a_n * h * w
    last = on_b & ~torch.any(
        (cell[:, :, None] == cell[:, None, :]) & on_b[:, None, :] &
        (torch.arange(b_n, device=dev)[None, :] >
         torch.arange(b_n, device=dev)[:, None]), dim=2)
    hit = torch.zeros(spare + 1, dtype=torch.bool, device=dev).index_put(
        (torch.where(on_b, cell, spare).reshape(-1),),
        torch.ones((), dtype=torch.bool, device=dev))[:spare]
    s_cell = x.new_zeros(spare + 1).index_put(
        (torch.where(last, cell, spare).reshape(-1),),
        score.reshape(-1))[:spare]
    pos = hit & (s_cell > 1e-5)
    wt = torch.where(pos, s_cell, torch.where(
        hit, x.new_ones(()), noobj.reshape(-1).to(dt)))
    obj = _bce(pred[:, :, 4].reshape(-1), pos.to(dt)) * wt
    ctx.set_output("Loss", box_loss + obj.reshape(n, -1).sum(dim=1))
    ctx.set_output("ObjectnessMask", noobj.to(dt))
    ctx.set_output("GTMatchMask", on_b.to(torch.int32))


@register_no_grad_op("yolo_box")
def yolo_box(ctx):
    """YOLOv3's head X [N, A(5 + class_num), H, W] decoded against
    `anchors` (A pairs): Boxes [N, AHW, 4] (x1, y1, x2, y2 in the pixels
    of ImgSize's (h, w) a row, clipped to the image) and Scores [N, AHW,
    class_num] = sigmoid(class) * sigmoid(objectness); both 0 where the
    objectness is at most conf_thresh."""
    x, img_size = ctx.input("X"), ctx.input("ImgSize")
    anchors = [int(a) for a in ctx.attr("anchors")]
    cls = ctx.attr("class_num")
    n, _, h, w = x.shape
    dev, dt = x.device, x.dtype
    an = ctx.host_table("yolo_anchors", tuple(anchors), lambda:
                        np.asarray(anchors, np.float32).reshape(-1, 2)
                        ).to(dt)
    a_n = an.shape[0]
    input_size = ctx.attr("downsample_ratio", 32) * h
    pred = x.reshape(n, a_n, 5 + cls, h, w)
    gx = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
    bx = (torch.sigmoid(pred[:, :, 0]) + gx) / w
    by = (torch.sigmoid(pred[:, :, 1]) + gy) / h
    bw = torch.exp(pred[:, :, 2]) * an[None, :, 0, None, None] / input_size
    bh = torch.exp(pred[:, :, 3]) * an[None, :, 1, None, None] / input_size
    conf = torch.sigmoid(pred[:, :, 4])
    probs = torch.sigmoid(pred[:, :, 5:]) * conf[:, :, None]
    keep = conf > ctx.attr("conf_thresh", 0.01)
    img_h = img_size[:, 0].to(dt)[:, None, None, None]
    img_w = img_size[:, 1].to(dt)[:, None, None, None]
    zero = x.new_zeros(())
    x1 = _clip((bx - bw / 2) * img_w, zero, img_w - 1)
    y1 = _clip((by - bh / 2) * img_h, zero, img_h - 1)
    x2 = _clip((bx + bw / 2) * img_w, zero, img_w - 1)
    y2 = _clip((by + bh / 2) * img_h, zero, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(n, -1, 4)
    ctx.set_output("Boxes", boxes * keep.reshape(n, -1, 1))
    ctx.set_output("Scores", (probs * keep[:, :, None]).permute(
        0, 1, 3, 4, 2).reshape(n, -1, cls))


# ---------------------------------------------------------------------------
# RetinaNet
# ---------------------------------------------------------------------------

@register_no_grad_op("retinanet_target_assign")
def retinanet_target_assign(ctx):
    """Focal-loss targets of the M anchors (Anchor, pixel boxes) of each
    image against its GtBoxes (a LoD segment an image, with GtLabels and
    IsCrowd; a crowd box has IoU 0): an anchor is positive at IoU >=
    positive_overlap with its best box, or where it is a box's best
    anchor (the first, so anchor 0 where all its IoUs are 0: a crowd box
    forces one too); negative below negative_overlap; all anchors kept
    (no subsampling). One row per anchor per image: LocationIndex /
    ScoreIndex [N*M, 1] int32, the row b*M + m of a positive / of a
    positive or negative, else -1; TargetLabel [N*M, 1] int32 (the box's
    label, 0 negative, -1 ignored); TargetBBox [N*M, 4] (the encoded
    best box, 0 unless positive); BBoxInsideWeight [N*M, 4] float32;
    ForegroundNumber [N, 1] int32. Batched over the images, the boxes
    padded to the largest count (_padded_rows); an image without boxes
    has every anchor negative (the JAX lowering's argmax over no box
    fails there)."""
    anchors = ctx.input("Anchor").reshape(-1, 4)
    gt, labels = ctx.input("GtBoxes"), ctx.input("GtLabels")
    crowd = ctx.input("IsCrowd")
    pos_th = ctx.attr("positive_overlap", 0.5)
    neg_th = ctx.attr("negative_overlap", 0.4)
    m, dev = anchors.shape[0], anchors.device
    segs = _segments(ctx.get_lod("GtBoxes"), gt.shape[0])
    n = len(segs)
    idx, valid = _padded_rows(ctx, "retinanet_gt", segs)     # [N, G]
    g_n = idx.shape[1]
    gtp = gt[idx]                                            # [N, G, 4]
    live = valid if crowd is None else \
        valid & (crowd.reshape(-1)[idx] == 0)
    iou = torch.where(live[:, None, :],
                      _pairwise_iou(anchors[None], gtp, normalized=False),
                      anchors.new_zeros(()))                 # [N, M, G]
    best, best_gt = torch.amax(iou, dim=2), torch.argmax(iou, dim=2)
    forced = torch.zeros((n, m + 1), dtype=torch.bool, device=dev).scatter(
        1, torch.where(valid, torch.argmax(iou, dim=1), m),
        torch.ones((n, g_n), dtype=torch.bool, device=dev))[:, :m]
    is_pos = (best >= pos_th) | forced
    is_neg = best < neg_th
    row = torch.arange(m, device=dev)[None, :] + \
        torch.arange(n, device=dev)[:, None] * m
    minus = torch.full((), -1, dtype=row.dtype, device=dev)
    lab = torch.gather(labels.reshape(-1)[idx].long(), 1, best_gt)
    lab = torch.where(is_pos, lab, 0)
    lab = torch.where(is_pos | is_neg, lab, -1)
    g = torch.gather(gtp, 1, best_gt[..., None].expand(n, m, 4))
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    gw = g[..., 2] - g[..., 0] + 1.0
    gh = g[..., 3] - g[..., 1] + 1.0
    gcx = (g[..., 2] + g[..., 0]) / 2
    gcy = (g[..., 3] + g[..., 1]) / 2
    tb = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                      torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    i32 = torch.int32
    ctx.set_output("LocationIndex", torch.where(is_pos, row, minus)
                   .to(i32).reshape(-1, 1))
    ctx.set_output("ScoreIndex", torch.where(is_pos | is_neg, row, minus)
                   .to(i32).reshape(-1, 1))
    ctx.set_output("TargetLabel", lab.to(i32).reshape(-1, 1))
    ctx.set_output("TargetBBox", (tb * is_pos[..., None]).reshape(-1, 4))
    ctx.set_output("BBoxInsideWeight", is_pos.to(torch.float32)[..., None]
                   .expand(n, m, 4).reshape(-1, 4))
    ctx.set_output("ForegroundNumber",
                   torch.sum(is_pos.to(i32), dim=1, dtype=i32)
                   .reshape(-1, 1))


@register_no_grad_op("retinanet_detection_output")
def retinanet_detection_output(ctx):
    """RetinaNet's detections: for each level, the min(nms_top_k, M_i)
    best of BBoxes[i]'s [N, M_i * C] scores (Scores[i] [N, M_i, C],
    stable on ties), each decoded against its anchor (Anchors[i], pixel
    boxes; log sizes capped at 4.135) and clipped to ImInfo's image, its
    score -1 at or below score_threshold; then one greedy NMS (IoU above
    nms_threshold, +1 pixel sizes) over every level's candidates by
    descending score, the boxes of class c shifted by 10000 c so that no
    two classes overlap, with no top-k cut; the kept ones by score, then
    keep_top_k rows an image (label, score, x1, y1, x2, y2), label -1,
    score 0 and box 0 padding; LoD [keep_top_k * i]. Batched over the
    images: the IoU-above-threshold mask [N, K, K] once, then K - 1
    greedy steps of 4 kernels each (K the candidates an image, up to
    5 levels x nms_top_k)."""
    deltas, scores = ctx.inputs("BBoxes"), ctx.inputs("Scores")
    anchors_l, im_info = ctx.inputs("Anchors"), ctx.input("ImInfo")
    thr = ctx.attr("score_threshold", 0.05)
    nms_top_k = ctx.attr("nms_top_k", 1000)
    keep_top_k = ctx.attr("keep_top_k", 100)
    n, c = scores[0].shape[0], scores[0].shape[2]
    hgt = (im_info[:, 0] / im_info[:, 2])[:, None]
    wdt = (im_info[:, 1] / im_info[:, 2])[:, None]
    zero = im_info.new_zeros(())
    boxes, cs, cl = [], [], []
    for d, s, a in zip(deltas, scores, anchors_l):
        a = a.reshape(-1, 4)
        k = min(nms_top_k, s.shape[1])
        vals, top = torch.sort(s.reshape(n, -1), dim=1, descending=True,
                               stable=True)
        vals, top = vals[:, :k], top[:, :k]
        mi, ci = top // c, top % c
        aa = a.index_select(0, mi.reshape(-1)).reshape(n, k, 4)
        dd = torch.gather(d, 1, mi[..., None].expand(n, k, 4))
        aw = aa[..., 2] - aa[..., 0] + 1.0
        ah = aa[..., 3] - aa[..., 1] + 1.0
        acx = aa[..., 0] + aw / 2
        acy = aa[..., 1] + ah / 2
        cx = dd[..., 0] * aw + acx
        cy = dd[..., 1] * ah + acy
        w = torch.exp(torch.clamp_max(dd[..., 2], 4.135)) * aw
        h = torch.exp(torch.clamp_max(dd[..., 3], 4.135)) * ah
        boxes.append(torch.stack([
            _clip(cx - w / 2, zero, wdt - 1), _clip(cy - h / 2, zero, hgt - 1),
            _clip(cx + w / 2 - 1, zero, wdt - 1),
            _clip(cy + h / 2 - 1, zero, hgt - 1)], dim=-1))
        cs.append(torch.where(vals > thr, vals, vals.new_full((), -1.0)))
        cl.append(ci)
    cb, cs, cl = torch.cat(boxes, 1), torch.cat(cs, 1), torch.cat(cl, 1)
    kt = cs.shape[1]
    if keep_top_k > kt:
        raise ValueError(
            f"retinanet_detection_output: keep_top_k {keep_top_k} exceeds "
            f"the {kt} candidates an image, so the static contract of "
            f"keep_top_k rows an image cannot hold")
    s_sorted, order = torch.sort(cs, dim=1, descending=True, stable=True)
    shifted = cb + cl.to(cb.dtype)[..., None] * 10000.0
    cand = torch.gather(shifted, 1, order[..., None].expand(n, kt, 4))
    keep = torch.ones((n, kt), dtype=torch.bool, device=cb.device)
    if ctx.device.type != "meta":
        over = _pairwise_iou(cand, cand, normalized=False) > float(
            np.float32(ctx.attr("nms_threshold", 0.3)))
        _greedy_keep(over, keep)
    # s_sorted descends, so the stable sort in _top_rows keeps the kept
    # candidates in this order
    ctx.set_output("Out", _top_rows(
        torch.where(keep & (s_sorted > 0), s_sorted,
                    s_sorted.new_full((), -1.0)),
        torch.gather(cl, 1, order),
        torch.gather(cb, 1, order[..., None].expand(n, kt, 4)), keep_top_k))
    ctx.set_lod("Out", [[keep_top_k * i for i in range(n + 1)]])
