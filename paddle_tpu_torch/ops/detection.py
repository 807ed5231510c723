"""The detection ops (counterpart of paddle_tpu/ops/detection.py): SSD's
prior_box, iou_similarity, box_coder, bipartite_match, target_assign,
mine_hard_examples, multiclass_nms and detection_map; and the
one-stage detectors' yolov3_loss, yolo_box, anchor_generator,
density_prior_box, sigmoid_focal_loss, retinanet_target_assign,
retinanet_detection_output, box_clip, box_decoder_and_assign and
polygon_box_transform; and the two-stage detectors' roi_align, roi_pool,
psroi_pool, roi_perspective_transform, generate_proposals,
rpn_target_assign, generate_proposal_labels, generate_mask_labels,
distribute_fpn_proposals and collect_fpn_proposals.

Every op but detection_map is shape-static for a LoD, so a block that
holds them is captured as one CUDA graph. The JAX lowerings unroll over
the LoD segments (one image each) and yolov3_loss loops over the boxes;
these run batched over the images and the boxes: each image's rows are
padded to the batch's largest count, through index and mask tensors
made from the LoD offsets by ExecContext.host_table (once a plan: no
host copy under capture), and each greedy loop runs once for the batch,
over [N, G_max, M] (bipartite_match), [N, C-1, K] (multiclass_nms) and
[N, K] (retinanet_detection_output, generate_proposals). The sampling
of rpn_target_assign and generate_proposal_labels draws from the op's
generator (ExecContext.generator: a captured step draws what an eager
one draws). The RoI ops gather their samples from a channels-last view
of the map, so that their gradient is one accumulate of rows. The
priors and anchors are host-table constants. The results equal the JAX
lowerings', ties included: argmax takes the first maximum and every
sort is stable, as jnp.argsort of the negated scores is. On the meta
device (build-time shape inference, the engine's capture rule) the
loops are skipped: they change no shape.

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


def _encode(a, g):
    """The (+1 sizes) centre-size offsets of boxes g against boxes a,
    [..., 4]: dx, dy over a's size, log size ratios."""
    aw = a[..., 2] - a[..., 0] + 1.0
    ah = a[..., 3] - a[..., 1] + 1.0
    acx = a[..., 0] + aw / 2
    acy = a[..., 1] + ah / 2
    gw = g[..., 2] - g[..., 0] + 1.0
    gh = g[..., 3] - g[..., 1] + 1.0
    gcx = (g[..., 2] + g[..., 0]) / 2
    gcy = (g[..., 3] + g[..., 1]) / 2
    return [(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw),
            torch.log(gh / ah)]


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
    tb = torch.stack(_encode(anchors, g), dim=-1)
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


# ---------------------------------------------------------------------------
# two-stage detectors: RoI feature extraction
# ---------------------------------------------------------------------------

def _roi_images(ctx, n_rois):
    """[R] int64: each RoI's image, its LoD segment's number (image 0
    for all of them without a LoD, as the JAX lowerings read RoIs)."""
    return _row_images(ctx, "roi_images",
                       _segments(ctx.get_lod("ROIs"), n_rois), n_rois)


def _bilinear(rows, h, w, bid, ys, xs):
    """Bilinear samples of a map at (ys, xs) [R, ...] of image bid [R]
    (the JAX _bilinear_sample: corners clipped into the map, weights
    clipped to [0, 1]): [R, ..., C]. `rows` is the map [N, C, h, w] as
    channels-last rows [N*h*w, C]: each of the four taps fetches C
    contiguous values a sample (index_select), so its gradient is one
    accumulate of rows, deterministic in torch's deterministic mode; the
    temporaries are [R, ..., C]."""
    c = rows.shape[1]
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    ly = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
    lx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
    base = bid.reshape((-1,) + (1,) * (ys.dim() - 1)) * (h * w)

    def tap(yy, xx):
        # clamped again as integers: a NaN coordinate reads row 0 (as
        # jnp's clamped gather reads a row) rather than out of range
        idx = (base + yy.long().clamp(0, h - 1) * w +
               xx.long().clamp(0, w - 1)).reshape(-1)
        return rows.index_select(0, idx).reshape(ys.shape + (c,))

    out = tap(y0, x0) * ((1 - ly) * (1 - lx))
    out = out + tap(y0, x1) * ((1 - ly) * lx)
    out = out + tap(y1, x0) * (ly * (1 - lx))
    return out + tap(y1, x1) * (ly * lx)


def _channels_last(x):
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c)


# roi_align's samples are gathered for as many RoIs at a time as keep a
# temporary [RoIs, samples, C] within this many elements (1 GiB of
# float32): Faster R-CNN's 2 x 512 RoIs of 28 x 28 samples of 1024
# channels take four rounds, not 3.3 GB temporaries
_SAMPLES_AT_ONCE = 1 << 28


@register_op("roi_align", no_grad_slots=("ROIs",))
def roi_align(ctx):
    """Out [R, C, ph, pw]: each RoI (x1, y1, x2, y2 of ROIs [R, 4], times
    spatial_scale; its image the LoD segment) cut into ph x pw bins of
    its size (at least 1), each bin the mean of sr x sr bilinear samples
    at the centres of its sub-cells, sr = sampling_ratio or 2 where that
    is at most 0 (the JAX rule: the reference adapts the count to the
    RoI). The gradient reaches X only. The samples are taken for a block
    of RoIs at a time (_SAMPLES_AT_ONCE) and pooled before the next."""
    x, rois = ctx.input("X"), ctx.input("ROIs")
    ph, pw = ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1)
    sr = ctx.attr("sampling_ratio", -1)
    sr = sr if sr > 0 else 2
    r, c, h, w = rois.shape[0], x.shape[1], x.shape[2], x.shape[3]
    box = rois * ctx.attr("spatial_scale", 1.0)
    x1, y1, x2, y2 = box.unbind(1)
    bin_w = torch.clamp_min(x2 - x1, 1.0) / pw
    bin_h = torch.clamp_min(y2 - y1, 1.0) / ph
    iy = (torch.arange(ph * sr, dtype=x.dtype, device=x.device) + 0.5) / sr
    ix = (torch.arange(pw * sr, dtype=x.dtype, device=x.device) + 0.5) / sr
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]          # [R, ph sr]
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]          # [R, pw sr]
    rows, bid = _channels_last(x), _roi_images(ctx, r)
    step = max(1, _SAMPLES_AT_ONCE // (ph * sr * pw * sr * c))
    pooled = []
    for i in range(0, r, step):
        k = min(step, r - i)
        shape = (k, ph * sr, pw * sr)
        s = _bilinear(rows, h, w, bid[i:i + k],
                      ys[i:i + k, :, None].expand(shape),
                      xs[i:i + k, None, :].expand(shape))
        pooled.append(s.reshape(k, ph, sr, pw, sr, c).mean(dim=(2, 4)))
    out = pooled[0] if len(pooled) == 1 else torch.cat(pooled)
    ctx.set_output("Out", out.permute(0, 3, 1, 2))


def _bin_masks(start, size, bins, n, dtype):
    """[R, bins, n] bool: cell j of the map lies in bin p of each RoI,
    floor(start + p size) <= j < ceil(start + (p + 1) size) (the JAX
    lowerings' integer bins; start and size [R])."""
    dev = start.device
    grid = torch.arange(n, dtype=dtype, device=dev)[None, None, :]
    p = torch.arange(bins, dtype=dtype, device=dev)[None, :, None]
    s, z = start[:, None, None], size[:, None, None]
    return (torch.floor(s + p * z) <= grid) & \
        (grid < torch.ceil(s + (p + 1) * z))


@register_op("roi_pool", no_grad_slots=("ROIs",))
def roi_pool(ctx):
    """Out [R, C, ph, pw]: the max over each integer bin of each RoI
    (corners times spatial_scale, rounded half to even; size + 1, at
    least 1), 0 for an empty bin. The gradient reaches X, split evenly
    over a bin's tied maxima (one amax over the whole bin, as jnp.max
    over both axes splits it). Argmax [R, C, ph, pw] int64: the flat h *
    W + w index of each bin's first maximum in row-major order, -1 for
    an empty bin (the reference's; the JAX lowering writes zeros). The
    bins are masks over the whole map, [R, C, ph, pw, H, W] as in the
    JAX lowering: a size for tests and sweeps, not a full-width head."""
    x, rois = ctx.input("X"), ctx.input("ROIs")
    ph, pw = ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1)
    _, c, h, w = x.shape
    r = rois.shape[0]
    x1, y1, x2, y2 = torch.round(rois * ctx.attr("spatial_scale",
                                                 1.0)).unbind(1)
    bin_w = torch.clamp_min(x2 - x1 + 1, 1.0) / pw
    bin_h = torch.clamp_min(y2 - y1 + 1, 1.0) / ph
    m = _bin_masks(y1, bin_h, ph, h, x.dtype)[:, :, None, :, None] & \
        _bin_masks(x1, bin_w, pw, w, x.dtype)[:, None, :, None, :]
    feat = x.index_select(0, _roi_images(ctx, r))
    masked = torch.where(m[:, None], feat[:, :, None, None],
                         x.new_full((), float("-inf"))).reshape(
                             r, c, ph, pw, h * w)
    out = torch.amax(masked, dim=-1)
    ctx.set_output("Out", torch.where(torch.isfinite(out), out,
                                      x.new_zeros(())))
    empty = ~torch.any(m.reshape(r, 1, ph, pw, h * w), dim=-1)
    ctx.set_output("Argmax", torch.where(
        empty, -1, torch.argmax(masked.detach(), dim=-1)))


@register_op("psroi_pool", no_grad_slots=("ROIs",))
def psroi_pool(ctx):
    """Out [R, output_channels, ph, pw]: position-sensitive pooling, bin
    (i, j) of channel c the mean of input channel c ph pw + i pw + j over
    the bin's integer cells (corners rounded, then times spatial_scale,
    the far corner + 1; size at least 0.1; an empty bin 0). The gradient
    reaches X."""
    x, rois = ctx.input("X"), ctx.input("ROIs")
    oc = ctx.attr("output_channels")
    ph, pw = ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1)
    scale = ctx.attr("spatial_scale", 1.0)
    _, _, h, w = x.shape
    r = rois.shape[0]
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = torch.round(rois[:, 2] + 1.0) * scale
    y2 = torch.round(rois[:, 3] + 1.0) * scale
    bin_w = torch.clamp_min(x2 - x1, 0.1) / pw
    bin_h = torch.clamp_min(y2 - y1, 0.1) / ph
    m = _bin_masks(y1, bin_h, ph, h, x.dtype)[:, :, None, :, None] & \
        _bin_masks(x1, bin_w, pw, w, x.dtype)[:, None, :, None, :]
    feat = x.index_select(0, _roi_images(ctx, r)).reshape(r, oc, ph, pw,
                                                          h, w)
    cnt = torch.clamp_min(torch.sum(m, dim=(3, 4)), 1)       # [R, ph, pw]
    s = torch.sum(torch.where(m[:, None], feat, x.new_zeros(())),
                  dim=(4, 5))
    ctx.set_output("Out", s / cnt[:, None])


@register_op("roi_perspective_transform", no_grad_slots=("ROIs",))
def roi_perspective_transform(ctx):
    """Out [R, C, transformed_height, transformed_width]: each quad RoI
    (ROIs [R, 8], four (x, y) corners times spatial_scale) sampled
    bilinearly at the grid of the JAX lowering: the point at (u, v) =
    ((j + 0.5) / out_w, (i + 0.5) / out_h) interpolated bilinearly
    between the corners (top edge 0 -> 1, bottom edge 3 -> 2). The
    gradient reaches X."""
    x, rois = ctx.input("X"), ctx.input("ROIs")
    oh = ctx.attr("transformed_height", 1)
    ow = ctx.attr("transformed_width", 1)
    r = rois.shape[0]
    q = (rois.reshape(r, 4, 2) * ctx.attr("spatial_scale", 1.0))[
        :, :, None, None, :]                                 # [R, 4, 1, 1, 2]
    u = (torch.arange(ow, dtype=x.dtype, device=x.device) + 0.5) / ow
    v = (torch.arange(oh, dtype=x.dtype, device=x.device) + 0.5) / oh
    ug = u[None, :, None].expand(oh, ow, 1)
    vg = v[:, None, None].expand(oh, ow, 1)
    top = q[:, 0] * (1 - ug) + q[:, 1] * ug                  # [R, oh, ow, 2]
    bot = q[:, 3] * (1 - ug) + q[:, 2] * ug
    pts = top * (1 - vg) + bot * vg
    s = _bilinear(_channels_last(x), x.shape[2], x.shape[3],
                  _roi_images(ctx, r), pts[..., 1], pts[..., 0])
    ctx.set_output("Out", s.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# two-stage detectors: proposals and their targets
# ---------------------------------------------------------------------------

def _over_rows(b, thr, normalized, rows=2048):
    """[..., K, K] bool: the IoU of candidates b [..., K, 4] (sorted)
    above row i's threshold thr[i], made in blocks of `rows` rows so that
    the float temporaries stay [..., rows, K]."""
    k = b.shape[-2]
    return torch.cat([_pairwise_iou(b[..., i:i + rows, :], b, normalized)
                      > thr[i:i + rows, None] for i in range(0, k, rows)],
                     dim=-2)


def _sample(mask, count, gen):
    """[N, count] int64: the first min(count, sum) entries of each row
    of `mask` [N, M] in index order (JAX's stable argsort of the negated
    mask), or with `gen` in the order of the mask times 1 + a uniform
    draw; -1 after them."""
    score = mask.to(torch.float32)
    if gen is not None:
        score = score * (1 + torch.rand(mask.shape, generator=gen,
                                        device=mask.device))
    order = torch.sort(score, dim=1, descending=True, stable=True)[1][
        :, :count]
    got = torch.arange(count, device=mask.device)[None, :] < \
        torch.sum(mask, dim=1, keepdim=True)
    return torch.where(got, order, -1)


def _generator(ctx):
    """The op's generator where use_random draws (None on the meta
    device, where nothing is drawn)."""
    return ctx.generator() if ctx.attr("use_random", True) else None


@register_no_grad_op("generate_proposals")
def generate_proposals(ctx):
    """RPN proposals of each image: its A x H x W Scores (sorted by
    descending score, stable) cut to pre_nms_topN (all where it is at
    most 0), decoded against Anchors [H, W, A, 4] and Variances (log
    sizes capped at log(1000 / 16)), clipped to ImInfo's (h, w); a box
    under min_size * scale a side scores -1; a greedy NMS (IoU above the
    step's threshold: nms_thresh, times eta after each step while above
    0.5) with no top-k cut over them by descending score; the kept ones
    with a positive score, in that order. RpnRois [N * post_nms_topN, 4]
    and RpnRoiProbs [N * post_nms_topN, 1], zero-padded, LoD
    [post_nms_topN * i]. Batched: the IoU-above-threshold mask [N, K, K]
    made in row blocks, then K - 1 greedy steps of 4 kernels each."""
    scores, deltas = ctx.input("Scores"), ctx.input("BboxDeltas")
    im_info = ctx.input("ImInfo")
    anc = ctx.input("Anchors").reshape(-1, 4)
    var = ctx.input("Variances").reshape(-1, 4)
    pre, post = ctx.attr("pre_nms_topN", 6000), ctx.attr("post_nms_topN",
                                                          1000)
    eta = ctx.attr("eta", 1.0)
    n, a, h, w = scores.shape
    m = a * h * w
    k = min(pre, m) if pre > 0 else m
    if post > k:
        raise ValueError(
            f"generate_proposals: post_nms_topN {post} exceeds the {k} "
            f"candidates an image, so the static contract of "
            f"post_nms_topN rows an image cannot hold")
    s = scores.permute(0, 2, 3, 1).reshape(n, m)
    d = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(n, m, 4)
    s_t, top = torch.sort(s, dim=1, descending=True, stable=True)
    s_t, top = s_t[:, :k], top[:, :k]
    d_t = torch.gather(d, 1, top[..., None].expand(n, k, 4))
    a_t = anc.index_select(0, top.reshape(-1)).reshape(n, k, 4)
    v_t = var.index_select(0, top.reshape(-1)).reshape(n, k, 4)
    aw = a_t[..., 2] - a_t[..., 0] + 1.0
    ah = a_t[..., 3] - a_t[..., 1] + 1.0
    acx = a_t[..., 0] + aw / 2
    acy = a_t[..., 1] + ah / 2
    cx = v_t[..., 0] * d_t[..., 0] * aw + acx
    cy = v_t[..., 1] * d_t[..., 1] * ah + acy
    cap = math.log(1000.0 / 16)
    bw = torch.exp(torch.clamp_max(v_t[..., 2] * d_t[..., 2], cap)) * aw
    bh = torch.exp(torch.clamp_max(v_t[..., 3] * d_t[..., 3], cap)) * ah
    zero = scores.new_zeros(())
    wmax = (im_info[:n, 1] - 1)[:, None]
    hmax = (im_info[:n, 0] - 1)[:, None]
    props = torch.stack([
        _clip(cx - bw / 2, zero, wmax), _clip(cy - bh / 2, zero, hmax),
        _clip(cx + bw / 2 - 1, zero, wmax),
        _clip(cy + bh / 2 - 1, zero, hmax)], dim=-1)         # [N, K, 4]
    ms = (ctx.attr("min_size", 0.1) * im_info[:n, 2])[:, None]
    big = ((props[..., 2] - props[..., 0] + 1) >= ms) & \
        ((props[..., 3] - props[..., 1] + 1) >= ms)
    s_t = torch.where(big, s_t, scores.new_full((), -1.0))
    s_sorted, order = torch.sort(s_t, dim=1, descending=True, stable=True)
    cand = torch.gather(props, 1, order[..., None].expand(n, k, 4))
    keep = torch.ones((n, k), dtype=torch.bool, device=scores.device)
    if ctx.device.type != "meta":
        nms = ctx.attr("nms_thresh", 0.5)
        thr = ctx.host_table("nms_thresholds", (k, nms, eta),
                             lambda: _nms_thresholds(k, nms, eta))
        _greedy_keep(_over_rows(cand, thr, False), keep)
    valid = keep & (s_sorted > 0)
    perm = torch.sort(valid.to(torch.uint8), dim=1, descending=True,
                      stable=True)[1][:, :post]
    sel = torch.gather(order, 1, perm)
    ok = torch.gather(valid, 1, perm)
    rois = torch.gather(props, 1, sel[..., None].expand(n, post, 4)) * \
        ok[..., None]
    probs = torch.where(ok, torch.gather(s_t, 1, sel), zero)
    lod = [[post * i for i in range(n + 1)]]
    ctx.set_output("RpnRois", rois.reshape(n * post, 4))
    ctx.set_output("RpnRoiProbs", probs.reshape(n * post, 1))
    ctx.set_lod("RpnRois", lod)
    ctx.set_lod("RpnRoiProbs", lod)


@register_no_grad_op("rpn_target_assign")
def rpn_target_assign(ctx):
    """RPN training targets of the M anchors (Anchor, pixel boxes) of
    each image against its GtBoxes (a LoD segment an image, IsCrowd's
    crowd boxes and the padding of the batch's other images at IoU 0):
    an anchor inside the image (rpn_straddle_thresh) is positive at IoU
    >= rpn_positive_overlap with its best box or where it is a non-crowd
    box's best inside anchor (the first on a tie; where two boxes pick
    one anchor it is positive if either is not a crowd box: the JAX
    lowering's duplicate writes leave that to the order of its scatter),
    negative below rpn_negative_overlap; then n_fg = int(batch *
    fg_fraction) positives and batch - n_fg negatives sampled (the first
    in anchor order, or with use_random a draw from the op's generator).
    LocationIndex [N * n_fg, 1] and ScoreIndex [N * batch, 1] int32
    (the row b * M + m of a sampled anchor, positives first; -1
    padding), TargetLabel [N * batch, 1] int32 (1, 0, -1 padding),
    TargetBBox and BBoxInsideWeight [N * n_fg, 4] (the best box encoded
    against the anchor; 0 on padding)."""
    anchors = ctx.input("Anchor").reshape(-1, 4)
    gt, crowd, im_info = (ctx.input("GtBoxes"), ctx.input("IsCrowd"),
                          ctx.input("ImInfo"))
    batch = ctx.attr("rpn_batch_size_per_im", 256)
    straddle = ctx.attr("rpn_straddle_thresh", 0.0)
    m, dev = anchors.shape[0], anchors.device
    n_fg = int(batch * ctx.attr("rpn_fg_fraction", 0.5))
    n_bg = batch - n_fg
    if max(n_fg, n_bg) > m:
        raise ValueError(f"rpn_target_assign: {max(n_fg, n_bg)} samples of "
                         f"{m} anchors")
    segs = _segments(ctx.get_lod("GtBoxes"), gt.shape[0])
    n = len(segs)
    idx, valid = _padded_rows(ctx, "rpn_gt", segs)           # [N, G]
    gtp = gt[idx]
    live = valid if crowd is None else \
        valid & (crowd.reshape(-1)[idx] == 0)
    info = im_info[:n]
    inside = (anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle) & \
        (anchors[:, 2] < info[:, 1:2] + straddle) & \
        (anchors[:, 3] < info[:, 0:1] + straddle)            # [N, M]
    iou = torch.where(live[:, None, :],
                      _pairwise_iou(anchors[None], gtp, normalized=False),
                      anchors.new_zeros(()))                 # [N, M, G]
    best, best_gt = torch.amax(iou, dim=2), torch.argmax(iou, dim=2)
    per_gt = torch.argmax(torch.where(inside[..., None], iou,
                                      anchors.new_full((), -1.0)), dim=1)
    forced = torch.zeros((n, m + 1), dtype=torch.bool, device=dev).scatter(
        1, torch.where(live, per_gt, m),
        torch.ones(live.shape, dtype=torch.bool, device=dev))[:, :m]
    is_pos = ((best >= ctx.attr("rpn_positive_overlap", 0.7)) & inside) | \
        forced
    is_neg = (best < ctx.attr("rpn_negative_overlap", 0.3)) & inside & \
        ~is_pos
    gen = _generator(ctx)
    fg = _sample(is_pos, n_fg, gen)
    bg = _sample(is_neg, n_bg, gen)
    off = torch.arange(n, device=dev)[:, None] * m
    i32 = torch.int32
    safe = torch.clamp_min(fg, 0)
    a_t = anchors.index_select(0, safe.reshape(-1)).reshape(n, n_fg, 4)
    g_t = torch.gather(gtp, 1, torch.gather(best_gt, 1, safe)[..., None]
                       .expand(n, n_fg, 4))
    got = (fg >= 0)[..., None]
    both = torch.cat([fg, bg], dim=1)
    ctx.set_output("LocationIndex", torch.where(fg >= 0, fg + off, -1)
                   .to(i32).reshape(-1, 1))
    ctx.set_output("ScoreIndex", torch.where(both >= 0, both + off, -1)
                   .to(i32).reshape(-1, 1))
    ctx.set_output("TargetLabel", torch.cat([
        torch.where(fg >= 0, 1, -1), torch.where(bg >= 0, 0, -1)], dim=1)
        .to(i32).reshape(-1, 1))
    ctx.set_output("TargetBBox", (torch.stack(_encode(a_t, g_t), dim=-1)
                                  * got).reshape(-1, 4))
    ctx.set_output("BBoxInsideWeight", got.to(torch.float32).expand(
        n, n_fg, 4).reshape(-1, 4))


@register_no_grad_op("generate_proposal_labels")
def generate_proposal_labels(ctx):
    """Fast R-CNN head targets: each image's candidates are its RpnRois
    (LoD segment) divided by ImInfo's scale, then its GtBoxes; each
    takes its best non-crowd box (IoU 0 with crowd boxes); foreground at
    IoU >= fg_thresh, background in [bg_thresh_lo, bg_thresh_hi); n_fg =
    int(batch_size_per_im * fg_fraction) foreground and the rest
    background sampled as rpn_target_assign samples. Rois [N * batch, 4]
    (0 on padding), LabelsInt32 [N * batch, 1] (the box's class, 0
    background, -1 padding), BboxTargets [N * batch, 4 * class_nums]
    (the box encoded against the RoI over bbox_reg_weights, in its
    class's four columns), BboxInsideWeights (1 where a target is not
    0) and BboxOutsideWeights; LoD [batch * i]. Batched: the RoIs and
    boxes padded to the batch's largest counts (never sampled). An image
    with fewer candidates than n_fg or than the background count has no
    such static contract in the JAX lowering: refused."""
    rois, gt_classes = ctx.input("RpnRois"), ctx.input("GtClasses")
    crowd, gt, im_info = (ctx.input("IsCrowd"), ctx.input("GtBoxes"),
                          ctx.input("ImInfo"))
    batch = ctx.attr("batch_size_per_im", 256)
    classes = ctx.attr("class_nums", 81)
    n_fg = int(batch * ctx.attr("fg_fraction", 0.25))
    n_bg = batch - n_fg
    rsegs = _segments(ctx.get_lod("RpnRois"), rois.shape[0])
    gsegs = _segments(ctx.get_lod("GtBoxes"), gt.shape[0])
    n = min(len(rsegs), len(gsegs))
    rsegs, gsegs = rsegs[:n], gsegs[:n]
    for b, ((rs, re), (gs, ge)) in enumerate(zip(rsegs, gsegs)):
        if re - rs + ge - gs < max(n_fg, n_bg):
            raise ValueError(
                f"generate_proposal_labels: image {b} has {re - rs} RoIs "
                f"and {ge - gs} boxes, fewer than the {max(n_fg, n_bg)} "
                f"samples of batch_size_per_im {batch}")
    ridx, rvalid = _padded_rows(ctx, "proposal_rois", rsegs)
    gidx, gvalid = _padded_rows(ctx, "proposal_gts", gsegs)
    dev = rois.device
    gtp = gt[gidx]                                           # [N, G, 4]
    cand = torch.cat([rois[ridx] / im_info[:n, 2][:, None, None], gtp],
                     dim=1)                                  # [N, R+G, 4]
    cvalid = torch.cat([rvalid, gvalid], dim=1)
    live = gvalid if crowd is None else \
        gvalid & (crowd.reshape(-1)[gidx] == 0)
    iou = torch.where(live[:, None, :],
                      _pairwise_iou(cand, gtp, normalized=False),
                      rois.new_zeros(()))
    best, best_gt = torch.amax(iou, dim=2), torch.argmax(iou, dim=2)
    is_fg = (best >= ctx.attr("fg_thresh", 0.5)) & cvalid
    is_bg = (best < ctx.attr("bg_thresh_hi", 0.5)) & \
        (best >= ctx.attr("bg_thresh_lo", 0.0)) & cvalid
    gen = _generator(ctx)
    sel = torch.cat([_sample(is_fg, n_fg, gen), _sample(is_bg, n_bg, gen)],
                    dim=1)                                   # [N, batch]
    got = sel >= 0
    safe = torch.clamp_min(sel, 0)
    sel_rois = torch.gather(cand, 1, safe[..., None].expand(n, batch, 4)) \
        * got[..., None]
    fg_row = (torch.arange(batch, device=dev) < n_fg)[None, :] & got
    g_of = torch.gather(best_gt, 1, safe)
    cls = torch.gather(gt_classes.reshape(-1)[gidx], 1, g_of)
    label = torch.where(got, torch.where(fg_row, cls, 0), -1).to(torch.int32)
    wts = tuple(float(v) for v in ctx.attr("bbox_reg_weights",
                                           [0.1, 0.1, 0.2, 0.2]))
    wt = ctx.host_table("bbox_reg_weights", wts,
                        lambda: np.asarray(wts, np.float32)).to(rois.dtype)
    g = torch.gather(gtp, 1, g_of[..., None].expand(n, batch, 4))
    t = torch.stack([e / wt[i] for i, e in
                     enumerate(_encode(sel_rois, g))], dim=-1)
    col = torch.clamp(label.long(), 0, classes - 1)
    slot = (col[..., None] == torch.arange(classes, device=dev)) & \
        fg_row[..., None]                                    # [N, batch, C]
    tgt = torch.where(slot[..., None], t[:, :, None, :], rois.new_zeros(())
                      ).reshape(n * batch, 4 * classes)
    w_in = (tgt != 0).to(torch.float32)
    lod = [[batch * i for i in range(n + 1)]]
    for name, v in (("Rois", sel_rois.reshape(-1, 4)),
                    ("LabelsInt32", label.reshape(-1, 1)),
                    ("BboxTargets", tgt), ("BboxInsideWeights", w_in),
                    ("BboxOutsideWeights", (w_in > 0).to(torch.float32))):
        ctx.set_output(name, v)
        ctx.set_lod(name, lod)


@register_no_grad_op("generate_mask_labels")
def generate_mask_labels(ctx):
    """Mask head targets: each RoI (Rois, a LoD segment an image) takes
    the GtSegms box (box-encoded masks, a LoD segment an image) of its
    own image with the best IoU (the first on a tie), and MaskInt32 [R,
    num_classes * res * res] int32 holds, in its label's res x res
    columns, 1 at the sub-cell centres of the RoI inside that box (all 0
    for a background RoI); MaskRois is Rois, RoiHasMaskInt32 [R, 1] its
    label > 0. The JAX lowering matches every RoI against every image's
    boxes: equal at one image. Without a LoD on either, or with unequal
    segment counts, every RoI matches against every box, as there."""
    rois, segms = ctx.input("Rois"), ctx.input("GtSegms").reshape(-1, 4)
    lab = ctx.input("LabelsInt32").reshape(-1)
    classes = ctx.attr("num_classes", 81)
    res = ctx.attr("resolution", 14)
    r, dev = rois.shape[0], rois.device
    rsegs = _segments(ctx.get_lod("Rois"), r)
    ssegs = _segments(ctx.get_lod("GtSegms"), segms.shape[0])
    if len(rsegs) != len(ssegs):
        rsegs, ssegs = [(0, r)], [(0, segms.shape[0])]
    sidx, svalid = _padded_rows(ctx, "mask_segms", ssegs)    # [N, S]
    img = _row_images(ctx, "mask_rois", rsegs, r)
    own = sidx.index_select(0, img)                          # [R, S]
    cand = segms[own]                                        # [R, S, 4]
    iou = torch.where(svalid.index_select(0, img),
                      _pairwise_iou(rois[:, None, :], cand,
                                    normalized=False)[:, 0],
                      rois.new_full((), -1.0))
    g = torch.gather(cand, 1, torch.argmax(iou, dim=1)[:, None, None]
                     .expand(r, 1, 4))[:, 0]                 # [R, 4]
    grid = torch.arange(res, dtype=rois.dtype, device=dev)
    rw = torch.clamp_min(rois[:, 2] - rois[:, 0], 1.0)
    rh = torch.clamp_min(rois[:, 3] - rois[:, 1], 1.0)
    gx = rois[:, 0:1] + (grid + 0.5) / res * rw[:, None]     # [R, res]
    gy = rois[:, 1:2] + (grid + 0.5) / res * rh[:, None]
    inside = ((gx[:, None, :] >= g[:, 0, None, None]) &
              (gx[:, None, :] <= g[:, 2, None, None]) &
              (gy[:, :, None] >= g[:, 1, None, None]) &
              (gy[:, :, None] <= g[:, 3, None, None]))       # [R, res, res]
    flat = (inside & (lab > 0)[:, None, None]).reshape(r, 1, res * res)
    col = torch.clamp(lab.long(), 0, classes - 1)
    slot = col[:, None] == torch.arange(classes, device=dev)  # [R, C]
    ctx.set_output("MaskRois", rois)
    ctx.set_output("RoiHasMaskInt32", (lab > 0).to(torch.int32)
                   .reshape(-1, 1))
    ctx.set_output("MaskInt32", (slot[..., None] & flat).to(torch.int32)
                   .reshape(r, classes * res * res))


# ---------------------------------------------------------------------------
# two-stage detectors: FPN routing
# ---------------------------------------------------------------------------

@register_no_grad_op("distribute_fpn_proposals")
def distribute_fpn_proposals(ctx):
    """FpnRois [R, 4] routed to the levels min_level..max_level by
    floor(log2(sqrt(max(w h, 1e-6)) / refer_scale + 1e-6)) + refer_level
    (w and h with no +1), clipped. Each of MultiFpnRois is [R, 4]: the
    level's rows first in their order, then zero rows; RestoreIndex [L
    * R, 1] int32 the original row of each emitted row, -1 on padding
    (the JAX package's static contract: no LoD)."""
    rois = ctx.input("FpnRois")
    lo, hi = ctx.attr("min_level", 2), ctx.attr("max_level", 5)
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = torch.sqrt(torch.clamp_min(w * h, 1e-6))
    lvl = torch.floor(torch.log2(scale / ctx.attr("refer_scale", 224) +
                                 1e-6)) + ctx.attr("refer_level", 4)
    lvl = torch.clamp(lvl, lo, hi).to(torch.int32)
    outs, restore = [], []
    for level in range(lo, hi + 1):
        on = lvl == level
        perm = torch.sort(on.to(torch.uint8), descending=True,
                          stable=True)[1]
        kept = on[perm]
        outs.append(rois[perm] * kept[:, None])
        restore.append(torch.where(kept, perm, -1))
    ctx.set_outputs("MultiFpnRois", outs)
    ctx.set_output("RestoreIndex", torch.cat(restore).to(torch.int32)
                   .reshape(-1, 1))


@register_no_grad_op("collect_fpn_proposals")
def collect_fpn_proposals(ctx):
    """FpnRois: the post_nms_topN rows (all, where fewer) of the levels'
    MultiLevelRois by descending MultiLevelScores, stable on ties, one
    top-k over the whole batch (the JAX package's: no LoD)."""
    rois = torch.cat(ctx.inputs("MultiLevelRois"), dim=0)
    scores = torch.cat([s.reshape(-1) for s in
                        ctx.inputs("MultiLevelScores")])
    k = min(ctx.attr("post_nms_topN", 1000), scores.shape[0])
    top = torch.sort(scores, descending=True, stable=True)[1][:k]
    ctx.set_output("FpnRois", rois.index_select(0, top))
