"""The detection layers (counterpart of paddle_tpu/layers/detection.py:
SSD's prior_box, iou_similarity, box_coder, bipartite_match,
target_assign, mine_hard_examples, multiclass_nms, detection_output,
ssd_loss, multi_box_head and detection_map; the one-stage detectors'
density_prior_box, anchor_generator, box_clip, polygon_box_transform,
yolov3_loss, yolo_box, sigmoid_focal_loss, retinanet_detection_output,
retinanet_target_assign and box_decoder_and_assign; the two-stage
detectors' rpn_target_assign, generate_proposals,
generate_proposal_labels, generate_mask_labels,
roi_perspective_transform, distribute_fpn_proposals and
collect_fpn_proposals), each with the JAX package's signature and ops.
The composite layers compose the same primitive ops in the same order,
but for two faults of the JAX builders: ssd_loss's mining reshape (one
attr) and detection_output's softmax (one op); see their docstrings."""
from __future__ import annotations

import math

import numpy as np

from .. import framework
from ..layer_helper import LayerHelper
from . import nn as _nn

__all__ = [
    "prior_box", "iou_similarity", "box_coder", "bipartite_match",
    "target_assign", "mine_hard_examples", "multiclass_nms",
    "detection_output", "ssd_loss", "multi_box_head", "detection_map",
    "density_prior_box", "anchor_generator", "box_clip",
    "polygon_box_transform", "yolov3_loss", "yolo_box",
    "sigmoid_focal_loss", "retinanet_detection_output",
    "retinanet_target_assign", "box_decoder_and_assign",
    "rpn_target_assign", "generate_proposals", "generate_proposal_labels",
    "generate_mask_labels", "roi_perspective_transform",
    "distribute_fpn_proposals", "collect_fpn_proposals",
]


def _out(helper, dtype):
    return helper.create_variable_for_type_inference(dtype)


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None, min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes = _out(helper, input.dtype)
    var = _out(helper, input.dtype)
    helper.append_op(
        "prior_box", inputs={"Input": input, "Image": image},
        outputs={"Boxes": boxes, "Variances": var},
        attrs={"min_sizes": [float(s) for s in
                             np.atleast_1d(min_sizes)],
               "max_sizes": [float(s) for s in
                             np.atleast_1d(max_sizes or [])],
               "aspect_ratios": [float(a) for a in aspect_ratios],
               "variances": [float(v) for v in variance],
               "flip": flip, "clip": clip,
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": offset,
               "min_max_aspect_ratios_order":
                   min_max_aspect_ratios_order})
    return boxes, var


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("iou_similarity", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"box_normalized": box_normalized})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """prior_box_var: a Variable (the PriorBoxVar input) or a list of
    four (the `variance` attr)."""
    helper = LayerHelper("box_coder", name=name)
    out = _out(helper, target_box.dtype)
    inputs = {"PriorBox": prior_box, "TargetBox": target_box}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, framework.Variable):
        inputs["PriorBoxVar"] = prior_box_var
    elif isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": out}, attrs=attrs)
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = _out(helper, dist_matrix.dtype)
    helper.append_op(
        "bipartite_match", inputs={"DistMat": dist_matrix},
        outputs={"ColToRowMatchIndices": match_indices,
                 "ColToRowMatchDist": match_dist},
        attrs={"match_type": match_type or "bipartite",
               "dist_threshold": dist_threshold or 0.5})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = _out(helper, input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": input, "MatchIndices": matched_indices}
    if negative_indices is not None:
        inputs["NegIndices"] = negative_indices
    helper.append_op("target_assign", inputs=inputs,
                     outputs={"Out": out, "OutWeight": out_weight},
                     attrs={"mismatch_value": mismatch_value or 0})
    return out, out_weight


def mine_hard_examples(cls_loss, loc_loss, match_indices, match_dist,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=None,
                       name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    neg = helper.create_variable_for_type_inference("int32")
    upd = helper.create_variable_for_type_inference("int32")
    inputs = {"ClsLoss": cls_loss, "MatchIndices": match_indices,
              "MatchDist": match_dist}
    if loc_loss is not None:
        inputs["LocLoss"] = loc_loss
    helper.append_op(
        "mine_hard_examples", inputs=inputs,
        outputs={"NegIndices": neg, "UpdatedMatchIndices": upd},
        attrs={"neg_pos_ratio": neg_pos_ratio,
               "neg_dist_threshold": neg_dist_threshold,
               "mining_type": mining_type,
               "sample_size": sample_size or 0})
    return neg, upd


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = _out(helper, bboxes.dtype)
    helper.append_op(
        "multiclass_nms", inputs={"BBoxes": bboxes, "Scores": scores},
        outputs={"Out": out},
        attrs={"score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold, "normalized": normalized,
               "nms_eta": nms_eta,
               "background_label": background_label})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, nms_eta=1.0):
    """SSD's inference head: loc decoded against the priors, then
    multiclass_nms over the class probabilities, softmax(scores)
    transposed to [N, C, M]. The softmax is the reference's
    (python/paddle/fluid/layers/detection.py detection_output): the JAX
    package's builder leaves it out and runs NMS on the raw scores, so
    its program has one op less and its rows are those of softmaxed
    scores fed to it."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    t_scores = _nn.transpose(_nn.softmax(scores), perm=[0, 2, 1])
    return multiclass_nms(
        decoded, t_scores, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=nms_threshold, normalized=False,
        nms_eta=nms_eta, background_label=background_label)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0,
             neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """SSD's training loss: the priors matched to the ground truth
    (bipartite, then the per-prediction fill), hard negatives mined,
    smooth-l1 localization plus softmax classification a prior, the sum
    normalized by the matched priors' count. location [N, M, 4],
    confidence [N, M, C], gt_box [G, 4] and gt_label [G, 1] LoD tensors
    (one segment an image), prior_box [M, 4].

    The mining loss is reshaped to [-1, M], M the prior count known at
    build time, where the JAX package's builder bakes in the batch it
    sees at build time ([N_build, -1], N_build = 1), which fails at any
    other batch: that reshape2's `shape` attr is the one place where
    this program differs from the JAX package's."""
    from .. import layers as L
    num_priors = int(prior_box.shape[0])
    if num_priors < 0:
        raise ValueError("ssd_loss: the prior count must be known when "
                         "the program is built")
    iou = iou_similarity(gt_box, prior_box)
    matched_indices, matched_dist = bipartite_match(
        iou, match_type, overlap_threshold)
    gt_lbl, _ = target_assign(gt_label, matched_indices,
                              mismatch_value=background_label)
    cls_for_mining = L.softmax_with_cross_entropy(
        confidence, L.cast(gt_lbl, "int64"))
    cls_for_mining = L.reshape(cls_for_mining, [-1, num_priors])
    neg_indices, updated_match = mine_hard_examples(
        cls_for_mining, None, matched_indices, matched_dist,
        neg_pos_ratio, neg_overlap, mining_type, sample_size)
    encoded_gt = box_coder(
        prior_box,
        prior_box_var if prior_box_var is not None
        else [0.1, 0.1, 0.2, 0.2],
        gt_box, code_type="encode_center_size")
    loc_tgt, loc_w = target_assign(encoded_gt, matched_indices,
                                   mismatch_value=0)
    conf_tgt, conf_w = target_assign(
        gt_label, updated_match, negative_indices=neg_indices,
        mismatch_value=background_label)
    loc_loss = L.reduce_sum(
        L.smooth_l1(L.reshape(location, [-1, 4]),
                    L.reshape(loc_tgt, [-1, 4])),
        dim=-1, keep_dim=True)
    loc_loss = L.elementwise_mul(loc_loss, L.reshape(loc_w, [-1, 1]))
    conf_loss = L.softmax_with_cross_entropy(
        confidence, L.cast(conf_tgt, "int64"))
    conf_loss = L.elementwise_mul(L.reshape(conf_loss, [-1, 1]),
                                  L.reshape(conf_w, [-1, 1]))
    loss = L.elementwise_add(
        L.scale(loc_loss, scale=loc_loss_weight),
        L.scale(conf_loss, scale=conf_loss_weight))
    if normalize:
        normalizer = L.elementwise_add(
            L.reduce_sum(loc_w), L.fill_constant([1], "float32", 1e-6))
        loss = L.elementwise_div(loss, normalizer)
    return loss


def multi_box_head(inputs, image, base_size, num_classes,
                   aspect_ratios, min_ratio=None, max_ratio=None,
                   min_sizes=None, max_sizes=None, steps=None,
                   step_w=None, step_h=None, offset=0.5, variance=None,
                   flip=True, clip=False, kernel_size=1, pad=0,
                   stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD's head: on each feature map a conv for the locations (4 a
    prior) and one for the confidences (num_classes a prior), and the
    map's priors; all four concatenated over the maps. Without
    min_sizes, the sizes follow from min_ratio / max_ratio and
    base_size, as in the JAX package."""
    variance = variance or [0.1, 0.1, 0.2, 0.2]
    n = len(inputs)
    if min_sizes is None:
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (n - 2))) \
            if n > 2 else 0
        for ratio in range(min_ratio, max_ratio + 1, step if step else 1):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
            if len(min_sizes) == n - 1:
                break
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        maxs = max_sizes[i] if max_sizes else None
        box, var = prior_box(
            feat, image, np.atleast_1d(min_sizes[i]).tolist(),
            np.atleast_1d(maxs).tolist() if maxs else None,
            list(np.atleast_1d(aspect_ratios[i])), variance, flip, clip,
            (steps[i] if steps else (step_w or 0.0, step_h or 0.0))
            if steps or step_w or step_h else (0.0, 0.0), offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        num_priors = int(np.prod(box.shape[:-1]) //
                         (feat.shape[2] * feat.shape[3]))
        loc = _nn.conv2d(feat, num_priors * 4, kernel_size,
                         padding=pad, stride=stride)
        conf = _nn.conv2d(feat, num_priors * num_classes, kernel_size,
                          padding=pad, stride=stride)
        loc = _nn.transpose(loc, perm=[0, 2, 3, 1])
        conf = _nn.transpose(conf, perm=[0, 2, 3, 1])
        locs.append(_nn.reshape(loc, [0, -1, 4]))
        confs.append(_nn.reshape(conf, [0, -1, num_classes]))
        boxes_all.append(_nn.reshape(box, [-1, 4]))
        vars_all.append(_nn.reshape(var, [-1, 4]))
    return (_nn.concat(locs, axis=1), _nn.concat(confs, axis=1),
            _nn.concat(boxes_all, axis=0), _nn.concat(vars_all, axis=0))


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    helper = LayerHelper("detection_map")

    def _state(st, dtype="float32"):
        return st if st is not None else \
            helper.create_variable_for_type_inference(dtype)

    map_out = helper.create_variable_for_type_inference("float32")
    accum_pos_count = _state(out_states[0] if out_states else None,
                             "int32")
    accum_true_pos = _state(out_states[1] if out_states else None)
    accum_false_pos = _state(out_states[2] if out_states else None)
    inputs = {"Label": label, "DetectRes": detect_res}
    if has_state is not None:
        inputs["HasState"] = has_state
    if input_states is not None:
        inputs["PosCount"] = input_states[0]
        inputs["TruePos"] = input_states[1]
        inputs["FalsePos"] = input_states[2]
    helper.append_op(
        "detection_map", inputs=inputs,
        outputs={"MAP": map_out, "AccumPosCount": accum_pos_count,
                 "AccumTruePos": accum_true_pos,
                 "AccumFalsePos": accum_false_pos},
        attrs={"overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version, "class_num": class_num})
    return map_out


# ---------------------------------------------------------------------------
# one-stage detectors
# ---------------------------------------------------------------------------

def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = _out(helper, input.dtype)
    var = _out(helper, input.dtype)
    helper.append_op(
        "density_prior_box", inputs={"Input": input, "Image": image},
        outputs={"Boxes": boxes, "Variances": var},
        attrs={"densities": [int(d) for d in densities],
               "fixed_sizes": [float(s) for s in fixed_sizes],
               "fixed_ratios": [float(r) for r in fixed_ratios],
               "variances": [float(v) for v in variance],
               "clip": clip, "step_w": float(steps[0]),
               "step_h": float(steps[1]), "offset": offset})
    if flatten_to_2d:
        boxes = _nn.reshape(boxes, [-1, 4])
        var = _nn.reshape(var, [-1, 4])
    return boxes, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None,
                     offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = _out(helper, input.dtype)
    var = _out(helper, input.dtype)
    helper.append_op(
        "anchor_generator", inputs={"Input": input},
        outputs={"Anchors": anchors, "Variances": var},
        attrs={"anchor_sizes": [float(s) for s in anchor_sizes],
               "aspect_ratios": [float(r) for r in aspect_ratios],
               "variances": [float(v) for v in variance],
               "stride": [float(s) for s in stride],
               "offset": offset})
    return anchors, var


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("box_clip",
                     inputs={"Input": input, "ImInfo": im_info},
                     outputs={"Output": out})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("polygon_box_transform", inputs={"Input": input},
                     outputs={"Output": out})
    return out


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """Loss [N] of one YOLOv3 head; gt_score (optional, [N, B]) weights
    each box's terms as the reference does (the op's docstring)."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = _out(helper, x.dtype)
    obj_mask = _out(helper, x.dtype)
    gt_match = helper.create_variable_for_type_inference("int32")
    inputs = {"X": x, "GTBox": gt_box, "GTLabel": gt_label}
    if gt_score is not None:
        inputs["GTScore"] = gt_score
    helper.append_op(
        "yolov3_loss", inputs=inputs,
        outputs={"Loss": loss, "ObjectnessMask": obj_mask,
                 "GTMatchMask": gt_match},
        attrs={"anchors": [int(a) for a in anchors],
               "anchor_mask": [int(m) for m in anchor_mask],
               "class_num": class_num, "ignore_thresh": ignore_thresh,
               "downsample_ratio": downsample_ratio,
               "use_label_smooth": use_label_smooth})
    return loss


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = _out(helper, x.dtype)
    scores = _out(helper, x.dtype)
    helper.append_op(
        "yolo_box", inputs={"X": x, "ImgSize": img_size},
        outputs={"Boxes": boxes, "Scores": scores},
        attrs={"anchors": [int(a) for a in anchors],
               "class_num": class_num, "conf_thresh": conf_thresh,
               "downsample_ratio": downsample_ratio})
    return boxes, scores


def sigmoid_focal_loss(x, label, fg_num, gamma=2, alpha=0.25):
    helper = LayerHelper("sigmoid_focal_loss")
    out = _out(helper, x.dtype)
    helper.append_op(
        "sigmoid_focal_loss",
        inputs={"X": x, "Label": label, "FgNum": fg_num},
        outputs={"Out": out},
        attrs={"gamma": float(gamma), "alpha": float(alpha)})
    return out


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    helper = LayerHelper("retinanet_detection_output")
    out = _out(helper, bboxes[0].dtype)
    helper.append_op(
        "retinanet_detection_output",
        inputs={"BBoxes": bboxes, "Scores": scores,
                "Anchors": anchors, "ImInfo": im_info},
        outputs={"Out": out},
        attrs={"score_threshold": float(score_threshold),
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": float(nms_threshold),
               "nms_eta": float(nms_eta)})
    return out


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box,
                            anchor_var, gt_boxes, gt_labels, is_crowd,
                            im_info, num_classes=1,
                            positive_overlap=0.5,
                            negative_overlap=0.4):
    """(pred_score, pred_loc, target_label, target_bbox,
    bbox_inside_weight, fg_num): one row per anchor per image, the
    predictions gathered by the op's -1-padded indices (a -1 reads the
    last row, as jnp.take's index counts from the end)."""
    helper = LayerHelper("retinanet_target_assign")
    loc_index = helper.create_variable_for_type_inference("int32")
    score_index = helper.create_variable_for_type_inference("int32")
    target_label = helper.create_variable_for_type_inference("int32")
    target_bbox = _out(helper, anchor_box.dtype)
    bbox_inside_weight = _out(helper, anchor_box.dtype)
    fg_num = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "retinanet_target_assign",
        inputs={"Anchor": anchor_box, "GtBoxes": gt_boxes,
                "GtLabels": gt_labels, "IsCrowd": is_crowd,
                "ImInfo": im_info},
        outputs={"LocationIndex": loc_index,
                 "ScoreIndex": score_index,
                 "TargetLabel": target_label,
                 "TargetBBox": target_bbox,
                 "BBoxInsideWeight": bbox_inside_weight,
                 "ForegroundNumber": fg_num},
        attrs={"positive_overlap": positive_overlap,
               "negative_overlap": negative_overlap})
    preds = _nn.reshape(bbox_pred, [-1, 4])
    scores = _nn.reshape(cls_logits,
                         [-1, int(cls_logits.shape[-1])])
    pred_loc = _nn.gather(preds, loc_index)
    pred_score = _nn.gather(scores, score_index)
    return (pred_score, pred_loc, target_label, target_bbox,
            bbox_inside_weight, fg_num)


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip, name=None):
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = _out(helper, target_box.dtype)
    assigned = _out(helper, target_box.dtype)
    helper.append_op(
        "box_decoder_and_assign",
        inputs={"PriorBox": prior_box, "PriorBoxVar": prior_box_var,
                "TargetBox": target_box, "BoxScore": box_score},
        outputs={"DecodeBox": decoded, "OutputAssignBox": assigned},
        attrs={"box_clip": float(box_clip)})
    return decoded, assigned


# ---------------------------------------------------------------------------
# two-stage detectors
# ---------------------------------------------------------------------------

def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256,
                      rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """(pred_score, pred_loc, target_label, target_bbox,
    bbox_inside_weight): the predictions (cls_logits and bbox_pred in
    the anchors' order, [N, M, 1] and [N, M, 4]) gathered by the op's
    -1-padded [R, 1] indices, which gather keeps: [R, 1, 1] and [R, 1,
    4] (a -1 reads the last row, as jnp.take counts from the end)."""
    helper = LayerHelper("rpn_target_assign")
    loc_index = helper.create_variable_for_type_inference("int32")
    score_index = helper.create_variable_for_type_inference("int32")
    target_label = helper.create_variable_for_type_inference("int32")
    target_bbox = _out(helper, anchor_box.dtype)
    bbox_inside_weight = _out(helper, anchor_box.dtype)
    helper.append_op(
        "rpn_target_assign",
        inputs={"Anchor": anchor_box, "GtBoxes": gt_boxes,
                "IsCrowd": is_crowd, "ImInfo": im_info},
        outputs={"LocationIndex": loc_index,
                 "ScoreIndex": score_index,
                 "TargetLabel": target_label,
                 "TargetBBox": target_bbox,
                 "BBoxInsideWeight": bbox_inside_weight},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random})
    preds = _nn.reshape(bbox_pred, [-1, 4])
    scores = _nn.reshape(cls_logits, [-1, 1])
    pred_loc = _nn.gather(preds, loc_index)
    pred_score = _nn.gather(scores, score_index)
    return (pred_score, pred_loc, target_label, target_bbox,
            bbox_inside_weight)


def generate_proposals(scores, bbox_deltas, im_info, anchors,
                       variances, pre_nms_top_n=6000,
                       post_nms_top_n=1000, nms_thresh=0.5,
                       min_size=0.1, eta=1.0, name=None):
    helper = LayerHelper("generate_proposals", name=name)
    rois = _out(helper, scores.dtype)
    roi_probs = _out(helper, scores.dtype)
    helper.append_op(
        "generate_proposals",
        inputs={"Scores": scores, "BboxDeltas": bbox_deltas,
                "ImInfo": im_info, "Anchors": anchors,
                "Variances": variances},
        outputs={"RpnRois": rois, "RpnRoiProbs": roi_probs},
        attrs={"pre_nms_topN": pre_nms_top_n,
               "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size,
               "eta": eta})
    return rois, roi_probs


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True):
    helper = LayerHelper("generate_proposal_labels")
    rois = _out(helper, rpn_rois.dtype)
    labels = helper.create_variable_for_type_inference("int32")
    bbox_targets = _out(helper, rpn_rois.dtype)
    bbox_inside = _out(helper, rpn_rois.dtype)
    bbox_outside = _out(helper, rpn_rois.dtype)
    helper.append_op(
        "generate_proposal_labels",
        inputs={"RpnRois": rpn_rois, "GtClasses": gt_classes,
                "IsCrowd": is_crowd, "GtBoxes": gt_boxes,
                "ImInfo": im_info},
        outputs={"Rois": rois, "LabelsInt32": labels,
                 "BboxTargets": bbox_targets,
                 "BboxInsideWeights": bbox_inside,
                 "BboxOutsideWeights": bbox_outside},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi,
               "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums or 81,
               "use_random": use_random})
    return rois, labels, bbox_targets, bbox_inside, bbox_outside


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    helper = LayerHelper("generate_mask_labels")
    mask_rois = _out(helper, rois.dtype)
    has_mask = helper.create_variable_for_type_inference("int32")
    mask_int32 = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "generate_mask_labels",
        inputs={"ImInfo": im_info, "GtClasses": gt_classes,
                "IsCrowd": is_crowd, "GtSegms": gt_segms, "Rois": rois,
                "LabelsInt32": labels_int32},
        outputs={"MaskRois": mask_rois, "RoiHasMaskInt32": has_mask,
                 "MaskInt32": mask_int32},
        attrs={"num_classes": num_classes, "resolution": resolution})
    return mask_rois, has_mask, mask_int32


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    helper = LayerHelper("roi_perspective_transform")
    out = _out(helper, input.dtype)
    helper.append_op(
        "roi_perspective_transform",
        inputs={"X": input, "ROIs": rois},
        outputs={"Out": out},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale})
    return out


def distribute_fpn_proposals(fpn_rois, min_level, max_level,
                             refer_level, refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    n = max_level - min_level + 1
    outs = [_out(helper, fpn_rois.dtype) for _ in range(n)]
    restore = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "distribute_fpn_proposals", inputs={"FpnRois": fpn_rois},
        outputs={"MultiFpnRois": outs, "RestoreIndex": restore},
        attrs={"min_level": min_level, "max_level": max_level,
               "refer_level": refer_level, "refer_scale": refer_scale})
    return outs, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level,
                          max_level, post_nms_top_n, name=None):
    helper = LayerHelper("collect_fpn_proposals", name=name)
    out = _out(helper, multi_rois[0].dtype)
    helper.append_op(
        "collect_fpn_proposals",
        inputs={"MultiLevelRois": multi_rois,
                "MultiLevelScores": multi_scores},
        outputs={"FpnRois": out},
        attrs={"post_nms_topN": post_nms_top_n})
    return out
