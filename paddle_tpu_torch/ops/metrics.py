"""Metric ops (counterpart of paddle_tpu/ops/metrics.py: accuracy,
auc, mean_iou, precision_recall and positive_negative_pair).

The histograms (auc's buckets, mean_iou's confusion matrix, the
precision_recall counts) are accumulating index_put_ calls. auc and
mean_iou add ones, so their float32 sums are exact (below 2^24) in any
order: a captured run's stats equal an eager run's bit for bit.
"""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op


@register_no_grad_op("accuracy")
def accuracy(ctx):
    """Share of rows whose label is among their top-k Indices: Accuracy
    float32 [1], Correct and Total int32 scalars."""
    indices = ctx.input("Indices")
    lbl = ctx.input("Label").long()
    if not (lbl.ndim == 2 and lbl.shape[-1] == 1):
        lbl = lbl[:, None]
    correct = (indices == lbl).any(dim=-1).float().sum()
    n = indices.shape[0]
    ctx.set_output("Correct", correct.to(torch.int32))
    # a fill on the device, not a copy from the host (a CUDA graph
    # captures no host-to-card copy)
    ctx.set_output("Total", torch.full((), n, dtype=torch.int32,
                                       device=indices.device))
    ctx.set_output("Accuracy", (correct / n).reshape(1))


def _hist(n, index, values):
    """A [n] histogram: values added at index."""
    return values.new_zeros(n).index_put_((index,), values, accumulate=True)


@register_no_grad_op("auc")
def auc(ctx):
    """Streaming ROC AUC over threshold buckets: the positive-class
    probability Predict[:, 1] falls in bucket int(p * num_thresholds),
    the batch's positives and negatives are added to StatPos / StatNeg
    (float32 [num_thresholds + 1], written back in place), and AUC is
    the trapezoid area under the accumulated curve."""
    predict = ctx.input("Predict")
    lbl = ctx.input("Label").reshape(-1).long()
    stat_pos, stat_neg = ctx.input("StatPos"), ctx.input("StatNeg")
    nt = int(ctx.attr("num_thresholds", 4095))
    bucket = (predict[:, 1] * nt).to(torch.int32).long().clamp(0, nt)
    n = int(stat_pos.shape[0])
    new_pos = stat_pos + _hist(n, bucket, (lbl == 1).to(stat_pos.dtype))
    new_neg = stat_neg + _hist(n, bucket, (lbl == 0).to(stat_neg.dtype))
    pos_desc = torch.cumsum(new_pos.flip(0), 0)
    neg_desc = torch.cumsum(new_neg.flip(0), 0)
    tot_pos, tot_neg = pos_desc[-1], neg_desc[-1]
    pos_prev = torch.cat([pos_desc.new_zeros(1), pos_desc[:-1]])
    neg_prev = torch.cat([neg_desc.new_zeros(1), neg_desc[:-1]])
    area = ((neg_desc - neg_prev) * (pos_desc + pos_prev) / 2.0).sum()
    denom = tot_pos * tot_neg
    ctx.set_output("AUC", torch.where(denom > 0, area / denom,
                                      area.new_zeros(())))
    ctx.set_output("StatPosOut", new_pos)
    ctx.set_output("StatNegOut", new_neg)


@register_no_grad_op("mean_iou")
def mean_iou(ctx):
    """The mean over classes present (in the predictions or the labels)
    of intersection over union; OutWrong / OutCorrect int32 [C]: each
    class's labels predicted otherwise / right."""
    pred = ctx.input("Predictions").reshape(-1).long()
    label = ctx.input("Labels").reshape(-1).long()
    C = int(ctx.attr("num_classes"))
    conf = _hist(C * C, label * C + pred,
                 torch.ones(pred.shape, device=pred.device)).reshape(C, C)
    inter = torch.diagonal(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / union.clamp(min=1e-9),
                      inter.new_zeros(()))
    miou = iou.sum() / valid.sum().clamp(min=1)
    ctx.set_output("OutMeanIou", miou.reshape(()))
    ctx.set_output("OutWrong", (conf.sum(1) - inter).to(torch.int32))
    ctx.set_output("OutCorrect", inter.to(torch.int32))


def _pr_metrics(st):
    """[6]: macro precision, recall, F1 (class means), then micro."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 2]
    zero = st.new_zeros(())

    def ratio(a, b):
        return torch.where(b > 0, a / b, zero)

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    mprec, mrec = ratio(tps, tps + fps), ratio(tps, tps + fns)
    mf1 = ratio(2 * mprec * mrec, mprec + mrec)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mprec, mrec,
                        mf1])


@register_no_grad_op("precision_recall")
def precision_recall(ctx):
    """Per-class true positives, false positives and false negatives of
    the batch (weighted by Weights), added to StatesInfo [C, 4]; the
    batch's and the accumulated macro and micro metrics."""
    idx = ctx.input("Indices").reshape(-1).long()
    labels = ctx.input("Labels").reshape(-1).long()
    states = ctx.input("StatesInfo")
    C = int(ctx.attr("class_number"))
    weights = ctx.input("Weights")
    w = weights.reshape(-1).float() if weights is not None else \
        torch.ones(labels.shape, device=labels.device)
    hit = (idx == labels).float()
    tp = _hist(C, labels, w * hit)
    fp = _hist(C, idx, w * (1.0 - hit))
    fn = _hist(C, labels, w * (1.0 - hit))
    batch = torch.stack([tp, fp, fn, torch.zeros_like(tp)], dim=1)
    acc = states + batch if states is not None else batch
    ctx.set_output("BatchMetrics", _pr_metrics(batch))
    ctx.set_output("AccumMetrics", _pr_metrics(acc))
    ctx.set_output("AccumStatesInfo", acc)


@register_no_grad_op("positive_negative_pair")
def positive_negative_pair(ctx):
    """Ranking pairs within each query: over the pairs of rows of one
    QueryID with different labels (each pair once, weighted by the mean
    of its rows' weights), positive where the score order agrees with
    the label order, else negative; a tie counts as neutral and as
    negative, as the reference and the JAX op count it. One masked
    [N, N] pair matrix."""
    score = ctx.input("Score")
    label = ctx.input("Label").reshape(-1).float()
    query = ctx.input("QueryID").reshape(-1)
    column = int(ctx.attr("column", 0))
    if column < 0:
        column += int(score.shape[1])
    s = score[:, column].float()
    n = int(s.shape[0])
    w = ctx.input("Weight").reshape(-1).float() \
        if ctx.has_input("Weight") else torch.ones(n, device=s.device)
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    mask = upper & (query[:, None] == query[None, :]) & \
        (label[:, None] != label[None, :])
    pw = torch.where(mask, (w[:, None] + w[None, :]) * 0.5,
                     w.new_zeros(()))
    ds = s[:, None] - s[None, :]
    dl = label[:, None] - label[None, :]
    pos = (pw * (ds * dl > 0)).sum()
    neg = (pw * (ds * dl <= 0)).sum()
    neu = (pw * (ds == 0)).sum()
    if ctx.has_input("AccumulatePositivePair"):
        pos = pos + ctx.input("AccumulatePositivePair").reshape(())
        neg = neg + ctx.input("AccumulateNegativePair").reshape(())
        neu = neu + ctx.input("AccumulateNeutralPair").reshape(())
    ctx.set_output("PositivePair", pos.reshape(1))
    ctx.set_output("NegativePair", neg.reshape(1))
    ctx.set_output("NeutralPair", neu.reshape(1))
