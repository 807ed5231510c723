"""Dense NN ops: softmax, log_softmax, cross_entropy, cross_entropy2,
softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits, the
losses (log, huber, smooth_l1, hinge, rank, margin_rank, kldiv, bpr),
layer_norm, batch_norm, group_norm, instance_norm, lrn, l2_normalize,
data_norm, add_position_encoding, label_smoothed_softmax_xent with its
hand-written grad, and dropout (counterpart of paddle_tpu/ops/nn.py).
softmax, cross_entropy, softmax_with_cross_entropy and
sigmoid_cross_entropy_with_logits take the generic gradient. layer_norm,
batch_norm and dropout take the generic gradient (the vector-Jacobian
product of the lowering): the two norms keep their statistics in float32
under bf16, batch_norm's running statistics move once a step (the
forward's record writes MeanOut and VarianceOut; a grad op that
recomputes the forward writes nothing back), and the dropout grad reuses
the forward's record or its seed, so it never draws a new mask."""
from __future__ import annotations

import torch

from ..core.registry import (GRAD_SUFFIX, override_grad_lowering,
                             register_op)


@register_op("softmax")
def softmax(ctx):
    """Over the last axis, as the JAX op computes it (it reads no other
    axis; the port refuses one rather than ignore it)."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    if axis not in (-1, x.ndim - 1):
        raise NotImplementedError(f"softmax over axis {axis} (not the "
                                  f"last) is not ported")
    ctx.set_output("Out", torch.softmax(x, dim=-1))


@register_op("cross_entropy", no_grad_slots=("Label",))
def cross_entropy(ctx):
    """-log(x + 1e-12) of the probability at the label (hard labels;
    rows whose label is ignore_index give 0), or -sum(label *
    log(x + 1e-12)) over the last axis (soft_label)."""
    x, label = ctx.input("X"), ctx.input("Label")
    eps = 1e-12
    if ctx.attr("soft_label", False):
        out = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        ids = label.long()
        if ids.ndim == x.ndim:
            ids = ids.squeeze(-1)
        picked = torch.gather(x, -1, ids[..., None].clamp(0, x.shape[-1]
                                                          - 1))
        out = -torch.log(picked + eps)
        keep = ids[..., None] != ctx.attr("ignore_index", -100)
        out = torch.where(keep, out, torch.zeros_like(out))
    ctx.set_output("Y", out)


@register_op("softmax_with_cross_entropy", no_grad_slots=("Label",))
def softmax_with_cross_entropy(ctx):
    """Loss = -log_softmax(logits) at the label (hard labels; rows whose
    label is ignore_index give 0), or -sum(label * log_softmax(logits))
    over the last axis (soft_label); Softmax = exp(log_softmax)."""
    logits, label = ctx.input("Logits"), ctx.input("Label")
    axis = ctx.attr("axis", -1)
    if axis not in (-1, logits.ndim - 1):
        raise NotImplementedError(f"softmax_with_cross_entropy over axis "
                                  f"{axis} (not the last) is not ported")
    log_p = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * log_p, dim=-1, keepdim=True)
    else:
        ids = label.long()
        if ids.ndim == logits.ndim:
            ids = ids.squeeze(-1)
        # the leading dims broadcast, as jnp.take_along_axis's do
        lead = torch.broadcast_shapes(ids.shape, log_p.shape[:-1])
        ids = ids.expand(lead)
        loss = -torch.gather(log_p.expand(*lead, log_p.shape[-1]), -1,
                             ids[..., None].clamp(0, logits.shape[-1] - 1))
        keep = ids[..., None] != ctx.attr("ignore_index", -100)
        loss = torch.where(keep, loss, torch.zeros_like(loss))
    ctx.set_output("Softmax", torch.exp(log_p))
    ctx.set_output("Loss", loss)


@register_op("sigmoid_cross_entropy_with_logits",
             no_grad_slots=("Label",))
def sigmoid_cross_entropy_with_logits(ctx):
    """max(x, 0) - x*label + log1p(exp(-|x|)) elementwise, 0 where the
    label is ignore_index; with normalize, divided by the count of the
    other labels (at least 1). The JAX op's formula, operation for
    operation (torch.maximum splits the gradient of a tie as
    jnp.maximum does)."""
    x, label = ctx.input("X"), ctx.input("Label")
    loss = torch.maximum(x, x.new_zeros(())) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    mask = label != ctx.attr("ignore_index", -100)
    loss = torch.where(mask, loss, 0.0)
    if ctx.attr("normalize", False):
        loss = loss / torch.clamp_min(mask.to(x.dtype).sum(), 1.0)
    ctx.set_output("Out", loss)


@register_op("batch_norm", no_grad_slots=("Mean", "Variance"))
def batch_norm(ctx):
    """Y = (x - mean) / sqrt(var + eps) * scale + bias over every axis but
    the channel's (axis 1 in NCHW, the last in NHWC). Training takes the
    batch's mean and biased variance and sets MeanOut = Mean*momentum +
    mean*(1-momentum), the same for VarianceOut, SavedMean = mean and
    SavedVariance = 1/sqrt(var + eps); is_test or use_global_stats
    normalize by Mean and Variance, which pass through, and the saved
    statistics are zeros. A bf16 x is normalized in float32 and Y
    rounded to bf16 once; the statistics stay float32.

    The normalization is torch's native batch norm, whose backward
    keeps only x and the two statistics; the variance of the running
    update is read back from its 1/sqrt(var + eps)."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean_in, var_in = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    use_global = ctx.attr("use_global_stats", False) or \
        ctx.attr("is_test", False)
    channel_last = ctx.attr("data_layout", "NCHW") == "NHWC"
    xc = x.movedim(-1, 1) if channel_last else x
    if use_global:
        y = torch.native_batch_norm(xc, scale, bias, mean_in, var_in,
                                    False, 0.0, eps)[0]
        mean_out, var_out = mean_in, var_in
        saved_mean = torch.zeros_like(mean_in)
        saved_var = torch.zeros_like(var_in)
    else:
        y, mean, inv_std = torch.native_batch_norm(
            xc, scale, bias, None, None, True, 0.0, eps)
        var = inv_std.detach().pow(-2) - eps
        mean = mean.detach()
        mean_out = mean_in * momentum + mean * (1 - momentum)
        var_out = var_in * momentum + var * (1 - momentum)
        saved_mean, saved_var = mean, inv_std.detach()
    ctx.set_output("Y", y.movedim(1, -1) if channel_last else y)
    ctx.set_output("MeanOut", mean_out)
    ctx.set_output("VarianceOut", var_out)
    ctx.set_output("SavedMean", saved_mean)
    ctx.set_output("SavedVariance", saved_var)


@register_op("layer_norm")
def layer_norm(ctx):
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    axes = list(range(begin, x.ndim))
    # float32 statistics for bf16/fp16 inputs
    reduced = x.dtype in (torch.bfloat16, torch.float16)
    xf = x.float() if reduced else x
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    ctx.set_output("Y", y.to(x.dtype) if reduced else y)
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


@register_op("add_position_encoding")
def add_position_encoding(ctx):
    """Sinusoid table [T, D] (sin half then cos half), computed in
    float64 on the input's device and cast to its dtype, as the JAX
    package computes it in numpy."""
    x = ctx.input("X")  # [B, T, D]
    alpha = ctx.attr("alpha", 1.0)
    beta = ctx.attr("beta", 1.0)
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float64, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / d)
    enc = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    ctx.set_output("Out", alpha * x + beta * enc.to(x.dtype)[None, :, :])


@register_op("label_smoothed_softmax_xent", no_grad_slots=("Label",))
def label_smoothed_softmax_xent(ctx):
    """CE against y_j = (1-eps)*[j==y] + eps/K over hard labels:
    lse(l) - (1-eps)*l_y - eps*mean_j(l_j), with no one-hot tensor."""
    logits, label = ctx.input("Logits"), ctx.input("Label")
    eps = ctx.attr("epsilon", 0.0)
    lf = logits.float()
    ids = label.long()
    if ids.ndim == logits.ndim:
        ids = ids.squeeze(-1)
    lse = torch.logsumexp(lf, dim=-1)
    l_y = torch.gather(logits, -1, ids[..., None]).squeeze(-1).float()
    loss = lse - (1.0 - eps) * l_y - eps * lf.mean(dim=-1)
    ctx.set_output("Loss", loss[..., None])


@override_grad_lowering("label_smoothed_softmax_xent")
def label_smoothed_softmax_xent_grad(ctx):
    """d logits_j = dLoss * (softmax_j - eps/K - (1-eps)[j == y]), in the
    logits' dtype (bf16 under AMP), without a one-hot tensor."""
    out_names = ctx.op.output("Logits" + GRAD_SUFFIX)
    if not (out_names and out_names[0]):
        return
    logits = ctx.env[ctx.op.input("Logits")[0]]
    ids = ctx.env[ctx.op.input("Label")[0]].long()
    eps = ctx.attr("epsilon", 0.0)
    if ids.ndim == logits.ndim:
        ids = ids.squeeze(-1)
    k = logits.shape[-1]
    g = torch.softmax(logits.float(), dim=-1) - eps / k
    g.scatter_add_(-1, ids[..., None],
                   torch.full(ids.shape + (1,), -(1.0 - eps),
                              dtype=g.dtype, device=g.device))
    g_names = ctx.op.input("Loss" + GRAD_SUFFIX)
    dloss = ctx.env.get(g_names[0]) if g_names and g_names[0] else None
    if dloss is not None:
        d = dloss.float()
        if not (d.ndim == logits.ndim and d.shape[-1] == 1):
            d = d[..., None]
        g = g * d
    ctx.env[out_names[0]] = g.to(logits.dtype)


@register_op("dropout")
def dropout(ctx):
    """u8-threshold dropout: keep-threshold t = round((1-p)*256); an
    element is kept when its random byte is below t. With
    upscale_in_train the kept values divide by t/256, the keep
    probability actually realized, so E[out] = x. t >= 256 (keep all)
    and t <= 0 (drop all) are exact. Mask is the keep mask as uint8.
    The bytes come from the op's generator (uid and run index; under a
    captured block one registered with the graph, re-seeded before each
    replay), so they differ from the JAX package's bits."""
    x = ctx.input("X")
    prob = ctx.attr("dropout_prob", 0.5)
    is_test = ctx.attr("is_test", False)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    t = int(round((1.0 - prob) * 256.0))
    if is_test or t >= 256:
        out = x if (impl == "upscale_in_train" or not is_test) \
            else x * (1.0 - prob)
        ctx.set_output("Out", out)
        ctx.set_output("Mask", torch.ones_like(x, dtype=torch.uint8))
        return
    if t <= 0:
        ctx.set_output("Out", torch.zeros_like(x))
        ctx.set_output("Mask", torch.zeros_like(x, dtype=torch.uint8))
        return
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                         generator=ctx.generator(), device=x.device)
    keep = bits < t
    q = t / 256.0
    kept = x / q if impl == "upscale_in_train" else x
    ctx.set_output("Out", torch.where(keep, kept, torch.zeros_like(x)))
    ctx.set_output("Mask", keep.to(torch.uint8))


# ---------------------------------------------------------------------------
# log_softmax, cross_entropy2 and the losses (the JAX lowerings' formulas,
# operation for operation; each takes the generic gradient)
# ---------------------------------------------------------------------------

@register_op("log_softmax")
def log_softmax(ctx):
    """Over the last axis, as the JAX op computes it (a other axis is
    refused, as by softmax)."""
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    if axis not in (-1, x.ndim - 1):
        raise NotImplementedError(f"log_softmax over axis {axis} (not the "
                                  f"last) is not ported")
    ctx.set_output("Out", torch.log_softmax(x, dim=-1))


def _hard_ids(label, x):
    ids = label.long()
    return ids.squeeze(-1) if ids.ndim == x.ndim else ids


@register_op("cross_entropy2", no_grad_slots=("Label",))
def cross_entropy2(ctx):
    """Y = -log(x[label] + 1e-12), MatchX = x[label], XShape an empty
    [0, *x.shape] tensor."""
    x, label = ctx.input("X"), ctx.input("Label")
    ids = _hard_ids(label, x)
    picked = torch.gather(x, -1, ids[..., None])
    ctx.set_output("Y", -torch.log(picked + 1e-12))
    ctx.set_output("XShape", x.new_zeros((0,) + tuple(x.shape)))
    ctx.set_output("MatchX", picked)


@register_op("log_loss", no_grad_slots=("Labels",))
def log_loss(ctx):
    p, y = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -y * torch.log(p + eps) -
                   (1 - y) * torch.log(1 - p + eps))


@register_op("huber_loss", no_grad_slots=("Y",))
def huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    delta = ctx.attr("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(ar <= delta, 0.5 * r * r,
                                      delta * (ar - 0.5 * delta)))


@register_op("smooth_l1_loss", no_grad_slots=("Y",))
def smooth_l1_loss(ctx):
    """Diff = (x - y) * InsideWeight; Out [N, 1] = the sum over every axis
    but the first of 0.5*d*d*s2 where |d| < 1/s2, else |d| - 0.5/s2
    (s2 = sigma^2), times OutsideWeight."""
    x, y = ctx.input("X"), ctx.input("Y")
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    in_w, out_w = ctx.input("InsideWeight"), ctx.input("OutsideWeight")
    if in_w is not None:
        d = d * in_w
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if out_w is not None:
        loss = loss * out_w
    ctx.set_output("Diff", d)
    ctx.set_output("Out", torch.sum(loss, dim=tuple(range(1, x.ndim)))[:, None]
                   if x.ndim > 1 else loss[:, None])


@register_op("hinge_loss", no_grad_slots=("Labels",))
def hinge_loss(ctx):
    logits, labels = ctx.input("Logits"), ctx.input("Labels")
    ctx.set_output("Loss", torch.maximum(
        1.0 - (2.0 * labels - 1.0) * logits, logits.new_zeros(())))


@register_op("rank_loss", no_grad_slots=("Label",))
def rank_loss(ctx):
    label = ctx.input("Label")
    d = ctx.input("Left") - ctx.input("Right")
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - label * d)


@register_op("margin_rank_loss", no_grad_slots=("Label",))
def margin_rank_loss(ctx):
    label = ctx.input("Label")
    x1, x2 = ctx.input("X1"), ctx.input("X2")
    margin = ctx.attr("margin", 0.0)
    out = torch.maximum(-label * (x1 - x2) + margin, x1.new_zeros(()))
    ctx.set_output("Activated", (out > 0).to(x1.dtype))
    ctx.set_output("Out", out)


@register_op("kldiv_loss", no_grad_slots=("Target",))
def kldiv_loss(ctx):
    """target * (log(target) - x) where target > 0, else 0; reduced by
    `reduction`: mean and sum to a 0-d tensor, batchmean the sum over
    the first dim's size, none elementwise."""
    x, target = ctx.input("X"), ctx.input("Target")
    reduction = ctx.attr("reduction", "mean")
    loss = torch.where(target > 0, target * (torch.log(target) - x),
                       torch.zeros((), dtype=x.dtype, device=x.device))
    if reduction == "mean":
        loss = torch.mean(loss)
    elif reduction == "sum":
        loss = torch.sum(loss)
    elif reduction == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    ctx.set_output("Loss", loss)


@register_op("bpr_loss", no_grad_slots=("Label",))
def bpr_loss(ctx):
    """Y [.., 1] = the mean over the negatives j != label of
    -log(sigmoid(x[label] - x[j]) + 1e-12)."""
    x, label = ctx.input("X"), ctx.input("Label")
    ids = _hard_ids(label, x)
    pos = torch.gather(x, -1, ids[..., None])
    loss = -torch.log(torch.sigmoid(pos - x) + 1e-12)
    n = x.shape[-1]
    mask = torch.nn.functional.one_hot(ids, n).to(x.dtype)
    ctx.set_output("Y", torch.sum(loss * (1 - mask), dim=-1, keepdim=True)
                   / (n - 1))


# ---------------------------------------------------------------------------
# group_norm, instance_norm, lrn, l2_normalize, data_norm
# ---------------------------------------------------------------------------

def _moments(x, axes):
    """mean and biased variance over `axes` (kept), each a mean as
    jnp.mean and jnp.var compute it: the variance is the mean of the
    squared deviations."""
    mean = x.mean(dim=axes, keepdim=True)
    dev = x - mean
    return mean, (dev * dev).mean(dim=axes, keepdim=True)


@register_op("group_norm")
def group_norm(ctx):
    """NCHW: each sample's `groups` channel groups normalized over their
    channels and spatial positions, then Scale and Bias a channel; Mean
    and Variance [N, groups]. A bf16 x is normalized in float32."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    groups = ctx.attr("groups")
    n, c = x.shape[0], x.shape[1]
    reduced = x.dtype in (torch.bfloat16, torch.float16)
    xf = x.float() if reduced else x
    g = xf.reshape(n, groups, c // groups, *x.shape[2:])
    mean, var = _moments(g, tuple(range(2, g.ndim)))
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = [1, c] + [1] * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    ctx.set_output("Y", y.to(x.dtype) if reduced else y)
    ctx.set_output("Mean", mean.reshape(n, groups))
    ctx.set_output("Variance", var.reshape(n, groups))


@register_op("instance_norm")
def instance_norm(ctx):
    """Each (sample, channel) normalized over its spatial positions, then
    Scale and Bias a channel."""
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    mean, var = _moments(x, tuple(range(2, x.ndim)))
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    ctx.set_output("Y", y)


@register_op("lrn")
def lrn(ctx):
    """NCHW cross-channel LRN: MidOut = k + alpha * the sum of x^2 over
    the n channels around each (zero-padded), Out = x / MidOut^beta; the
    window summed in the JAX lowering's order."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    alpha, beta = ctx.attr("alpha", 1e-4), ctx.attr("beta", 0.75)
    k = ctx.attr("k", 1.0)
    half = n // 2
    pad = torch.nn.functional.pad(x * x, (0, 0, 0, 0, half, half))
    acc = torch.zeros_like(x)
    for i in range(n):
        acc = acc + pad[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    ctx.set_output("MidOut", mid)
    ctx.set_output("Out", x / torch.pow(mid, beta))


@register_op("l2_normalize")
def l2_normalize(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    eps = ctx.attr("epsilon", 1e-10)
    ctx.set_output("Out", x * torch.rsqrt(
        torch.sum(x * x, dim=axis, keepdim=True) + eps))


@register_op("data_norm")
def data_norm(ctx):
    """Y = (x - BatchSum/BatchSize) * sqrt(BatchSize/BatchSquareSum), with
    Means and Scales the two factors. The three statistics are
    parameters, moved by the optimizer through their generic gradients,
    as in the JAX package."""
    x = ctx.input("X")
    size = ctx.input("BatchSize")
    means = ctx.input("BatchSum") / size
    scales = torch.sqrt(size / ctx.input("BatchSquareSum"))
    ctx.set_output("Means", means)
    ctx.set_output("Scales", scales)
    ctx.set_output("Y", (x - means) * scales)
