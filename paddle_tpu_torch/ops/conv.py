"""Convolution, pooling and the other vision ops (counterpart of
paddle_tpu/ops/conv.py): conv2d, depthwise_conv2d, conv3d and their
transposes, pool2d and pool3d (adaptive too), max_pool2d_with_index,
unfold, spp, bilinear_interp and nearest_interp, and the layout ops
pixel_shuffle, space_to_depth, shuffle_channel, affine_channel and
temporal_shift.

The JAX package computes these with lax.conv_general_dilated and
lax.reduce_window, outside any Pallas kernel; here they are the
library's (F.conv2d / F.conv3d / F.conv_transpose{2,3}d through cuDNN on
the card, with TF32 off as the port runs every float32 product). Layout
NCHW by default, channels last through the `data_format` attr of the
convolutions and pools; the filter is OI[D]HW either way, and a
transposed convolution's is [in_c, out_c / groups, *k], as
F.conv_transpose's. Gradients are the generic ones (torch's reverse mode
through the lowering). The interpolations gather through index tables
made on the host with the JAX lowering's rules (ExecContext.host_table:
once a plan), not F.interpolate's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.amp import amp_cast
from ..core.registry import register_op


def _pair(v, n=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _channel_last(ctx, nd):
    fmt = ctx.attr("data_format", None) or "NC" + "DHW"[-nd:]
    return fmt.endswith("C")


def _to_first(x, nd):
    """Channels-last [N, *S, C] to [N, C, *S]."""
    return x.permute(0, nd + 1, *range(1, nd + 1))


def _to_last(x, nd):
    return x.permute(0, *range(2, nd + 2), 1)


def _conv_nd(ctx, nd, depthwise=False):
    x, w = ctx.input("Input"), ctx.input("Filter")
    channel_last = _channel_last(ctx, nd)
    if channel_last:
        x = _to_first(x, nd)
    groups = x.shape[1] if depthwise else (ctx.attr("groups", 1) or 1)
    conv = F.conv2d if nd == 2 else F.conv3d
    out = conv(x, w.to(x.dtype), stride=_pair(ctx.attr("strides", 1), nd),
               padding=_pair(ctx.attr("paddings", 0), nd),
               dilation=_pair(ctx.attr("dilations", 1), nd), groups=groups)
    if channel_last:
        out = _to_last(out, nd)
    ctx.set_output("Output", out)


@register_op("conv2d")
def conv2d(ctx):
    _conv_nd(ctx, 2)


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx):
    _conv_nd(ctx, 2, depthwise=True)


@register_op("conv3d")
def conv3d(ctx):
    _conv_nd(ctx, 3)


def _conv_transpose_nd(ctx, nd):
    """The gradient of a convolution: output size (in - 1) * stride -
    2 * padding + dilation * (k - 1) + 1. The JAX lowering splits,
    concatenates and flips the filter to run it as a dilated
    convolution; F.conv_transpose takes the [in_c, out_c / groups, *k]
    filter as it is, group g mapping input channels g * in_c / groups
    onwards to output channels g * out_c / groups onwards, as the JAX
    lowering's feature groups do. Under AMP every transposed convolution
    computes in the amp dtype as the JAX op does (amp_cast under
    conv2d_transpose's name) and returns its input's dtype: bf16 for
    conv2d_transpose (a white op, its input already cast), float32 for
    the other two."""
    x, w = ctx.input("Input"), ctx.input("Filter")
    dtype = x.dtype
    x, w = amp_cast("conv2d_transpose", x, w)
    conv = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    out = conv(x, w.to(x.dtype), stride=_pair(ctx.attr("strides", 1), nd),
               padding=_pair(ctx.attr("paddings", 0), nd),
               dilation=_pair(ctx.attr("dilations", 1), nd),
               groups=ctx.attr("groups", 1) or 1)
    ctx.set_output("Output", out.to(dtype))


@register_op("conv2d_transpose")
def conv2d_transpose(ctx):
    _conv_transpose_nd(ctx, 2)


@register_op("conv3d_transpose")
def conv3d_transpose(ctx):
    _conv_transpose_nd(ctx, 3)


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ctx):
    _conv_transpose_nd(ctx, 2)


def _adaptive(x, nd, ksize, ptype):
    """Adaptive pooling to output size `ksize` on [N, C, *S]: even
    windows, so each spatial size must divide by its output size."""
    red = (lambda t, d: t.amax(dim=d)) if ptype == "max" else \
        (lambda t, d: t.mean(dim=d))
    out = x
    for ax, osize in zip(range(2, 2 + nd), ksize):
        isize = out.shape[ax]
        if isize % osize:
            raise ValueError(f"adaptive pool needs divisible sizes, "
                             f"{isize}%{osize}")
        out = red(out.reshape(out.shape[:ax] + (osize, isize // osize) +
                              out.shape[ax + 1:]), ax + 1)
    return out


def _pool_nd(ctx, nd):
    """Max or average pooling over nd-dimensional windows, with the JAX
    op's rules: symmetric `paddings`, and under ceil_mode extra padding
    after each spatial axis so that the last partial window counts. Max
    pads with -inf; average divides by the count of real elements in the
    window when `exclusive` or ceil_mode, else by the window size.
    global_pooling (or adaptive with every ksize 1) reduces all spatial
    positions; adaptive pools to output size `ksize` in even windows."""
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    ksize = _pair(ctx.attr("ksize", 1), nd)
    channel_last = _channel_last(ctx, nd)
    if channel_last:
        x = _to_first(x, nd)
    adaptive = ctx.attr("adaptive", False)
    axes = tuple(range(2, 2 + nd))
    if ctx.attr("global_pooling", False) or \
            (adaptive and all(k == 1 for k in ksize)):
        out = x.amax(dim=axes, keepdim=True) if ptype == "max" else \
            x.mean(dim=axes, keepdim=True)
    elif adaptive:
        out = _adaptive(x, nd, ksize, ptype)
    else:
        strides = _pair(ctx.attr("strides", 1), nd)
        paddings = _pair(ctx.attr("paddings", 0), nd)
        ceil_mode = ctx.attr("ceil_mode", False)
        flat = []   # F.pad's order: the last axis first, (before, after)
        for i in reversed(range(nd)):
            after = paddings[i]
            if ceil_mode:
                size = x.shape[2 + i]
                out_sz = -(-(size + 2 * paddings[i] - ksize[i])
                           // strides[i]) + 1
                need = (out_sz - 1) * strides[i] + ksize[i] - size - \
                    paddings[i]
                after = max(need, paddings[i])
            flat += [paddings[i], after]
        pad = any(flat)
        if ptype == "max":
            xp = F.pad(x, flat, value=float("-inf")) if pad else x
            out = (F.max_pool2d if nd == 2 else F.max_pool3d)(
                xp, ksize, strides)
        else:
            avg = F.avg_pool2d if nd == 2 else F.avg_pool3d
            s = avg(F.pad(x, flat) if pad else x, ksize, strides,
                    divisor_override=1)
            if ctx.attr("exclusive", True) or ceil_mode:
                ones = torch.ones_like(x[:1, :1])
                cnt = avg(F.pad(ones, flat) if pad else ones, ksize,
                          strides, divisor_override=1)
            else:
                cnt = float(np.prod(ksize))
            out = s / cnt
    if channel_last:
        out = _to_last(out, nd)
    ctx.set_output("Out", out)


@register_op("pool2d")
def pool2d(ctx):
    _pool_nd(ctx, 2)


@register_op("pool3d")
def pool3d(ctx):
    _pool_nd(ctx, 3)


@register_op("max_pool2d_with_index")
def max_pool2d_with_index(ctx):
    """Out: the max pool with symmetric padding (padded with -inf), as
    the JAX op's. Mask: the flat h * W + w index of each maximum in the
    unpadded input, the reference's (the JAX op writes zeros)."""
    x = ctx.input("X")
    ksize = _pair(ctx.attr("ksize"), 2)
    strides = _pair(ctx.attr("strides", [1, 1]), 2)
    ph, pw = _pair(ctx.attr("paddings", [0, 0]), 2)
    xp = F.pad(x, [pw, pw, ph, ph], value=float("-inf")) \
        if ph or pw else x
    out, idx = F.max_pool2d(xp, ksize, strides, return_indices=True)
    wp = xp.shape[3]
    mask = (idx // wp - ph) * x.shape[3] + (idx % wp - pw)
    ctx.set_output("Out", out)
    ctx.set_output("Mask", mask.to(torch.int32))


@register_op("unfold")
def unfold(ctx):
    """im2col: [N, C * kh * kw, L], C major. Four paddings are read as
    the JAX op reads them: H (p0, p2), W (p1, p3)."""
    x = ctx.input("X")
    k = _pair(ctx.attr("kernel_sizes"), 2)
    s = _pair(ctx.attr("strides", [1, 1]), 2)
    p = _pair(ctx.attr("paddings", [0, 0, 0, 0]), 4)
    d = _pair(ctx.attr("dilations", [1, 1]), 2)
    top, bottom = p[0], p[2] if len(p) > 2 else p[0]
    left = p[1] if len(p) > 1 else p[0]
    right = p[3] if len(p) > 3 else left
    if top or bottom or left or right:
        x = F.pad(x, [left, right, top, bottom])
    ctx.set_output("Y", F.unfold(x, k, dilation=d, stride=s))


@register_op("spp")
def spp(ctx):
    """Spatial pyramid pooling: level l pools into 2^l x 2^l bins of
    ceil(size / bins), padded as the JAX op pads (half the shortfall
    before, rounded up); the average divides by the whole bin, padding
    included. The levels' flattened outputs are concatenated."""
    x = ctx.input("X")
    levels = ctx.attr("pyramid_height")
    ptype = ctx.attr("pooling_type", "max")
    n, _, h, w = x.shape
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        kh, kw = -(-h // bins), -(-w // bins)
        ph = (kh * bins - h + 1) // 2
        pw = (kw * bins - w + 1) // 2
        flat = [pw, kw * bins - w - pw, ph, kh * bins - h - ph]
        if ptype == "max":
            o = F.max_pool2d(F.pad(x, flat, value=float("-inf")),
                             (kh, kw), (kh, kw))
        else:
            o = F.avg_pool2d(F.pad(x, flat), (kh, kw), (kh, kw),
                             divisor_override=1) / (kh * kw)
        outs.append(o.reshape(n, -1))
    ctx.set_output("Out", torch.cat(outs, dim=1))


@register_op("pixel_shuffle")
def pixel_shuffle(ctx):
    x = ctx.input("X")
    r = ctx.attr("upscale_factor")
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    ctx.set_output("Out", out.reshape(n, c // (r * r), h * r, w * r))


@register_op("space_to_depth")
def space_to_depth(ctx):
    x = ctx.input("X")
    b = ctx.attr("blocksize")
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    ctx.set_output("Out", out.reshape(n, c * b * b, h // b, w // b))


@register_op("shuffle_channel")
def shuffle_channel(ctx):
    x = ctx.input("X")
    g = ctx.attr("group")
    n, c, h, w = x.shape
    out = x.reshape(n, g, c // g, h, w).transpose(1, 2)
    ctx.set_output("Out", out.reshape(n, c, h, w))


def _out_size(ctx, x):
    """(out_h, out_w): the OutSize input (read on the host: a block
    that has one is not captured), else int(size * scale) where scale
    > 0, else the out_h / out_w attrs."""
    osz = ctx.input("OutSize")
    if osz is not None:
        h, w = osz.tolist()[:2]
        return int(h), int(w)
    scale = ctx.attr("scale", 0.0)
    if scale and scale > 0:
        return int(x.shape[2] * scale), int(x.shape[3] * scale)
    return ctx.attr("out_h", -1), ctx.attr("out_w", -1)


def _nearest_index(size, out, align_corners):
    """floor(i * size / out (+ 0.5 with align_corners)) in float32, as
    the JAX lowering computes it, clipped to the input."""
    i = np.arange(out).astype(np.float32) * np.float32(size / out)
    if align_corners:
        i = i + np.float32(0.5)
    return np.clip(np.floor(i).astype(np.int64), 0, size - 1)


def _bilinear_table(size, out, align_corners):
    """(i0, i1, frac) of the JAX lowering: source positions on
    linspace(0, size - 1, out) with align_corners (out > 1), else the
    half-pixel centres (i + 0.5) * size / out - 0.5, clipped to
    [0, size - 1]; i0 their floor, i1 = i0 + 1 clipped, in float32."""
    if align_corners and out > 1:
        pos = np.linspace(0, size - 1, out).astype(np.float32)
    else:
        pos = (np.arange(out).astype(np.float32) + np.float32(0.5)) * \
            np.float32(size) / np.float32(out) - np.float32(0.5)
    pos = np.clip(pos, 0, size - 1).astype(np.float32)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, size - 1)
    i1 = np.clip(i0 + 1, 0, size - 1)
    return i0, i1, (pos - i0.astype(np.float32)).astype(np.float32)


def _interp(ctx, method):
    x = ctx.input("X")    # NCHW
    out_h, out_w = _out_size(ctx, x)
    align = ctx.attr("align_corners", True)
    h, w = x.shape[2], x.shape[3]
    if method == "nearest":
        hi = ctx.host_table("nearest_h", (h, out_h, align),
                            lambda: _nearest_index(h, out_h, align))
        wi = ctx.host_table("nearest_w", (w, out_w, align),
                            lambda: _nearest_index(w, out_w, align))
        out = x.index_select(2, hi).index_select(3, wi)
    else:
        h0, h1, lh = (ctx.host_table(
            f"bilinear_h{i}", (h, out_h, align),
            lambda i=i: _bilinear_table(h, out_h, align)[i])
            for i in range(3))
        w0, w1, lw = (ctx.host_table(
            f"bilinear_w{i}", (w, out_w, align),
            lambda i=i: _bilinear_table(w, out_w, align)[i])
            for i in range(3))
        lh = lh[:, None]     # float32 weights, as the JAX lowering's
        rows0, rows1 = x.index_select(2, h0), x.index_select(2, h1)
        v00, v01 = rows0.index_select(3, w0), rows0.index_select(3, w1)
        v10, v11 = rows1.index_select(3, w0), rows1.index_select(3, w1)
        out = (v00 * (1 - lh) * (1 - lw) + v01 * (1 - lh) * lw +
               v10 * lh * (1 - lw) + v11 * lh * lw)
    ctx.set_output("Out", out.to(x.dtype))


@register_op("bilinear_interp", no_grad_slots=("OutSize",))
def bilinear_interp(ctx):
    _interp(ctx, "bilinear")


@register_op("nearest_interp", no_grad_slots=("OutSize",))
def nearest_interp(ctx):
    _interp(ctx, "nearest")


@register_op("affine_channel")
def affine_channel(ctx):
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    ch_axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    ctx.set_output("Out", x * scale.reshape(shape) + bias.reshape(shape))


@register_op("temporal_shift")
def temporal_shift(ctx):
    """[N * T, C, H, W]: the first int(C * ratio) channels shift one
    step back in time (the last step zero), the next ones up to
    int(2 * C * ratio) one step forward (the first step zero)."""
    x = ctx.input("X")
    t = ctx.attr("seg_num")
    ratio = ctx.attr("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    y = x.reshape(nt // t, t, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    fwd = F.pad(y[:, 1:, :c1], [0, 0, 0, 0, 0, 0, 0, 1])
    back = F.pad(y[:, :-1, c1:c2], [0, 0, 0, 0, 0, 0, 1, 0])
    out = torch.cat([fwd, back, y[:, :, c2:]], dim=2)
    ctx.set_output("Out", out.reshape(nt, c, h, w))
