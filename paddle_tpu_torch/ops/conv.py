"""Convolution and pooling ops: conv2d, depthwise_conv2d, pool2d
(counterpart of paddle_tpu/ops/conv.py).

The JAX package computes these with lax.conv_general_dilated and
lax.reduce_window, outside any Pallas kernel; here they are the
library's (F.conv2d through cuDNN on the card, with TF32 off as the port
runs every float32 product). Layout NCHW by default, NHWC through the
`data_format` attr; the filter is OIHW either way. Gradients are the
generic ones (torch's reverse mode through the lowering).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _channel_last(ctx):
    fmt = ctx.attr("data_format", None) or "NCHW"
    return fmt.endswith("C")


def _conv2d(ctx, depthwise=False):
    x, w = ctx.input("Input"), ctx.input("Filter")
    channel_last = _channel_last(ctx)
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    groups = x.shape[1] if depthwise else (ctx.attr("groups", 1) or 1)
    out = F.conv2d(x, w.to(x.dtype), stride=_pair(ctx.attr("strides", 1)),
                   padding=_pair(ctx.attr("paddings", 0)),
                   dilation=_pair(ctx.attr("dilations", 1)), groups=groups)
    if channel_last:
        out = out.permute(0, 2, 3, 1)
    ctx.set_output("Output", out)


@register_op("conv2d")
def conv2d(ctx):
    _conv2d(ctx)


@register_op("depthwise_conv2d")
def depthwise_conv2d(ctx):
    _conv2d(ctx, depthwise=True)


@register_op("pool2d")
def pool2d(ctx):
    """Max or average pooling over 2-D windows, with the JAX op's padding
    rules: symmetric `paddings`, and under ceil_mode extra padding on the
    bottom and right so that the last partial window counts. Max pads
    with -inf; average divides by the count of real elements in the
    window when `exclusive` or ceil_mode, else by the window size.
    global_pooling reduces all spatial positions."""
    x = ctx.input("X")
    if ctx.attr("adaptive", False):
        raise NotImplementedError("adaptive pool2d is not ported")
    ptype = ctx.attr("pooling_type", "max")
    channel_last = _channel_last(ctx)
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    if ctx.attr("global_pooling", False):
        out = x.amax(dim=(2, 3), keepdim=True) if ptype == "max" else \
            x.mean(dim=(2, 3), keepdim=True)
    else:
        ksize = _pair(ctx.attr("ksize", 1))
        strides = _pair(ctx.attr("strides", 1))
        paddings = _pair(ctx.attr("paddings", 0))
        ceil_mode = ctx.attr("ceil_mode", False)
        pads = []   # (before, after) for H, W
        for i in range(2):
            after = paddings[i]
            if ceil_mode:
                size = x.shape[2 + i]
                out_sz = -(-(size + 2 * paddings[i] - ksize[i])
                           // strides[i]) + 1
                need = (out_sz - 1) * strides[i] + ksize[i] - size - \
                    paddings[i]
                after = max(need, paddings[i])
            pads.append((paddings[i], after))
        # F.pad lists the last dim first
        flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
        if ptype == "max":
            xp = F.pad(x, flat, value=float("-inf")) if any(flat) else x
            out = F.max_pool2d(xp, ksize, strides)
        else:
            xp = F.pad(x, flat) if any(flat) else x
            s = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
            if ctx.attr("exclusive", True) or ceil_mode:
                ones = F.pad(torch.ones_like(x[:1, :1]), flat) \
                    if any(flat) else torch.ones_like(x[:1, :1])
                cnt = F.avg_pool2d(ones, ksize, strides,
                                   divisor_override=1)
            else:
                cnt = float(ksize[0] * ksize[1])
            out = s / cnt
    if channel_last:
        out = out.permute(0, 2, 3, 1)
    ctx.set_output("Out", out)
