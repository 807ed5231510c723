"""The fake-quantize op family (counterpart of paddle_tpu/ops/quantize.py):
the simulated int8 quantization that contrib/slim's QAT passes insert.

Every lowering computes the JAX package's expression with the same
operations in the same order, so that the values and the generic
gradients (the vector-Jacobian product of the lowering) agree with the
JAX package's to the bit:

* the straight-through estimator is ``smooth + (rounded - smooth)
  .detach()`` (JAX: ``smooth + stop_gradient(rounded - smooth)``), whose
  value is not always `rounded` to the last bit;
* a clip is ``minimum(s, maximum(-s, x))`` (jnp.clip), whose gradient
  splits a tie in halves as jnp's does (torch.clamp's does not);
* rounding is torch.round, half to even, as jnp.round and np.round;
* a division by a number is a true division by a 0-d tensor of it
  (`div_scalar`): torch on a card multiplies by the number's reciprocal
  where the divisor is a Python number, which moves the quotient by an
  ulp against the CPU, the JAX lowering and numpy.

Running-scale state (the moving averages' accumulators, range_abs_max's
window buffer and iteration counter) is read from the op's inputs and
written to its outputs, which name the same persistables, as
batch_norm's MeanOut / VarianceOut: a captured block updates them in
place at every replay. range_abs_max indexes its window with
``Iter % window`` on the device, never on the host.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _bin_cnt(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def div_scalar(v, c):
    """v / c, correctly rounded on every device (the divisor a 0-d
    tensor on v's device, made by a fill: no host copy)."""
    return v / torch.full((), c, dtype=v.dtype, device=v.device)


def _ste(smooth, rounded):
    return smooth + (rounded - smooth).detach()


def _floor_scale(scale):
    """jnp.maximum(scale, 1e-8)."""
    return torch.maximum(scale, torch.full_like(scale, 1e-8))


def _clip(x, s):
    """jnp.clip(x, -s, s)."""
    return torch.minimum(s, torch.maximum(-s, x))


def _quant(x, scale, bin_cnt):
    """The integer grid, kept in float: round(clip(x, -s, s) / s *
    bin_cnt) with the straight-through gradient of the linear part."""
    s = _floor_scale(scale)
    lin = _clip(x, s) / s * bin_cnt
    return _ste(lin, torch.round(lin))


def _quant_dequant(x, scale, bin_cnt):
    """The grid value back in x's units; the gradient is the identity."""
    s = _floor_scale(scale)
    q = torch.round(_clip(x, s) / s * bin_cnt)
    return _ste(x, div_scalar(q * s, bin_cnt))


def _abs_max(x):
    return torch.max(torch.abs(x))


@register_op("fake_quantize_abs_max")
def fake_quantize_abs_max(ctx):
    x = ctx.input("X")
    scale = _abs_max(x)
    ctx.set_output("Out", _quant(x, scale, _bin_cnt(ctx.attr("bit_length",
                                                               8))))
    ctx.set_output("OutScale", scale.reshape(1))


@register_op("fake_quantize_dequantize_abs_max")
def fake_quantize_dequantize_abs_max(ctx):
    x = ctx.input("X")
    scale = _abs_max(x)
    ctx.set_output("Out", _quant_dequant(
        x, scale, _bin_cnt(ctx.attr("bit_length", 8))))
    ctx.set_output("OutScale", scale.reshape(1))


@register_op("fake_channel_wise_quantize_abs_max")
def fake_channel_wise_quantize_abs_max(ctx):
    """One scale a channel of dim 0 (a conv filter's output channel)."""
    x = ctx.input("X")
    scale = torch.amax(torch.abs(x), dim=tuple(range(1, x.ndim)))
    bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
    ctx.set_output("Out", _quant(x, scale.reshape(bshape),
                                 _bin_cnt(ctx.attr("bit_length", 8))))
    ctx.set_output("OutScale", scale)


@register_op("fake_dequantize_max_abs", no_grad_slots=("Scale",))
def fake_dequantize_max_abs(ctx):
    x, scale = ctx.input("X"), ctx.input("Scale")
    ctx.set_output("Out", div_scalar(x * scale.reshape(()),
                                     ctx.attr("max_range", 127.0)))


@register_op("fake_channel_wise_dequantize_max_abs",
             no_grad_slots=("Scales",))
def fake_channel_wise_dequantize_max_abs(ctx):
    """The first scale is per channel of dim 0; an optional second one
    scales the whole tensor."""
    x = ctx.input("X")
    scales = ctx.inputs("Scales")
    bits = ctx.attr("quant_bits", [8])
    bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
    out = div_scalar(x * scales[0].reshape(bshape), _bin_cnt(bits[0]))
    if len(scales) > 1:
        out = div_scalar(out * scales[1].reshape(()),
                         _bin_cnt(bits[1] if len(bits) > 1 else 8))
    ctx.set_output("Out", out)


@register_op("fake_quantize_range_abs_max",
             no_grad_slots=("InScale", "Iter"))
def fake_quantize_range_abs_max(ctx):
    """The scale is the largest abs max of the last `window_size` runs:
    a circular buffer OutScales, written at Iter % window."""
    x = ctx.input("X")
    bin_cnt = _bin_cnt(ctx.attr("bit_length", 8))
    window = ctx.attr("window_size", 10000)
    in_scale = ctx.input("InScale").reshape(())
    if ctx.attr("is_test", False):
        ctx.set_output("Out", _quant(x, in_scale, bin_cnt))
        ctx.set_output("OutScale", in_scale.reshape(1))
        return
    cur = _abs_max(x)
    it = ctx.input("Iter")
    buf = ctx.input("OutScales")
    if buf is None:
        buf = torch.zeros(window, dtype=x.dtype, device=x.device)
    idx = (it.reshape(1) % window).to(torch.int64)
    buf = buf.index_put((idx,), cur.reshape(1))
    scale = _floor_scale(torch.max(buf))
    ctx.set_output("Out", _quant(x, scale, bin_cnt))
    ctx.set_output("OutScale", scale.reshape(1))
    ctx.set_output("OutScales", buf)
    ctx.set_output("IterOut", it + 1)


def _moving_average_scale(ctx, x):
    """accum = rate * accum + abs max, state = rate * state + 1, scale =
    accum / state; the three written to OutAccum, OutState, OutScale."""
    rho = ctx.attr("moving_rate", 0.9)
    state = ctx.input("InState").reshape(())
    accum = ctx.input("InAccum").reshape(())
    state_new = rho * state + 1.0
    accum_new = rho * accum + _abs_max(x)
    scale = accum_new / state_new
    ctx.set_output("OutState", state_new.reshape(1))
    ctx.set_output("OutAccum", accum_new.reshape(1))
    ctx.set_output("OutScale", scale.reshape(1))
    return scale


def _moving_average_op(ctx, quant):
    x = ctx.input("X")
    bin_cnt = _bin_cnt(ctx.attr("bit_length", 8))
    if ctx.attr("is_test", False):
        scale = ctx.input("InScale").reshape(())
        ctx.set_output("Out", quant(x, scale, bin_cnt))
        ctx.set_output("OutScale", scale.reshape(1))
        return
    ctx.set_output("Out", quant(x, _moving_average_scale(ctx, x), bin_cnt))


@register_op("fake_quantize_moving_average_abs_max",
             no_grad_slots=("InScale", "InAccum", "InState"))
def fake_quantize_moving_average_abs_max(ctx):
    _moving_average_op(ctx, _quant)


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             no_grad_slots=("InScale", "InAccum", "InState"))
def fake_quantize_dequantize_moving_average_abs_max(ctx):
    _moving_average_op(ctx, _quant_dequant)


@register_op("moving_average_abs_max_scale",
             no_grad_slots=("InAccum", "InState"))
def moving_average_abs_max_scale(ctx):
    """X passes through; in training the moving-average scale is
    updated."""
    x = ctx.input("X")
    if not ctx.attr("is_test", False):
        _moving_average_scale(ctx, x)
    ctx.set_output("Out", x)
