"""Recurrent ops: lstm, gru, lstm_unit, gru_unit (counterpart of
paddle_tpu/ops/rnn.py).

The reference's layouts are kept: lstm's gate buffer is [c~, i, f, o]
with the peephole weights in Bias[4D:7D] (lstm_cpu_kernel.h), gru's
[u, r | c~] with h = (1-u)*h_prev + u*c~ (origin_mode flips it), lstm_unit
[i, f, o, g] with forget_bias, gru_unit's activations by enum. torch's
nn.LSTM / cuDNN order their gates otherwise and have no peepholes.

As in the JAX lowering, the packed rows go to a time-major padded block
[maxT, N, ...] by a gather (the plan's index tables, ops/sequence.py),
a torch loop over maxT steps does h_prev @ W and the gates, and each
sequence's state freezes past its end (a mask a step); is_reverse runs
each sequence from its last row to its first. The gradient is the
generic one: torch's reverse mode through the loop. The reference
instead computes only the live rows of each step (LoDTensor2Batch, a
shrinking batch over sequences sorted by length); the padded block
computes N * maxT rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from .sequence import _last_level, _lengths

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}
_ACT_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(name):
    return _ACT[str(name or "identity")]


def _time_tables(off, rows, reverse):
    """(gather [maxT * N], live [maxT, N, 1], unpack [rows]): the packed
    row each (step, sequence) of the time-major block reads (reversed
    within each sequence for is_reverse; padding clamped to a real row),
    whether the step is inside the sequence, and where each packed row's
    state lands in the flattened [maxT * N] block."""
    off = np.asarray(off, np.int64)
    lens = _lengths(off)
    n = len(lens)
    maxT = int(lens.max()) if n else 0
    t = np.arange(maxT)[:, None]
    last = np.maximum(lens[None, :] - 1, 0)
    live = t < lens[None, :]
    pos = np.minimum(t, last)
    if reverse:
        pos = np.where(live, last - t, pos)
    gather = np.clip(off[None, :-1] + pos, 0, max(rows - 1, 0))
    unpack = np.zeros(rows, np.int64)
    for i in range(n):
        p = np.arange(lens[i])
        step = lens[i] - 1 - p if reverse else p
        unpack[off[i]:off[i + 1]] = step * n + i
    return gather.reshape(-1), live[:, :, None], unpack


def _tables(ctx, off, rows, reverse):
    key = (tuple(off), rows, bool(reverse))
    parts = {}

    def part(i):
        if not parts:
            parts.update(enumerate(_time_tables(off, rows, reverse)))
        return parts[i]

    return tuple(ctx.host_table(kind, key, lambda i=i: part(i))
                 for i, kind in enumerate(("rnn_gather", "rnn_live",
                                           "rnn_unpack")))


def _to_time_major(ctx, x, off, reverse):
    """(x's rows as [maxT, N, width], live mask, unpack table)."""
    gather, live, unpack = _tables(ctx, off, x.shape[0], reverse)
    n = len(off) - 1
    return x[gather].reshape(live.shape[0], n, x.shape[1]), live, unpack


def _from_time_major(hs, unpack):
    """Stacked states [maxT, N, D] back to packed rows."""
    return hs.reshape(-1, hs.shape[-1])[unpack]


def _meta_states(x, D, *inputs):
    """The states [rows, D] on the meta device, where the engine's
    capture rule runs the block (core/engine.py capture_blocker): their
    shape, and an autograd graph that reaches every input, without the
    time loop (on meta each torch op costs host time, and maxT of them
    would cost seconds a layer). The loop itself has no host read and no
    shape that depends on values."""
    reach = sum(t.sum() for t in inputs if t is not None) * 0
    return x.new_zeros((x.shape[0], D)) + reach


@register_op("lstm", no_grad_slots=("C0",))
def lstm(ctx):
    x = ctx.input("Input")          # [T, 4D] x-projections
    w = ctx.input("Weight")         # [D, 4D]
    bias = ctx.input("Bias")        # [1, 4D] or [1, 7D] with peepholes
    h0 = ctx.input("H0")
    c0 = ctx.input("C0")
    off = _last_level(ctx.get_lod("Input"))
    D = w.shape[0]
    n = len(off) - 1
    if x.device.type == "meta":
        states = [_meta_states(x, D, x, w, bias, h0, c0) for _ in "hc"]
        _set_lstm_outputs(ctx, x, D, *states)
        return
    peep = bool(ctx.attr("use_peepholes", True))
    act_g = _act(ctx.attr("gate_activation", "sigmoid"))
    act_c = _act(ctx.attr("cell_activation", "tanh"))
    act_n = _act(ctx.attr("candidate_activation", "tanh"))
    xs, live, unpack = _to_time_major(ctx, x, off,
                                      bool(ctx.attr("is_reverse", False)))
    b = bias.reshape(-1) if bias is not None else None
    if b is not None:
        xs = xs + b[:4 * D]
    peep = peep and b is not None and b.shape[0] >= 7 * D
    if peep:
        w_if = b[4 * D:6 * D].reshape(2, D)     # [w_ic; w_fc]
        w_oc = b[6 * D:7 * D]
    h = h0 if h0 is not None else x.new_zeros((n, D))
    c = c0 if c0 is not None else x.new_zeros((n, D))
    hs, cs = [], []
    # unbind and split, not indexing: their gradients are one stack or
    # cat, where a slice's is a zero tensor of the whole input and an add
    # (1200 steps of [N, 4D] slices of xs: quadratic in the steps)
    for xt, m in zip(xs.unbind(0), live.unbind(0)):
        gates = torch.addmm(xt, h, w).view(n, 4, D)
        g_c, g_if, g_o = gates.split((1, 2, 1), dim=1)
        c3 = c.view(n, 1, D)
        if peep:
            g_if = torch.addcmul(g_if, w_if, c3)
        i, f = act_g(g_if).split(1, dim=1)
        cell = torch.addcmul(act_n(g_c) * i, c3, f)   # [N, 1, D]
        if peep:
            g_o = torch.addcmul(g_o, w_oc, cell)
        hid = (act_c(cell) * act_g(g_o)).view(n, D)
        h = torch.where(m, hid, h)
        c = torch.where(m, cell.view(n, D), c)
        hs.append(h)
        cs.append(c)
    if hs:
        _set_lstm_outputs(ctx, x, D,
                          _from_time_major(torch.stack(hs), unpack),
                          _from_time_major(torch.stack(cs), unpack))
    else:
        _set_lstm_outputs(ctx, x, D, x.new_zeros((0, D)),
                          x.new_zeros((0, D)))


def _set_lstm_outputs(ctx, x, D, hidden, cell):
    lod = ctx.get_lod("Input")
    ctx.set_output("Hidden", hidden)
    ctx.set_output("Cell", cell)
    ctx.set_lod("Hidden", lod)
    ctx.set_lod("Cell", lod)
    # the reference's batch-reordered intermediates; nothing reads them
    if ctx.has_output("BatchGate"):
        ctx.set_output("BatchGate", torch.zeros_like(x))
    if ctx.has_output("BatchCellPreAct"):
        ctx.set_output("BatchCellPreAct", x.new_zeros((x.shape[0], D)))


@register_op("gru", no_grad_slots=("H0",))
def gru(ctx):
    x = ctx.input("Input")         # [T, 3D]
    w = ctx.input("Weight")        # [D, 3D]: [:, :2D] u, r; [:, 2D:] c~
    bias = ctx.input("Bias")       # [1, 3D]
    h0 = ctx.input("H0")
    off = _last_level(ctx.get_lod("Input"))
    D = w.shape[0]
    n = len(off) - 1
    origin = bool(ctx.attr("origin_mode", False))
    act_g = _act(ctx.attr("gate_activation", "sigmoid"))
    act_n = _act(ctx.attr("activation", "tanh"))
    if x.device.type == "meta":
        _set_gru_outputs(ctx, x, D, _meta_states(x, D, x, w, bias, h0))
        return
    xs, live, unpack = _to_time_major(ctx, x, off,
                                      bool(ctx.attr("is_reverse", False)))
    if bias is not None:
        xs = xs + bias.reshape(-1)
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    h = h0 if h0 is not None else x.new_zeros((n, D))
    hs = []
    for xt, m in zip(xs.unbind(0), live.unbind(0)):   # as in lstm
        x_ur, x_c = xt.split((2 * D, D), dim=1)
        u, r = act_g(torch.addmm(x_ur, h, w_ur)).split(D, dim=1)
        cand = act_n(torch.addmm(x_c, r * h, w_c))
        hid = torch.lerp(cand, h, u) if origin else torch.lerp(h, cand, u)
        h = torch.where(m, hid, h)
        hs.append(h)
    _set_gru_outputs(ctx, x, D, _from_time_major(torch.stack(hs), unpack)
                     if hs else x.new_zeros((0, D)))


def _set_gru_outputs(ctx, x, D, hidden):
    ctx.set_output("Hidden", hidden)
    ctx.set_lod("Hidden", ctx.get_lod("Input"))
    for aux in ("BatchGate", "BatchResetHiddenPrev", "BatchHidden"):
        if ctx.has_output(aux):
            ctx.set_output(aux, torch.zeros_like(x) if aux == "BatchGate"
                           else x.new_zeros((x.shape[0], D)))


@register_op("lstm_unit")
def lstm_unit(ctx):
    x = ctx.input("X")              # [N, 4D] order [i, f, o, g]
    c_prev = ctx.input("C_prev")
    forget_bias = float(ctx.attr("forget_bias", 0.0))
    D = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :D])
    f = torch.sigmoid(x[:, D:2 * D] + forget_bias)
    o = torch.sigmoid(x[:, 2 * D:3 * D])
    g = torch.tanh(x[:, 3 * D:])
    c = f * c_prev + i * g
    ctx.set_output("C", c)
    ctx.set_output("H", o * torch.tanh(c))


@register_op("gru_unit")
def gru_unit(ctx):
    x = ctx.input("Input")          # [N, 3D]
    h_prev = ctx.input("HiddenPrev")
    w = ctx.input("Weight")         # [D, 3D]
    bias = ctx.input("Bias")
    D = h_prev.shape[-1]
    origin = bool(ctx.attr("origin_mode", False))
    act_g = _ACT[_ACT_ENUM[int(ctx.attr("gate_activation", 1))]]
    act_n = _ACT[_ACT_ENUM[int(ctx.attr("activation", 2))]]
    if bias is not None:
        x = x + bias.reshape(-1)
    ur = act_g(torch.addmm(x[:, :2 * D], h_prev, w[:, :2 * D]))
    u, r = ur[:, :D], ur[:, D:]
    reset_h = r * h_prev
    c = act_n(torch.addmm(x[:, 2 * D:], reset_h, w[:, 2 * D:]))
    h = c + u * (h_prev - c) if origin else u * (c - h_prev) + h_prev
    ctx.set_output("Gate", torch.cat([u, r, c], dim=1))
    ctx.set_output("ResetHiddenPrev", reset_h)
    ctx.set_output("Hidden", h)
