"""sign, py_func and py_func_grad (a Python callable run as an op),
chunk_eval, fsp and the int8 inference ops quantize, dequantize and
requantize (counterpart of paddle_tpu/ops/misc.py's sign, py_func,
py_func_grad, chunk_eval, fsp, quantize, dequantize and requantize).

The callable gets host (numpy) copies of its inputs, and its results go
back to the op's device. A host copy cannot run on the meta device nor
inside a CUDA graph, so the engine's capture rule keeps a block holding
py_func eager (its reason: the op type), as it keeps `while`.
chunk_eval counts chunks on host copies of its inputs (their number
depends on the values), so its block stays eager too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_no_grad_op, register_op
from ..core.scope import tensor_to_numpy
from .quantize import div_scalar


@register_op("sign")
def sign(ctx):
    """-1, 0 or 1 elementwise (L1Decay's term); its gradient is zero."""
    ctx.set_output("Out", torch.sign(ctx.input("X")))


def _host(ctx, v):
    if ctx.device.type == "meta":
        raise NotImplementedError(
            f"{ctx.op.type} runs a Python callable on host copies: it "
            f"runs eagerly only")
    return tensor_to_numpy(v)


def _listed(out):
    return out if isinstance(out, (list, tuple)) else [out]


def _to_device(ctx, v):
    return torch.as_tensor(np.asarray(v)).to(ctx.device)


@register_no_grad_op("py_func")
def py_func(ctx):
    from ..layers.control_flow import py_func_registry
    fn = py_func_registry[ctx.attr("forward_callable_id")]
    outs = _listed(fn(*[_host(ctx, v) for v in ctx.inputs("X")]))
    for n, v in zip(ctx.op.output("Out"), outs):
        ctx.env[n] = _to_device(ctx, v)


@register_no_grad_op("py_func_grad")
def py_func_grad(ctx):
    """The registered backward callable on (inputs, outputs, output
    gradients), less the names in skip_vars_in_backward_input; with no
    backward callable each input's gradient is zeros of that input's
    shape."""
    from ..layers.control_flow import py_func_registry
    bid = ctx.attr("backward_callable_id", -1)
    if bid < 0:
        for in_name, g_name in zip(ctx.op.input("X"),
                                   ctx.op.output("X@GRAD")):
            if g_name:
                ctx.env[g_name] = torch.zeros_like(ctx.env[in_name])
        return
    skip = set(ctx.attr("skip_vars_in_backward_input", []) or [])
    args = [_host(ctx, ctx.env[n]) for slot in ("X", "Out")
            for n in ctx.op.input(slot) if n not in skip]
    args += [_host(ctx, ctx.env[n]) for n in ctx.op.input("Out@GRAD")]
    grads = _listed(py_func_registry[bid](*args))
    for n, g in zip(ctx.op.output("X@GRAD"), grads):
        if n:
            ctx.env[n] = _to_device(ctx, g)


_CHUNK_TAGS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunks(seq, scheme, num_chunk_types, excluded):
    """The (type, start, end) chunks of one sequence of tag ids: tag id
    t is chunk type t // n_tags with tag t % n_tags of the scheme (IOB:
    B=0 I=1; IOE: I=0 E=1; IOBES: B=0 I=1 E=2 S=3; plain: one tag), and
    num_chunk_types * n_tags is the outside tag."""
    n_tags = _CHUNK_TAGS[scheme]
    out, start, cur = [], None, None
    for i, t in enumerate(int(v) for v in seq):
        if t == num_chunk_types * n_tags:          # outside
            if start is not None:
                out.append((cur, start, i))
                start = None
            continue
        ctype, tag = t // n_tags, t % n_tags
        if scheme == "plain":
            begin = True
        elif scheme == "IOB":
            begin = tag == 0
        elif scheme == "IOE":
            begin = start is None or ctype != cur
        else:
            begin = tag in (0, 3)
        if begin or ctype != cur:
            if start is not None:
                out.append((cur, start, i))
            start, cur = i, ctype
        if (scheme == "IOE" and tag == 1) or \
                (scheme == "IOBES" and tag in (2, 3)):
            out.append((cur, start, i + 1))
            start = None
    if start is not None:
        out.append((cur, start, len(seq)))
    return {c for c in out if c[0] not in excluded}


@register_no_grad_op("chunk_eval")
def chunk_eval(ctx):
    """Chunk precision, recall and F1 of Inference against Label over
    the sequences of their LoD (one sequence without), and the counts:
    float32 and int32 scalars. The chunks are decoded on the host."""
    inf = _host(ctx, ctx.input("Inference")).reshape(-1)
    lab = _host(ctx, ctx.input("Label")).reshape(-1)
    n_types = int(ctx.attr("num_chunk_types"))
    scheme = ctx.attr("chunk_scheme", "IOB")
    excluded = set(ctx.attr("excluded_chunk_types", []) or [])
    lod = ctx.get_lod("Inference") or ctx.get_lod("Label")
    off = [int(v) for v in lod[-1]] if lod else [0, inf.shape[0]]
    n_inf = n_lab = n_correct = 0
    for s, e in zip(off[:-1], off[1:]):
        ci = _chunks(inf[s:e], scheme, n_types, excluded)
        cl = _chunks(lab[s:e], scheme, n_types, excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_correct += len(ci & cl)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    for slot, v, dt in (("Precision", p, torch.float32),
                        ("Recall", r, torch.float32),
                        ("F1-Score", f1, torch.float32),
                        ("NumInferChunks", n_inf, torch.int32),
                        ("NumLabelChunks", n_lab, torch.int32),
                        ("NumCorrectChunks", n_correct, torch.int32)):
        ctx.set_output(slot, torch.tensor(v, dtype=dt).to(ctx.device))


@register_op("fsp")
def fsp(ctx):
    """The FSP matrix of distillation: Out[n, i, j] = sum over h, w of
    X[n, i, h, w] * Y[n, j, h, w], over H * W."""
    x, y = ctx.input("X"), ctx.input("Y")
    h, w = x.shape[2], x.shape[3]
    ctx.set_output("Out", div_scalar(torch.einsum("nihw,njhw->nij", x, y),
                                     float(h * w)))


def _int8(v):
    """Round half to even, clip to [-128, 127], int8."""
    return torch.clamp(torch.round(v), -128, 127).to(torch.int8)


@register_no_grad_op("quantize")
def quantize_int8(ctx):
    """Output = int8(round(Input * Scale))."""
    ctx.set_output("Output", _int8(ctx.input("Input") *
                                   ctx.attr("Scale", 1.0)))


@register_no_grad_op("dequantize")
def dequantize_int8(ctx):
    ctx.set_output("Output", div_scalar(
        ctx.input("Input").to(torch.float32), ctx.attr("Scale", 1.0)))


@register_no_grad_op("requantize")
def requantize_int8(ctx):
    """int8 from one scale to another: round(Input / Scale_in *
    Scale_out)."""
    x = ctx.input("Input").to(torch.float32)
    ctx.set_output("Output", _int8(div_scalar(x, ctx.attr("Scale_in", 1.0))
                                   * ctx.attr("Scale_out", 1.0)))
