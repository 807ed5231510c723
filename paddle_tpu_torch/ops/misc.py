"""sign, and py_func and py_func_grad: a Python callable run as an op
(counterpart of paddle_tpu/ops/misc.py's sign, py_func and
py_func_grad).

The callable gets host (numpy) copies of its inputs, and its results go
back to the op's device. A host copy cannot run on the meta device nor
inside a CUDA graph, so the engine's capture rule keeps a block holding
py_func eager (its reason: the op type), as it keeps `while`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_no_grad_op, register_op
from ..core.scope import tensor_to_numpy


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
