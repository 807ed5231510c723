"""Dygraph capture: a stable imperative step as one CUDA graph.

Counterpart of paddle_tpu/dygraph/jit.py, where the step becomes one
jitted XLA executable a signature. Every dygraph op (forward, tape
backward, optimizer update) is a lowering that reads and replaces
VarBase values, so a whole user step, `loss.backward()` and
`optimizer.minimize(...)` included, can be captured once its state is
known:

    captured = dygraph.jit.capture(step_fn, optimizer=opt)
    for batch in data:
        loss = captured(x, y)       # one graph replay a step

The first call discovers the state without a real step: the tracer runs
the step in abstract mode (every lowering on meta tensors), so lazily
created parameters and optimizer accumulators materialize with their
real initial values and no update is applied; the value an abstract
output replaced is restored from the tracer's snapshot. The state is the
tracer's parameters, the optimizer's accumulators and `extra_state`.

On a CUDA device each input signature then gets one torch.cuda.CUDAGraph
(core/cuda_graph.py, shared with the engine's captured blocks): the step
runs twice on a side stream on clones of the state (kernel
builds, library handles, workspaces and algorithm choices happen there),
then is captured under sync debug mode "error" (a host sync in the step
raises) reading static input buffers and the state tensors, and ends by
copying each new parameter and accumulator value into its tensor (the
counterpart of the JAX capture's donated state). A call copies its
arguments into the static inputs, replays the graph and returns clones
of the outputs. Random ops draw from the tracer's generator, registered
with the graph so that every replay draws anew; where torch cannot
register it, a step that draws makes the capture raise. Python-side
launch counters tick when the step is captured, not at replay. On a CPU
device there is no graph: each call runs the eager step, with the same
counters (the device decides this), and a LearningRateDecay advances at
a signature's first call only, as where the step is captured.

Constraints: the step must keep its shapes and control flow, must not
read a value on the host (`.numpy()`, `.item()`), must not copy host
data to the card, and a LearningRateDecay advances only when the step is
captured (the rate is baked into the graph). Gradients are consumed
inside the step: `param.gradient()` is None between captured calls. A
parameter replaced between calls (set_value, set_dict) is copied into
the graph's tensor at the next call.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import cuda_graph
from .tracer import VarBase

__all__ = ["capture", "CapturedFunction"]


def _flatten(outs):
    """(leaf VarBases or values, a rebuild function) of a step's output:
    a VarBase, a value, or tuples, lists and dicts of them."""
    if isinstance(outs, (tuple, list)):
        parts = [_flatten(o) for o in outs]
        leaves = [x for p in parts for x in p[0]]

        def rebuild(it, parts=parts, kind=type(outs)):
            return kind(p[1](it) for p in parts)
        return leaves, rebuild
    if isinstance(outs, dict):
        keys = list(outs)
        leaves, rebuild = _flatten([outs[k] for k in keys])
        return leaves, lambda it: dict(zip(keys, rebuild(it)))
    return [outs], lambda it: next(it)


def _value(o):
    if isinstance(o, VarBase):
        return o.value
    if isinstance(o, torch.Tensor):
        return o
    return torch.as_tensor(np.asarray(o))


class _Graph:
    """One captured signature: the graph, its static inputs, the output
    tensors it writes, the rebuild of the output structure, and the
    replays made."""

    __slots__ = ("graph", "inputs", "outputs", "rebuild", "replays")

    def __init__(self, graph, inputs, outputs, rebuild):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.rebuild = rebuild
        self.replays = 0

    def __call__(self, args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        self.replays += 1
        return self.rebuild(iter(VarBase(t.clone(), stop_gradient=True)
                                 for t in self.outputs))


class CapturedFunction:
    def __init__(self, fn, optimizer=None, extra_state=None,
                 device=None, amp=False, amp_dtype="bfloat16",
                 amp_lists=None):
        self.fn = fn
        self.optimizer = optimizer
        self.extra_state = dict(extra_state or {})
        # the dygraph tracer runs ops through the same ExecContext as
        # graph mode, so the central AMP policy (core/amp.py) around the
        # step gives its bf16 activation stream and float32 master
        # parameters to forward, tape backward and update alike
        self.amp = bool(amp)
        self._amp_dtype = torch.float16 \
            if amp_dtype in ("float16", "fp16") else torch.bfloat16
        if amp_lists is None:
            from ..contrib.mixed_precision.fp16_lists import \
                AutoMixedPrecisionLists
            amp_lists = AutoMixedPrecisionLists()
        self._amp_black = frozenset(amp_lists.black_list)
        self._amp_white = frozenset(amp_lists.white_list)
        # where the step runs after discovery (a torch.device or Place);
        # None is the tracer's device
        self.device = device
        self._state: Optional[Dict[str, VarBase]] = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
        self._cache: Dict[Any, Any] = {}
        self.captured_calls = 0
        self.eager_calls = 0

    # ---- state discovery ------------------------------------------------
    def _collect_state(self, tracer) -> Dict[str, VarBase]:
        state: Dict[str, VarBase] = {}
        for n, vb in tracer._params.items():
            state[f"p:{n}"] = vb
        if self.optimizer is not None:
            for acc_name, per_param in \
                    self.optimizer._accumulators.items():
                for p_name, vb in per_param.items():
                    if isinstance(vb, VarBase):
                        state[f"a:{acc_name}:{p_name}"] = vb
        for n, vb in self.extra_state.items():
            state[f"x:{n}"] = vb
        return state

    def _target(self, tracer) -> torch.device:
        d = self.device
        if d is None:
            return tracer.device
        return d.torch_device() if hasattr(d, "torch_device") \
            else torch.device(d)

    def _discover_state(self, tracer, arrs):
        """Run the step in the tracer's abstract mode (see the module
        docstring) on meta inputs shaped like `arrs`, then collect the
        state with the concrete values the abstract outputs replaced."""
        self.eager_calls += 1   # discovery stands for the eager call
        old_tape, tracer._tape = tracer._tape, []
        try:
            with tracer.abstract() as snap, self._amp_cm():
                self.fn(*[VarBase(torch.empty(a.shape, dtype=a.dtype,
                                              device="meta"),
                                  stop_gradient=True) for a in arrs])
        finally:
            tracer._tape = old_tape
        state = self._collect_state(tracer)
        device = self._target(tracer)
        for name, vb in state.items():
            if vb.value.device.type == "meta":
                if id(vb) not in snap:
                    raise RuntimeError(f"capture: state {name} has no "
                                       f"concrete value")
                vb.value = snap[id(vb)]
            vb.grad = None
            vb.value = vb.value.to(device)
        lr = getattr(self.optimizer, "_learning_rate_map", {}).get("dygraph")
        if lr is not None:
            lr.value = lr.value.to(device)
        self._state = state

    def _amp_cm(self):
        if not self.amp:
            return contextlib.nullcontext()
        from ..core.amp import amp_guard
        return amp_guard(True, self._amp_dtype, self._amp_black,
                         self._amp_white)

    # ---- the step ---------------------------------------------------------
    def _run_step(self, tracer, ins):
        """The step, eagerly, on a tape of its own; returns its outputs.
        Gradients live inside the step."""
        old_tape, tracer._tape = tracer._tape, []
        try:
            with self._amp_cm():
                outs = self.fn(*[VarBase(a, stop_gradient=True)
                                 for a in ins])
        finally:
            tracer._tape = old_tape
        for vb in self._state.values():
            vb.grad = None
        return outs

    def _sync_state(self):
        """Copy a state value replaced since the last call into the
        graph's tensor."""
        def repoint(n, t):
            self._state[n].value = t
        cuda_graph.sync_state(self._static,
                              lambda n: self._state[n].value, repoint)

    def _lr_decay(self):
        from .learning_rate_scheduler import LearningRateDecay
        lr = getattr(self.optimizer, "_learning_rate", None)
        return lr if isinstance(lr, LearningRateDecay) else None

    def _capture(self, tracer, ins):
        """One CUDA graph of the step for the signature of `ins`
        (core/cuda_graph.py: warm-up on clones of the state, capture,
        the new state copied into the graph's tensors)."""
        names = list(self._state)
        state = [self._state[n] for n in names]
        static = [self._static[n] for n in names]
        static_ins = [a.clone() for a in ins]
        decay = self._lr_decay()
        step_num = decay.step_num if decay is not None else None

        def warm():
            for vb, t in zip(state, static):
                vb.value = t.clone()
            self._run_step(tracer, static_ins)

        def step():
            outs = self._run_step(tracer, static_ins)
            cuda_graph.copy_back(self._static,
                                 lambda n: self._state[n].value)
            return outs

        try:
            cuda_graph.warm_up(warm, tracer.device)
            for vb, t in zip(state, static):
                vb.value = t
            if decay is not None:
                decay.step_num = step_num   # advance once, at capture
            gen = tracer._run.generator
            drawn = gen.get_state()
            tracer._run.capturing = True
            try:
                graph, outs = cuda_graph.capture(step, (gen,))
            finally:
                tracer._run.capturing = False
            if not cuda_graph.can_register() and \
                    not torch.equal(drawn, gen.get_state()):
                raise RuntimeError(
                    "capture: the step draws random numbers, and this "
                    "torch cannot register the tracer's generator with a "
                    "CUDA graph, so every replay would draw the same ones")
        finally:
            for vb, t in zip(state, static):
                vb.value, vb.grad = t, None
        leaves, rebuild = _flatten(outs)
        return _Graph(graph, static_ins, [_value(o) for o in leaves],
                      rebuild)

    # ---- call ------------------------------------------------------------
    def __call__(self, *args):
        from .. import framework
        tracer = framework._dygraph_tracer()
        assert tracer is not None, \
            "captured function must run under dygraph.guard()"
        device = self._target(tracer)
        ins = [_value(a).to(device) for a in args]
        if self._state is None:
            self._discover_state(tracer, ins)
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in ins)
        with tracer.on_device(device):
            if device.type == "cuda":
                if self._static is None:
                    self._static = {n: vb.value
                                    for n, vb in self._state.items()}
                self._sync_state()
                entry = self._cache.get(sig)
                if entry is None:
                    entry = self._cache[sig] = self._capture(tracer, ins)
                outs = entry(ins)
            else:
                # a schedule advances at a signature's first call only,
                # as when the step is captured
                decay = self._lr_decay()
                step_num = self._cache.setdefault(
                    sig, decay.step_num if decay is not None else None)
                if decay is not None:
                    decay.step_num = step_num
                leaves, rebuild = _flatten(self._run_step(tracer, ins))
                outs = rebuild(iter(VarBase(_value(o), stop_gradient=True)
                                    for o in leaves))
        self.captured_calls += 1
        return outs


def capture(fn=None, optimizer=None, extra_state=None, device=None,
            amp=False, amp_dtype="bfloat16", amp_lists=None):
    """Decorator or factory: `capture(step_fn, optimizer=opt)` or

        @dygraph.jit.capture(optimizer=opt, amp=True)
        def step(x, y): ...

    amp=True runs the step under the central mixed-precision policy (bf16
    activation stream, float32 master parameters: what
    contrib.mixed_precision.decorate gives the graph path)."""
    if fn is None:
        def deco(f):
            return CapturedFunction(f, optimizer, extra_state, device,
                                    amp, amp_dtype, amp_lists)
        return deco
    return CapturedFunction(fn, optimizer, extra_state, device, amp,
                            amp_dtype, amp_lists)
