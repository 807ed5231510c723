"""Dygraph tracer: eager op execution and the autograd tape.

Counterpart of paddle_tpu/dygraph/tracer.py. trace_op runs an op's
lowering at once on the tracer's device, through the same ExecContext as
graph mode (and so under the same AMP policy and kernel registry); when
an input needs a gradient it records a tape entry. run_backward replays
the grad lowerings of core/registry.py over the tape in reverse, each
op's hand-written grad or else the generic vector-Jacobian product: one
grad registry for both modes, so dygraph and graph gradients agree.

As in the engine, a taped op leaves a forward record for its grad op: an
op with the generic gradient runs with its differentiated inputs as
autograd leaves (run_forward_for_vjp), an op with a hand-written one
keeps what its grad needs (ExecContext.wants_record); the grad op
consumes the record, so no forward runs twice.

Random ops without a fixed seed draw from the tracer's generator, in the
order they run. In abstract mode (dygraph.jit.capture's discovery) every
lowering runs on meta tensors, so nothing runs on the device, while
parameters and optimizer accumulators are created with their real
values; the backward then gives each gradient its primal's shape and
dtype without running a grad lowering, and the value an op's output
overwrites is kept (`_snap`) so that the capture can restore its state.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.registry import (GRAD_SUFFIX, INPUT_WRITES, OP_UID_ATTR, OPS,
                             ExecContext, RunState, _SlotView,
                             has_generic_grad, run_forward_for_vjp)
from ..core.scope import tensor_to_numpy
from ..core.selected_rows import is_selected_rows
from ..core.types import convert_dtype, dtype_to_torch
from ..framework import unique_name

__all__ = ["Tracer", "VarBase"]

_META = torch.device("meta")


def _is_float(t) -> bool:
    return t is not None and t.is_floating_point()


class VarBase:
    """An eager tensor with its autograd metadata: `value` is a
    torch.Tensor (None until the op that makes it has run), `grad` the
    gradient run_backward left (a tensor, or a SelectedRows from a
    sparse lookup_table)."""

    __slots__ = ("name", "value", "stop_gradient", "grad",
                 "persistable", "trainable")

    def __init__(self, value, name=None, stop_gradient=False,
                 persistable=False):
        self.name = name or unique_name.generate("dy_var")
        self.value = value
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.trainable = not stop_gradient
        self.grad = None

    # -- fluid Variable surface --------------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return convert_dtype(self.value.dtype)

    def numpy(self):
        """A host copy (bf16 comes back as float32: numpy has none)."""
        return tensor_to_numpy(self.value)

    _numpy = numpy

    def detach(self):
        """A VarBase that needs no gradient, holding a copy: the update
        kernels write parameters in place, and the detached value must
        not follow them."""
        return VarBase(self.value.detach().clone(), stop_gradient=True)

    def backward(self, backward_strategy=None):
        from .. import framework
        tracer = framework._dygraph_tracer()
        assert tracer is not None, "backward() outside dygraph guard"
        tracer.run_backward(self)

    def gradient(self):
        g = self.grad
        if g is None or is_selected_rows(g):
            return g
        return tensor_to_numpy(g)

    def clear_gradient(self):
        self.grad = None

    def set_value(self, value):
        """Replace the value (it is not written in place: another VarBase
        may share the tensor). A numpy value takes the current value's
        device and dtype."""
        if isinstance(value, VarBase):
            value = value.value
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        old = self.value
        if isinstance(old, torch.Tensor) and old.device.type != "meta":
            value = value.to(device=old.device, dtype=old.dtype)
        elif value.dtype == torch.float64:
            value = value.float()
        self.value = value

    def astype(self, dtype):
        from .. import framework
        return framework._dygraph_tracer().trace_op(
            "cast", {"X": self}, {"Out": None},
            {"in_dtype": self.dtype,
             "out_dtype": convert_dtype(dtype)})["Out"][0]

    def _binary(self, other, op, reverse=False):
        from .. import framework
        tracer = framework._dygraph_tracer()
        if not isinstance(other, VarBase):
            other = VarBase(tracer._constant(other, self.value),
                            stop_gradient=True)
        a, b = (other, self) if reverse else (self, other)
        return tracer.trace_op(op, {"X": a, "Y": b}, {"Out": None},
                               {"axis": -1})["Out"][0]

    def __add__(self, o): return self._binary(o, "elementwise_add")
    def __radd__(self, o): return self._binary(o, "elementwise_add", True)
    def __sub__(self, o): return self._binary(o, "elementwise_sub")
    def __rsub__(self, o): return self._binary(o, "elementwise_sub", True)
    def __mul__(self, o): return self._binary(o, "elementwise_mul")
    def __rmul__(self, o): return self._binary(o, "elementwise_mul", True)
    def __truediv__(self, o): return self._binary(o, "elementwise_div")

    def __repr__(self):
        return f"VarBase(name={self.name}, shape={self.shape})"


class _TapeEntry:
    __slots__ = ("op_view", "inputs", "outputs")

    def __init__(self, op_view, inputs, outputs):
        self.op_view = op_view
        self.inputs = inputs    # slot -> [VarBase]
        self.outputs = outputs  # slot -> [VarBase]


_uid = [1 << 20]  # a uid space apart from graph mode's


def _meta(t):
    if isinstance(t, torch.Tensor) and t.device.type != "meta":
        return torch.empty_like(t, device=_META)
    return t


class Tracer:
    """Eager executor and tape on one Place. Its generator, which
    parameter initializers and random ops draw from, is seeded from
    numpy's global generator, as the JAX tracer takes its key: seed
    numpy for a reproducible build."""

    def __init__(self, place):
        self.place = place
        self.device = place.torch_device()
        self._tape: List[_TapeEntry] = []
        self._no_grad = False
        self._abstract = False
        self._snap: Dict[int, torch.Tensor] = {}
        self._seed = int(np.random.randint(0, 2 ** 31))
        self._generators: Dict[torch.device, torch.Generator] = {}
        self._run = RunState(generator=self._generator_on(self.device))
        self._run.grad_uids = set()
        self._params: Dict[str, VarBase] = {}
        # Layers inside forward(); a parameter created lazily registers
        # on the innermost one
        self._layer_stack: List[Any] = []

    def _generator_on(self, device):
        """The tracer's generator on `device` (one a device, each seeded
        from the tracer's seed)."""
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
            gen.manual_seed(self._seed)
        return gen

    # -- the reference Tracer's surface -------------------------------------
    def all_parameters(self):
        return list(self._params.values())

    def trace(self, op_type, inputs, outputs, attrs, place=None,
              stop_gradient=False):
        return self.trace_op(op_type, inputs, outputs, attrs)

    def trace_var(self, name, var):
        self._params.setdefault(name, var)
        return var

    def train_mode(self):
        self._no_grad = False

    def eval_mode(self):
        self._no_grad = True

    @contextlib.contextmanager
    def abstract(self):
        """Abstract mode (see the module docstring); yields the snapshot
        dict id(VarBase) -> the concrete value an op output replaced."""
        old = self._abstract, self._snap
        self._abstract, self._snap = True, {}
        try:
            yield self._snap
        finally:
            self._abstract, self._snap = old

    @contextlib.contextmanager
    def on_device(self, device):
        """Run ops on `device` (dygraph.jit.capture's `device=`), with a
        generator there seeded from the tracer's seed."""
        device = torch.device(device)
        if device == self.device:
            yield
            return
        old = self.device, self._run.generator
        self.device = device
        self._run.generator = self._generator_on(device)
        try:
            yield
        finally:
            self.device, self._run.generator = old

    # -- values ---------------------------------------------------------------
    def from_numpy(self, arr, name=None):
        if self._run.capturing:
            raise RuntimeError(
                "a captured step cannot copy host data to the card (a CUDA "
                "graph would read a host buffer that is gone by the next "
                "replay): pass the array as an argument of the step")
        return VarBase(torch.tensor(np.asarray(arr), device=self.device),
                       name=name, stop_gradient=False)

    def _constant(self, value, like):
        """A VarBase operand made from a Python scalar or an array, in
        the dtype of `like` (the other operand's tensor)."""
        if np.ndim(value) == 0:
            return torch.full((), float(value), dtype=like.dtype,
                              device=like.device)
        return self.from_numpy(np.asarray(value)).value.to(like.dtype)

    def _init_value(self, initializer, shape, dtype):
        """The initializer's value, drawn from the tracer's generator on
        its device (the JAX tracer's formulas: Xavier and MSRA take
        fan_in = prod(shape[1:]) and fan_out = shape[0], a 2-D shape
        (fan_in, fan_out) = shape)."""
        from ..initializer import (ConstantInitializer, MSRAInitializer,
                                   NormalInitializer, UniformInitializer,
                                   XavierInitializer)
        dt = dtype_to_torch(dtype)
        kw = {"generator": self._run.generator, "device": self.device,
              "dtype": torch.float32}
        if isinstance(initializer, ConstantInitializer):
            return torch.full(shape, initializer.value, dtype=dt,
                              device=self.device)
        if isinstance(initializer, UniformInitializer):
            lo, hi = initializer.low, initializer.high
            return (lo + (hi - lo) * torch.rand(shape, **kw)).to(dt)
        if isinstance(initializer, NormalInitializer):
            return (initializer.loc + initializer.scale *
                    torch.randn(shape, **kw)).to(dt)
        if isinstance(initializer, (XavierInitializer, MSRAInitializer)):
            fan_in = math.prod(shape[1:]) if len(shape) > 1 else shape[0]
            fan_out = shape[0]
            if len(shape) == 2:
                fan_in, fan_out = shape
            denom = fan_in + fan_out if isinstance(
                initializer, XavierInitializer) else fan_in
            if initializer.uniform:
                limit = math.sqrt(6.0 / denom)
                return (-limit + 2 * limit * torch.rand(shape, **kw)).to(dt)
            return (math.sqrt(2.0 / denom) * torch.randn(shape, **kw)).to(dt)
        raise TypeError(f"dygraph: initializer "
                        f"{type(initializer).__name__} is not ported")

    def create_parameter(self, attr, shape, dtype, initializer, is_bias):
        """A parameter VarBase, created once: Layers create parameters
        lazily in forward(), so the Nth create_parameter of a Layer's
        call returns the Nth parameter the Layer holds when its shape
        matches, though the helper generates a fresh name each call."""
        shape = [int(s) for s in shape]
        layer = self._layer_stack[-1] if self._layer_stack else None
        if layer is not None and (not attr.name or
                                  getattr(attr, "_generated", False)):
            idx = getattr(layer, "_param_create_idx", 0)
            existing = list(layer._parameters.values())
            layer._param_create_idx = idx + 1
            if idx < len(existing) and existing[idx].shape == tuple(shape):
                return existing[idx]
        name = attr.name or unique_name.generate("dy_param")
        if name in self._params:
            return self._params[name]
        p = VarBase(self._init_value(initializer, shape, dtype), name=name,
                    persistable=True)
        p.trainable = getattr(attr, "trainable", True)
        p.stop_gradient = not p.trainable
        self._params[name] = p
        if layer is not None:
            layer._parameters[name] = p
        return p

    # -- op execution ---------------------------------------------------------
    def _bind(self, op_type, inputs, outputs, attrs):
        """(op view, slot -> input VarBases, slot -> output VarBases) of
        one op; outputs: slot -> None | VarBase | [VarBase] | a count."""
        attrs = dict(attrs or {})
        attrs.setdefault(OP_UID_ATTR, _uid[0])
        _uid[0] += 1
        in_map: Dict[str, List[VarBase]] = {}
        for slot, v in (inputs or {}).items():
            if v is None:
                continue
            vs = v if isinstance(v, (list, tuple)) else [v]
            vs = [x if isinstance(x, VarBase) else
                  VarBase(self.from_numpy(x).value, stop_gradient=True)
                  for x in vs]
            if vs:
                in_map[slot] = vs
        out_map: Dict[str, List[VarBase]] = {}
        for slot, v in (outputs or {}).items():
            if v is None:
                out_map[slot] = [VarBase(None)]
            elif isinstance(v, int):
                out_map[slot] = [VarBase(None) for _ in range(v)]
            elif isinstance(v, (list, tuple)):
                out_map[slot] = [x if isinstance(x, VarBase) else
                                 VarBase(None) for x in v]
            else:
                out_map[slot] = [v]
        view = _SlotView(op_type,
                         {s: [vb.name for vb in vs]
                          for s, vs in in_map.items()},
                         {s: [vb.name for vb in vs]
                          for s, vs in out_map.items()}, attrs)
        return view, in_map, out_map

    def _env(self, in_map):
        env = {vb.name: vb.value for vs in in_map.values() for vb in vs}
        if self._abstract:
            env = {n: _meta(v) for n, v in env.items()}
        return env

    def _ctx(self, view, env):
        return ExecContext(view, env, _META if self._abstract
                           else self.device, self._run)

    def _write_outputs(self, out_map, env):
        """Each output VarBase takes its value from env; unbound optional
        outputs are pruned. In abstract mode the concrete value an output
        replaces is kept in _snap."""
        for vs in out_map.values():
            for vb in vs:
                if vb.name not in env:
                    continue
                old = vb.value
                if self._abstract and isinstance(old, torch.Tensor) and \
                        old.device.type != "meta":
                    self._snap.setdefault(id(vb), old)
                vb.value = env[vb.name]
        return {slot: [vb for vb in vs if vb.value is not None]
                for slot, vs in out_map.items()}

    def trace_op(self, op_type, inputs, outputs, attrs):
        """Run an op eagerly. inputs: slot -> VarBase | [VarBase] (a
        numpy value becomes a constant); outputs: slot -> None | VarBase
        | [VarBase] | a count. Returns slot -> [VarBase]."""
        info = OPS.get(op_type)
        view, in_map, out_map = self._bind(op_type, inputs, outputs, attrs)
        env = self._env(in_map)
        differentiable = not self._no_grad and not info.is_grad_op and \
            OPS.has(op_type + "_grad")
        taped = differentiable and any(
            not vb.stop_gradient for vs in in_map.values() for vb in vs)
        uid = view.attr(OP_UID_ATTR)
        if taped and not self._abstract and has_generic_grad(op_type):
            diff = frozenset(
                s for s, vs in in_map.items()
                if s not in info.no_grad_slots and
                any(not vb.stop_gradient and _is_float(vb.value)
                    for vb in vs))
            self._run.records[uid] = run_forward_for_vjp(
                op_type, view._inputs, view._outputs, view._attrs, diff,
                env, env, self.device, self._run)
        else:
            if taped and not self._abstract:
                self._run.grad_uids.add(uid)   # a hand-written grad
            with torch.no_grad():
                info.lowering(self._ctx(view, env))
        for s in INPUT_WRITES.get(op_type, ()):
            for vb in in_map.get(s, ()):
                vb.value = env[vb.name]
        out_map = self._write_outputs(out_map, env)
        if taped:
            for vs in out_map.values():
                for vb in vs:
                    vb.stop_gradient = False
            self._tape.append(_TapeEntry(view, in_map, out_map))
        elif differentiable:
            for vs in out_map.values():
                for vb in vs:
                    vb.stop_gradient = True
        return out_map

    def trace_ops(self, ops):
        """Run a list of ops, each (type, inputs, outputs, attrs), in
        order, as the engine runs a block's updates: a run of consecutive
        ops of a type with a group lowering (core/registry.py
        register_group) whose keys agree, none reading what an earlier
        one of the run writes, goes to that lowering in one call. Only
        ops without a gradient are grouped. Returns each op's outputs."""
        results = [None] * len(ops)
        i = 0
        while i < len(ops):
            info = OPS.get(ops[i][0])
            if info.group is None or OPS.has(ops[i][0] + "_grad"):
                results[i] = self.trace_op(*ops[i])
                i += 1
                continue
            key = info.group[0]
            bound = [self._bind(*ops[i])]
            k = key(bound[0][0])
            written = {n for ns in bound[0][0]._outputs.values() for n in ns}
            j = i + 1
            while j < len(ops) and ops[j][0] == ops[i][0]:
                b = self._bind(*ops[j])
                reads = {n for ns in b[0]._inputs.values() for n in ns}
                if key(b[0]) != k or written & reads:
                    break
                written.update(n for ns in b[0]._outputs.values()
                               for n in ns)
                bound.append(b)
                j += 1
            envs = [self._env(in_map) for _, in_map, _ in bound]
            with torch.no_grad():
                info.group[1]([self._ctx(view, env)
                               for (view, _, _), env in zip(bound, envs)])
            for n, ((_, _, out_map), env) in enumerate(zip(bound, envs)):
                results[i + n] = self._write_outputs(out_map, env)
            i = j
        return results

    # -- backward -------------------------------------------------------------
    def run_backward(self, loss: VarBase):
        """Gradients of `loss` for every VarBase on the tape that needs
        one, accumulated into .grad of the trainable ones; the tape and
        its records are cleared. Each entry is dropped once its grad op
        has run, and its outputs' gradients, which no earlier entry adds
        to, are settled then: the tape's activations and gradients are
        freed as the backward goes, not at its end."""
        grads: Dict[int, Any] = {id(loss): torch.ones_like(loss.value)}
        holders: Dict[int, VarBase] = {id(loss): loss}
        tape, self._tape = self._tape, []
        try:
            with torch.no_grad():
                while tape:
                    entry = tape.pop()
                    self._backward_entry(entry, grads, holders)
                    for vs in entry.outputs.values():
                        for vb in vs:
                            self._settle(vb, grads.pop(id(vb), None))
                            holders.pop(id(vb), None)
        finally:
            self._run.records.clear()
            self._run.grad_uids.clear()
        for vid, g in grads.items():
            self._settle(holders[vid], g)

    def _settle(self, vb, g):
        if g is not None and vb.trainable and not vb.stop_gradient:
            vb.grad = g if vb.grad is None or self._abstract \
                else vb.grad + g

    def _backward_entry(self, entry, grads, holders):
        """Run one tape entry's grad op (in abstract mode, give each
        gradient its primal's shape and dtype on the meta device)."""
        if not any(id(vb) in grads for vs in entry.outputs.values()
                   for vb in vs):
            return
        op = entry.op_view
        info = OPS.get(op.type)
        targets = [(s, vb) for s, vs in entry.inputs.items()
                   if s not in info.no_grad_slots for vb in vs
                   if not vb.stop_gradient and _is_float(vb.value)]
        if not targets:
            return
        if self._abstract:
            for _, vb in targets:
                grads[id(vb)] = torch.empty_like(vb.value, device=_META)
                holders[id(vb)] = vb
            return
        g_in = dict(op._inputs)
        env = {vb.name: vb.value for vs in entry.inputs.values()
               for vb in vs}
        for slot, vs in entry.outputs.items():
            g_in[slot] = [vb.name for vb in vs]
            names = []
            for vb in vs:
                env[vb.name] = vb.value
                g = grads.get(id(vb))
                if g is None:
                    names.append("")
                else:
                    env[vb.name + GRAD_SUFFIX] = g
                    names.append(vb.name + GRAD_SUFFIX)
            g_in[slot + GRAD_SUFFIX] = names
        wanted = {id(vb) for _, vb in targets}
        g_out = {s + GRAD_SUFFIX: [vb.name + GRAD_SUFFIX
                                   if id(vb) in wanted else "" for vb in vs]
                 for s, vs in entry.inputs.items()
                 if any(id(vb) in wanted for vb in vs) and
                 s not in info.no_grad_slots}
        g_view = _SlotView(op.type + "_grad", g_in, g_out, dict(op._attrs))
        OPS.get(op.type + "_grad").lowering(
            ExecContext(g_view, env, self.device, self._run))
        for _, vb in targets:
            g = env.get(vb.name + GRAD_SUFFIX)
            if g is None:
                continue
            cur = grads.get(id(vb))
            grads[id(vb)] = g if cur is None else cur + g
            holders[id(vb)] = vb
