"""Operator registry: one registration per op gives its lowering, its
shape inference (the lowering run on meta tensors) and its gradient.

Counterpart of paddle_tpu/core/registry.py. A lowering is a plain
function ``lowering(ctx)`` that reads torch.Tensors through an
ExecContext and sets its outputs; the engine calls it eagerly, op by op.

Registering op T also registers ``T_grad`` with the generic gradient: the
vector-Jacobian product of T's own lowering, taken by torch's reverse
mode. The slot conventions are the JAX package's: the grad op reads every
forward input and output slot under its own name and each output's
cotangent under ``<slot>@GRAD`` (an empty name or an unset value is a
zero cotangent), writes ``<slot>@GRAD`` for each forward input slot that
needs one (an empty name is a hole), and cotangents are cast to their
primal's dtype.

The JAX package recomputes every forward inside its grad op and leaves it
to XLA to merge the two. Eager torch has no such pass, so the port
records: when a forward op runs in a block that also holds its grad op
(same op uid), the engine runs the lowering with its differentiated
inputs as autograd leaves and keeps the result (a VjpRecord) by uid; the
grad op consumes the record once and drops it, so each forward runs once
per step. A grad op that finds no record recomputes the forward. torch's
reverse mode is used rather than torch.func.vjp: it takes the same
vector-Jacobian product at a fraction of the host time per call.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional, Sequence

import torch

from . import amp as _amp

# Attr name for the program-unique op id (seeds per-op randomness; a grad
# op keeps its forward op's uid).
OP_UID_ATTR = "__op_uid__"
GRAD_SUFFIX = "@GRAD"
RENAME_SEP = "@RENAME@"


class OpInfo:
    __slots__ = ("type", "lowering", "no_grad_slots", "is_grad_op")

    def __init__(self, type, lowering, no_grad_slots=(), is_grad_op=False):
        self.type = type
        self.lowering = lowering
        self.no_grad_slots = frozenset(no_grad_slots)
        self.is_grad_op = is_grad_op


class OpInfoMap:
    def __init__(self):
        self._map: Dict[str, OpInfo] = {}

    def insert(self, info: OpInfo):
        if info.type in self._map:
            raise ValueError(f"op '{info.type}' registered twice")
        self._map[info.type] = info

    def get(self, op_type: str) -> OpInfo:
        try:
            return self._map[op_type]
        except KeyError:
            raise NotImplementedError(
                f"op '{op_type}' is not registered in paddle_tpu_torch "
                f"({len(self._map)} ops are)") from None

    def has(self, op_type: str) -> bool:
        return op_type in self._map

    def types(self):
        return sorted(self._map)


OPS = OpInfoMap()


def register_op(op_type: str, *, no_grad_slots: Sequence[str] = ()):
    """Decorator registering a forward lowering ``fn(ctx)`` and, unless
    one exists, ``<op_type>_grad`` with the generic gradient."""
    def deco(fn):
        OPS.insert(OpInfo(op_type, fn, no_grad_slots=no_grad_slots))
        grad_type = op_type + "_grad"
        if not OPS.has(grad_type):
            OPS.insert(OpInfo(grad_type, generic_grad_lowering(op_type),
                              is_grad_op=True))
        return fn
    return deco


def register_no_grad_op(op_type: str):
    """Register an op that has no gradient (fills, optimizer updates)."""
    def deco(fn):
        OPS.insert(OpInfo(op_type, fn))
        return fn
    return deco


def override_grad_lowering(fwd_type: str):
    """Replace the generic ``<fwd_type>_grad`` lowering with a
    hand-written one."""
    def deco(fn):
        OPS.get(fwd_type + "_grad").lowering = fn
        return fn
    return deco


def has_generic_grad(fwd_type: str) -> bool:
    info = OPS._map.get(fwd_type + "_grad")
    return info is not None and \
        getattr(info.lowering, "_generic_vjp_of", None) == fwd_type


def op_seed(program_seed: int, uid: int, run: int = 0) -> int:
    """Seed of one random op, from the program's seed, the op's uid and
    the index of the run (per scope and program): two builds of one
    Program draw the same numbers, and each run draws new ones."""
    return zlib.crc32(f"{int(program_seed)}:{int(uid)}:{int(run)}".encode())


class RunState:
    """What one Executor run shares with its ops: the program seed, the
    run index, and the forward records the grad ops consume.
    `record_slots` maps the uid of each forward op whose generic grad op
    is in the block to the slots that grad op differentiates; `grad_uids`
    holds the uids of every grad op in the block."""

    __slots__ = ("program_seed", "run", "records", "record_slots",
                 "grad_uids")

    def __init__(self, program_seed=0, run=0, record_slots=None,
                 grad_uids=()):
        self.program_seed = program_seed
        self.run = run
        self.records: Dict[int, object] = {}
        self.record_slots = record_slots or {}
        self.grad_uids = frozenset(grad_uids)


class ExecContext:
    """Per-op view while a block runs. `env` maps var name -> tensor;
    `device` is where new tensors go (the meta device during build-time
    shape inference); `run` is the RunState (None outside an Executor
    run).

    Under amp_guard, input()/inputs()/set_output()/set_outputs() apply
    the mixed-precision policy of core/amp.py."""

    __slots__ = ("op", "env", "device", "run", "_amp_mode", "_amp_follow")

    def __init__(self, op, env, device: torch.device, run=None):
        self.op = op
        self.env = env
        self.device = device
        self.run = run
        self._amp_mode = _amp.op_mode(op.type)
        self._amp_follow = False
        if self._amp_mode == "gray":
            dt = _amp.amp_dtype()
            self._amp_follow = any(
                getattr(env.get(n), "dtype", None) == dt
                for s in op.input_slots() for n in op.input(s))

    # ---- inputs / outputs -------------------------------------------------
    def has_input(self, slot: str) -> bool:
        return bool(self.op.input(slot))

    def has_output(self, slot: str) -> bool:
        return bool(self.op.output(slot))

    def _cast_in(self, v):
        if self._amp_mode is None:
            return v
        return _amp.cast_in(self._amp_mode, v, self._amp_follow)

    def input(self, slot: str) -> Optional[torch.Tensor]:
        names = self.op.input(slot)
        if not names:
            return None
        if len(names) != 1:
            raise ValueError(f"op {self.op.type} input slot {slot} is "
                             f"multi-arg; use inputs()")
        return self._cast_in(self.env[names[0]])

    def inputs(self, slot: str):
        return [self._cast_in(self.env[n]) for n in self.op.input(slot)]

    def set_output(self, slot: str, value: torch.Tensor):
        names = self.op.output(slot)
        if not names:
            return  # optional output not bound
        if len(names) != 1:
            raise ValueError(f"{self.op.type}.{slot} is multi-arg")
        if self._amp_mode is not None:
            value = _amp.cast_out(self._amp_mode, value)
        self.env[names[0]] = value

    def set_outputs(self, slot: str, values):
        names = self.op.output(slot)
        if len(names) != len(values):
            raise ValueError(f"{self.op.type}.{slot}: {len(names)} names "
                             f"for {len(values)} values")
        for n, v in zip(names, values):
            if self._amp_mode is not None:
                v = _amp.cast_out(self._amp_mode, v)
            self.env[n] = v

    # ---- attrs ------------------------------------------------------------
    def attr(self, name: str, default=None):
        return self.op.attr(name, default)

    # ---- randomness -------------------------------------------------------
    def _seed(self) -> int:
        seed = self.op.attr("seed", 0)
        if seed:
            return int(seed)   # a fixed seed draws the same every run
        run = self.run
        return op_seed(run.program_seed if run else 0,
                       self.op.attr(OP_UID_ATTR, 0), run.run if run else 0)

    def generator(self) -> Optional[torch.Generator]:
        """A generator on the op's device, seeded from the op's `seed`
        attr when nonzero, else from the program seed, the op uid and
        the run index. A grad op has its forward's uid, so it draws what
        its forward drew. None on the meta device, where nothing is
        drawn."""
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seed())
        return g

    def seed_words(self):
        """Two uint32 words from the same seed, made on the host (no
        device round trip): the seed of an in-kernel hash."""
        g = torch.Generator()
        g.manual_seed(self._seed())
        w = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=g)
        return int(w[0]), int(w[1])

    # ---- forward records --------------------------------------------------
    def wants_record(self) -> bool:
        """True when this forward op's grad op runs later in the block:
        the lowering may then leave what the grad op needs with
        record()."""
        run = self.run
        return run is not None and \
            self.op.attr(OP_UID_ATTR, 0) in run.grad_uids

    def record(self, value):
        self.run.records[self.op.attr(OP_UID_ATTR, 0)] = value

    def take_record(self):
        """The record the forward op of this grad op left, or None. It is
        removed: each record is used once."""
        if self.run is None:
            return None
        return self.run.records.pop(self.op.attr(OP_UID_ATTR, 0), None)


# ---------------------------------------------------------------------------
# generic gradient: the vector-Jacobian product of the forward lowering
# ---------------------------------------------------------------------------

class _SlotView:
    """Op view that runs a forward lowering on local names: same type
    and attrs, inputs and outputs remapped."""

    __slots__ = ("type", "_inputs", "_outputs", "_attrs")

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self._inputs = inputs
        self._outputs = outputs
        self._attrs = attrs

    def input(self, slot):
        return self._inputs.get(slot, [])

    def output(self, slot):
        return self._outputs.get(slot, [])

    def input_slots(self):
        return list(self._inputs)

    def output_slots(self):
        return list(self._outputs)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)

    def all_attrs(self):
        return {k: v for k, v in self._attrs.items()
                if not k.startswith("__")}


class VjpRecord:
    """A forward op's result with its autograd graph: `leaves` are the
    differentiated inputs by (slot, index), `outs` the outputs by
    (slot, index)."""

    __slots__ = ("leaves", "outs")

    def __init__(self, leaves, outs):
        self.leaves = leaves
        self.outs = outs


def run_forward_for_vjp(fwd_type, inputs, outputs, attrs, diff_slots,
                        env_in, env_out, device, run) -> VjpRecord:
    """Run forward lowering `fwd_type` on env_in[inputs] with the float
    inputs of `diff_slots` as autograd leaves; write the detached outputs
    to env_out under the names in `outputs` (slot -> names). Returns the
    VjpRecord."""
    local, in_map, leaves = {}, {}, {}
    for s, names in inputs.items():
        in_map[s] = []
        for i, n in enumerate(names):
            ln = f"{s}:{i}"
            v = env_in[n]
            if s in diff_slots and v.is_floating_point():
                v = v.detach().requires_grad_(True)
                leaves[(s, i)] = v
            local[ln] = v
            in_map[s].append(ln)
    out_map = {s: [f"{s}@out:{i}" for i in range(len(names))]
               for s, names in outputs.items()}
    view = _SlotView(fwd_type, in_map, out_map, attrs)
    with torch.enable_grad():
        OPS.get(fwd_type).lowering(ExecContext(view, local, device, run))
    outs = {}
    for s, names in outputs.items():
        for i, (ln, n) in enumerate(zip(out_map[s], names)):
            val = local.get(ln)
            if val is None:
                continue
            outs[(s, i)] = val
            env_out[n] = val.detach()
    return VjpRecord(leaves, outs)


def _grad_op_slots(op):
    """(forward output slots, forward input slots, differentiated slots)
    of a grad op's desc."""
    out_slots = sorted({s[:-len(GRAD_SUFFIX)] for s in op.input_slots()
                        if s.endswith(GRAD_SUFFIX)})
    fwd_in = [s for s in op.input_slots()
              if not s.endswith(GRAD_SUFFIX) and s not in out_slots]
    diff = [s for s in fwd_in if any(op.output(s + GRAD_SUFFIX))]
    return out_slots, fwd_in, diff


def grad_diff_slots(grad_op):
    return _grad_op_slots(grad_op)[2]


def generic_grad_lowering(fwd_type: str):
    """The lowering of `<fwd_type>_grad`: consume the forward's record
    (or recompute it from the grad op's bindings) and pull the
    cotangents back through it."""

    def grad_lowering(ctx: ExecContext):
        op = ctx.op
        out_slots, fwd_in, diff = _grad_op_slots(op)
        rec = ctx.take_record()
        if rec is None:
            outputs = {s: op.input(s) or [f"__{s}"] for s in out_slots}
            attrs = {k: v for k, v in op._attrs.items()}
            rec = run_forward_for_vjp(
                fwd_type, {s: op.input(s) for s in fwd_in}, outputs,
                attrs, frozenset(diff), ctx.env, {}, ctx.device, ctx.run)
        outs, cts = [], []
        for (s, i), out in rec.outs.items():
            if not out.requires_grad:
                continue
            g_names = op.input(s + GRAD_SUFFIX)
            g = ctx.env.get(g_names[i]) if i < len(g_names) and \
                g_names[i] else None
            if g is None:
                continue   # a missing cotangent is zero
            outs.append(out)
            cts.append(g if g.dtype == out.dtype else g.to(out.dtype))
        wanted = [(s, i) for s in diff
                  for i, n in enumerate(op.output(s + GRAD_SUFFIX))
                  if n and (s, i) in rec.leaves]
        grads = [None] * len(wanted)
        if outs and wanted:
            grads = torch.autograd.grad(
                outs, [rec.leaves[k] for k in wanted], cts,
                allow_unused=True)
        for (s, i), g in zip(wanted, grads):
            if g is None:
                g = torch.zeros_like(rec.leaves[(s, i)])
            ctx.env[op.output(s + GRAD_SUFFIX)[i]] = g.detach()

    grad_lowering.__name__ = f"{fwd_type}_grad_lowering"
    grad_lowering._generic_vjp_of = fwd_type
    return grad_lowering
