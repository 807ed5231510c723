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

import numpy as np
import torch

from . import amp as _amp

# Attr name for the program-unique op id (seeds per-op randomness; a grad
# op keeps its forward op's uid).
OP_UID_ATTR = "__op_uid__"
GRAD_SUFFIX = "@GRAD"
RENAME_SEP = "@RENAME@"


class OpInfo:
    """One op type. `group`, where set (register_group), is
    ``(key(op), lowering(ctxs))``: the engine hands a run of consecutive
    ops of this type with equal keys to ``lowering`` in one call. The
    engine's plans fix which ops a group takes, so setting `group`
    advances OPS.generation, which keys them."""

    __slots__ = ("type", "lowering", "no_grad_slots", "is_grad_op",
                 "_group")

    def __init__(self, type, lowering, no_grad_slots=(), is_grad_op=False):
        self.type = type
        self.lowering = lowering
        self.no_grad_slots = frozenset(no_grad_slots)
        self.is_grad_op = is_grad_op
        self._group = None

    @property
    def group(self):
        return self._group

    @group.setter
    def group(self, value):
        self._group = value
        OPS.generation += 1


class OpInfoMap:
    """Op type -> OpInfo. `generation` counts the group lowerings set
    (OpInfo.group), which change the engine's plans."""

    def __init__(self):
        self._map: Dict[str, OpInfo] = {}
        self.generation = 0

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


# op type -> the input slots whose vars its lowering writes back, by
# rebinding ctx.env under the input's name (spectral_norm's power
# iteration vectors): the engine keeps them as written persistables, the
# dygraph tracer updates their VarBases
INPUT_WRITES: Dict[str, tuple] = {}


def written_names(op):
    """The var names op writes: its outputs, then the inputs of the
    slots its type writes back (INPUT_WRITES)."""
    names = list(op.output_arg_names)
    for s in INPUT_WRITES.get(op.type, ()):
        names.extend(n for n in op.input(s) if n not in names)
    return names


def register_no_grad_op(op_type: str):
    """Register an op that has no gradient (fills, optimizer updates)."""
    def deco(fn):
        OPS.insert(OpInfo(op_type, fn))
        return fn
    return deco


def register_group(op_type: str, key):
    """Decorator registering ``fn(ctxs)``, the lowering of a run of
    consecutive ``op_type`` ops whose ``key(op)`` agree (and none of which
    reads what an earlier one of the run writes): the port's counterpart
    of the JAX package compiling a block's updates into one executable,
    where a kernel can take the whole run in one launch. Each op must
    give the same result as through its own lowering."""
    def deco(fn):
        OPS.get(op_type).group = (key, fn)
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


class GraphRandom:
    """The random state of a block the engine captures as a CUDA graph
    (core/engine.py): one generator and one device seed tensor for each
    draw of a run, made at the first warm-up run and kept for the
    graph's life, so that a replay reads them where the capture did.
    A draw is keyed by (kind, seed source, occurrence): the source is
    the op's fixed `seed` attr or its uid, and the occurrence counts the
    draws of that source in one run, so a grad op that draws again for
    its forward's uid (no record) gets a generator of its own, seeded as
    its forward's: in eager runs each draw is a fresh generator, and a
    second draw from one graph generator would advance its offset.

    Before each replay, prepare(r) re-seeds every generator for run
    index r (a registered generator replays from the seed and offset it
    holds then) and writes every seed tensor with the words of run r,
    from the host derivation the eager run uses (op_seed): a captured run
    with index r draws the masks of the eager run with index r. The seed
    tensors are rows of one int64 [N, 2] buffer (seal()), written by one
    copy from pinned host memory."""

    def __init__(self, program_seed, device):
        self.program_seed = program_seed
        self.device = device
        self.generators: Dict[tuple, torch.Generator] = {}
        self.slots: Dict[tuple, torch.Tensor] = {}
        self.sealed = False
        self._buf = None

    def _new(self, key):
        if self.sealed:
            raise RuntimeError(
                f"capture: a random draw ({key[0]} of {key[1]}) that no "
                f"warm-up run made")

    def seed_of(self, source, run):
        kind, value = source
        return value if kind == "seed" else \
            op_seed(self.program_seed, value, run)

    def generator(self, key, seed):
        g = self.generators.get(key)
        if g is None:
            self._new(key)
            g = self.generators[key] = torch.Generator(device=self.device)
            g.manual_seed(seed)
        return g

    def seed_slot(self, key, words):
        t = self.slots.get(key)
        if t is None:
            self._new(key)
            t = self.slots[key] = torch.tensor(
                words, dtype=torch.int64).to(self.device)
        return t

    def seal(self):
        """After the warm-up runs: no new draw; the seed tensors become
        rows of one buffer."""
        self.sealed = True
        if self.slots:
            keys = list(self.slots)
            self._buf = torch.stack([self.slots[k] for k in keys])
            self.slots = dict(zip(keys, self._buf.unbind(0)))

    def prepare(self, run):
        """Re-seed the generators and rewrite the seed tensors for run
        index `run`, on the current stream, with no host sync: the words
        go to the card through pinned memory that the caching host
        allocator keeps until the copy is done."""
        for (_, source, _), g in self.generators.items():
            g.manual_seed(self.seed_of(source, run))
        if self._buf is None:
            return
        host = torch.tensor([op_seed_words(self.seed_of(source, run))
                             for _, source, _ in self.slots],
                            dtype=torch.int64)
        if self.device.type == "cuda":
            self._buf.copy_(host.pin_memory(), non_blocking=True)
        else:
            self._buf.copy_(host)


class HostTableCache:
    """The tensors that one engine plan's ops build from host data, by
    (kind, key, device): the index tables derived from LoD offsets
    (gather and scatter tables, masks, segment ids, rank-table orders)
    and the constants of op attrs (assign_value, tensor_array_to_tensor's
    OutIndex). Made at the plan's first run, before any capture, and
    read by every later run and by the captured graph, so that no run
    after the first copies one to the card. `built` counts the tensors
    made (the meta device's excepted)."""

    __slots__ = ("tensors", "built")

    def __init__(self):
        self.tensors: Dict[tuple, torch.Tensor] = {}
        self.built = 0


class RunState:
    """What one Executor run shares with its ops: the program seed, the
    run index, and the forward records the grad ops consume.
    `record_slots` maps the uid of each forward op whose generic grad op
    is in the block to the slots that grad op differentiates; `grad_uids`
    holds the uids of every grad op in the block. `graph`, set while the
    engine warms up, captures or replays a block (capture mode), is the
    block's GraphRandom: the random ops draw from its generators and
    seed tensors, counted per source in `draws`. `lod_env` maps a var
    name to its LoD (host offsets: the feeds', then what the ops set or
    share), and `host_tables` is the plan's HostTableCache (None: a host
    table is made at each use). `blocks` runs a sub-block of the
    program (the engine's SubBlocks: blocks(idx, env, device, run)), for
    the control-flow ops (ExecContext.block_runner); None outside an
    engine run.

    The dygraph tracer keeps one RunState for all its ops: `generator`
    is then its own generator, which every random op without a fixed
    seed draws from in turn, and `capturing` is set while a CUDA graph
    captures a step (dygraph/jit.py)."""

    __slots__ = ("program_seed", "run", "records", "record_slots",
                 "grad_uids", "generator", "capturing", "graph", "draws",
                 "lod_env", "host_tables", "blocks")

    def __init__(self, program_seed=0, run=0, record_slots=None,
                 grad_uids=(), generator=None, graph=None, lod_env=None,
                 host_tables=None, blocks=None):
        self.program_seed = program_seed
        self.run = run
        self.records: Dict[int, object] = {}
        self.record_slots = record_slots or {}
        self.grad_uids = frozenset(grad_uids)
        self.generator = generator
        self.capturing = False
        self.graph = graph
        self.draws: Dict[tuple, int] = {}
        self.lod_env = {} if lod_env is None else lod_env
        self.host_tables = host_tables
        self.blocks = blocks


def op_seed_words(seed: int):
    """The two uint32 words of an in-kernel hash seed, from one op seed,
    made on the host."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    w = torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=g)
    return int(w[0]), int(w[1])


def seed_tensor(words, device) -> torch.Tensor:
    """Two seed words as the attention kernels read them: int64 [2] on
    `device`, each holding a uint32; to a card through pinned memory,
    with no host sync."""
    host = torch.tensor([int(w) & 0xFFFFFFFF for w in words],
                        dtype=torch.int64)
    device = torch.device(device)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


class ExecContext:
    """Per-op view while a block runs. `env` maps var name -> tensor;
    `device` is where new tensors go (the meta device during build-time
    shape inference); `run` is the RunState (None outside an Executor
    run).

    Under amp_guard, input()/inputs()/set_output()/set_outputs() apply
    the mixed-precision policy of core/amp.py. `lod_env` maps var names
    to their LoD (None: the run's, RunState.lod_env, or none outside a
    run)."""

    __slots__ = ("op", "env", "device", "run", "lod_env", "_amp_mode",
                 "_amp_follow")

    def __init__(self, op, env, device: torch.device, run=None,
                 lod_env=None):
        self.op = op
        self.env = env
        self.device = device
        self.run = run
        if lod_env is None:
            lod_env = run.lod_env if run is not None else {}
        self.lod_env = lod_env
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

    # ---- sub-blocks (control flow) -----------------------------------------
    @property
    def block_runner(self):
        """runner(idx, env=None): run the ops of sub-block `idx` of the
        program on `env` (None: this op's env) on this op's device, in
        this run, and return the env (the JAX ExecContext's
        block_runner). Sub-blocks run only inside an engine run."""
        blocks = self.run.blocks if self.run is not None else None
        if blocks is None:
            raise RuntimeError(f"{self.op.type}: a sub-block runs only "
                               f"inside an Executor run")
        own, device, run = self.env, self.device, self.run

        def runner(idx, env=None):
            env = own if env is None else env
            blocks(idx, env, device, run)
            return env
        return runner

    # ---- LoD (ragged metadata, host side) ----------------------------------
    def get_lod(self, slot_or_name: str):
        """The LoD of the first var of input slot `slot_or_name` (or of
        the var of that name): a list of offset levels, [] for none."""
        names = self.op.input(slot_or_name)
        name = names[0] if names else slot_or_name
        return self.lod_env.get(name, [])

    def set_lod(self, slot_or_name: str, lod):
        names = self.op.output(slot_or_name)
        name = names[0] if names else slot_or_name
        self.lod_env[name] = [list(map(int, lv)) for lv in lod]

    def host_table(self, kind: str, key, build) -> torch.Tensor:
        """The tensor on the op's device of the numpy array `build()`
        makes from host data (LoD offsets or op attrs): an index, mask or
        segment table, or a constant. `key`
        (hashable: the offsets and whatever else fixes the array) with
        `kind` names it; within an engine plan it is made once, at the
        plan's first run, and kept (RunState.host_tables), so a captured
        graph reads it and no later run copies it to the card. On the
        meta device an empty tensor of its shape."""
        if self.device.type == "meta":
            a = build()
            return torch.empty(a.shape, device="meta",
                               dtype=torch.from_numpy(a[:0]).dtype)
        cache = self.run.host_tables if self.run is not None else None
        full = (kind, key, self.device)
        if cache is not None:
            t = cache.tensors.get(full)
            if t is not None:
                return t
        a = build()
        # np.ascontiguousarray makes a 0-d array 1-d: keep the shape
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(
            self.device)
        if cache is not None:
            cache.tensors[full] = t
            cache.built += 1
        return t

    # ---- randomness -------------------------------------------------------
    def _seed(self) -> int:
        seed = self.op.attr("seed", 0)
        if seed:
            return int(seed)   # a fixed seed draws the same every run
        run = self.run
        return op_seed(run.program_seed if run else 0,
                       self.op.attr(OP_UID_ATTR, 0), run.run if run else 0)

    def _draw_key(self, kind):
        """(kind, seed source, occurrence in this run) of a draw in
        capture mode (GraphRandom)."""
        seed = self.op.attr("seed", 0)
        source = ("seed", int(seed)) if seed else \
            ("uid", self.op.attr(OP_UID_ATTR, 0))
        draws = self.run.draws
        n = draws.get((kind, source), 0)
        draws[(kind, source)] = n + 1
        return kind, source, n

    def generator(self) -> Optional[torch.Generator]:
        """A generator on the op's device, seeded from the op's `seed`
        attr when nonzero, else from the program seed, the op uid and
        the run index. A grad op has its forward's uid, so it draws what
        its forward drew. Under the dygraph tracer an op without a fixed
        seed draws from the tracer's generator (RunState.generator); in
        capture mode from the block's GraphRandom, seeded alike. None on
        the meta device, where nothing is drawn."""
        if self.device.type == "meta":
            return None
        run = self.run
        if run is not None and run.generator is not None and \
                not self.op.attr("seed", 0):
            return run.generator
        if run is not None and run.graph is not None:
            return run.graph.generator(self._draw_key("generator"),
                                       self._seed())
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seed())
        return g

    def seed_words(self):
        """Two uint32 words from the same seed, made on the host (no
        device round trip): the seed of an in-kernel hash. Refused while
        a CUDA graph captures a step: a host seed would repeat on every
        replay (seed_tensor() is the kernels' seed)."""
        if self.run is not None and (self.run.capturing or
                                     self.run.graph is not None):
            raise RuntimeError(
                f"{self.op.type}: an in-kernel random seed is drawn on the "
                f"host, so a CUDA graph would replay the same one on every "
                f"call; this op cannot be captured")
        return op_seed_words(self._seed())

    def seed_tensor(self) -> torch.Tensor:
        """The seed words of seed_words() as the attention kernels read
        them: an int64 [2] tensor on the op's device. In capture mode it
        is the block's seed tensor for this draw (GraphRandom), which the
        engine rewrites before every replay; on the meta device an empty
        one."""
        if self.device.type == "meta":
            return torch.empty(2, dtype=torch.int64, device="meta")
        run = self.run
        if run is not None and run.graph is not None:
            key = self._draw_key("seed")
            return run.graph.seed_slot(key, op_seed_words(self._seed()))
        return seed_tensor(self.seed_words(), self.device)

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
                        env_in, env_out, device, run,
                        lod_env=None) -> VjpRecord:
    """Run forward lowering `fwd_type` on env_in[inputs] with the float
    inputs of `diff_slots` as autograd leaves; write the detached outputs
    to env_out under the names in `outputs` (slot -> names), and the
    LoDs the lowering set to `lod_env` (None: the run's). Returns the
    VjpRecord."""
    local, in_map, leaves = {}, {}, {}
    if lod_env is None:
        lod_env = run.lod_env if run is not None else {}
    local_lod = {}
    for s, names in inputs.items():
        in_map[s] = []
        for i, n in enumerate(names):
            ln = f"{s}:{i}"
            if n in lod_env:
                local_lod[ln] = lod_env[n]
            v = env_in[n]
            if s in diff_slots and isinstance(v, torch.Tensor) and \
                    v.is_floating_point():
                v = v.detach().requires_grad_(True)
                leaves[(s, i)] = v
            local[ln] = v
            in_map[s].append(ln)
    out_map = {s: [f"{s}@out:{i}" for i in range(len(names))]
               for s, names in outputs.items()}
    view = _SlotView(fwd_type, in_map, out_map, attrs)
    with torch.enable_grad():
        OPS.get(fwd_type).lowering(ExecContext(view, local, device, run,
                                               local_lod))
    for s in INPUT_WRITES.get(fwd_type, ()):
        for i, n in enumerate(inputs.get(s, ())):
            env_out[n] = local[f"{s}:{i}"].detach()
    outs = {}
    for s, names in outputs.items():
        for i, (ln, n) in enumerate(zip(out_map[s], names)):
            if ln in local_lod:
                lod_env[n] = local_lod[ln]
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
                attrs, frozenset(diff), ctx.env, {}, ctx.device, ctx.run,
                ctx.lod_env)
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
