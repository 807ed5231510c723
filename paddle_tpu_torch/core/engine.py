"""Eager block interpreter.

Counterpart of paddle_tpu/core/engine.py. The JAX engine traces a whole
block into one XLA executable; the port runs each op's torch lowering in
order on the place's device, and PyTorch's asynchronous CUDA stream keeps
the card fed. Engine.run gathers the persistables the block reads from
the scope, places the feeds on the device, runs the ops, converts the
fetches to numpy and writes back the persistables the block wrote.

A training run differs in three ways:
* the block runs under amp_guard when the Program carries an AMP config
  (Program._amp, set by contrib.mixed_precision.decorate);
* a forward op whose grad op is in the block leaves a record for it
  (core/registry.py): the generic-grad ops run with their differentiated
  inputs as autograd leaves, the hand-written ones keep what their grad
  needs; each grad op consumes its record;
* random ops draw from (program seed, op uid, run index), where the run
  index counts the runs of this Program in this scope: every run draws
  new dropout masks, and two fresh scopes draw the same ones.
Each intermediate is freed after its last reader in the block (a fetch
target or a persistable is kept), so peak memory holds what the backward
still needs and little else. A run of consecutive ops whose type has a
group lowering (core/registry.py register_group: the sgd ops of a step
that share a rate) runs in one call, so a kernel can take it in one
launch, as the JAX package's one executable per block does.

What depends only on the program is worked out once: the first run of a
(program fingerprint, block, fetch names, AMP config, registry
generation) key with a given scope and feed signature builds a _Plan (the counterpart of the JAX
package's _FastPathEntry): the persistables read and written with their
scope Variables, the forward records, the steps (group spans) with each
op's OpInfo and the names to free after each. Later runs of the key
reuse it; Executor.run(use_program_cache=False) builds one for the run
alone.

From a plan's second run on, the block runs as one CUDA graph, the
counterpart of the JAX engine's jitted step (trace_step, with the
updated persistables donated and the random key a traced argument): a
rule decides before any launch whether the block can be captured (it
runs once on the meta device, as the JAX engine's eval_shape probe; an
op that cannot run there keeps it eager), then _Captured warms the step
up on clones of the state, captures it under sync debug mode "error"
(core/cuda_graph.py) and replays it at every run: the feeds copied into
static inputs, the persistables living in static tensors that the
scope's Variables point at, the random ops' generators and the
attention kernels' device seeds rewritten for each run's index
(registry.GraphRandom), the fetches copied out, and the launch counts
of one run added at each replay. On the CPU a replay runs the step on
the same static tensors.

Engine.run takes the reference's arguments: a Place (or a torch.device;
None is default_place(), CUDAPlace(0)), block_idx 0 (a sub-block runs
inside its control-flow op) and `iterations`: K runs of the plan on the
same feeds, each
with its own run index (replays of a captured block), returning the
fetches of the last. A feed that is already a torch tensor on the run's
device is used as it is (copied on the device into a captured block's
static input). Values in the env may be SelectedRows
(core/selected_rows.py): the sparse gradients of lookup_table.

LoD (variable-length batches): a feed may be a LoDTensor, whose offsets
are host data. They are part of the feed signature, so a plan (and its
captured graph) belongs to one LoD, as the JAX engine compiles one step
a LoD signature: two batches of equal shapes and other offsets have two
plans. A run's lod_env (RunState) starts from the feeds' offsets; the
sequence ops set their outputs' (ExecContext.set_lod) and the
row-preserving ops of _LOD_SHARING_OPS pass their input's on
(_share_lod), the meta-device run of the capture rule included. The
index tensors the sequence ops derive from offsets are made at a plan's
first run and kept in its HostTableCache, so a capture and its replays
copy nothing from the host. A fetch with a LoD comes back as a
LoDTensor holding its offsets.

Control flow: a control-flow op (ops/control_flow.py) runs its sub-block
through the run's SubBlocks (RunState.blocks), in the same run. The
names a sub-block reads count as reads of its op (the free lists and
the persistables). `recurrent` runs its body once a time step, and its
meta run in the capture rule one step, so a DynamicRNN block is
captured like any other; `while` and `conditional_block` read their
condition on the host, fail the rule's meta run, and keep their block
eager (eager_reasons: the op type).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import cuda_graph
from .amp import amp_guard
from .enforce import EnforceNotMet, wrap_op_error
from .place import Place, default_place
from .registry import (OP_UID_ATTR, OPS, ExecContext, GraphRandom,
                       HostTableCache, RunState, grad_diff_slots,
                       has_generic_grad, run_forward_for_vjp)
from .scope import LoDTensor, Scope, tensor_to_numpy
from .selected_rows import is_selected_rows
from .types import dtype_to_torch


def training_plan(block):
    """(record_slots, grad_uids) of a block: the uid of every grad op,
    and for each forward op whose generic grad op is in the block, the
    input slots that grad op differentiates."""
    grad_ops = {op.attr(OP_UID_ATTR): op for op in block.ops
                if OPS.get(op.type).is_grad_op}
    record_slots = {}
    for op in block.ops:
        uid = op.attr(OP_UID_ATTR)
        if uid in grad_ops and not OPS.get(op.type).is_grad_op and \
                has_generic_grad(op.type):
            record_slots[uid] = frozenset(grad_diff_slots(grad_ops[uid]))
    return record_slots, frozenset(grad_ops)


def _op_reads(op):
    """The names an op reads: its inputs, and those of the ops of its
    sub-block (a control-flow op's body reads outer vars by name)."""
    sub = op.attr("sub_block")
    if sub is None:
        return op.input_arg_names
    names = list(op.input_arg_names)
    for sop in op.block.program.block(sub.idx).ops:
        names.extend(_op_reads(sop))
    return names


def _last_reads(block, keep):
    """op index -> names whose last reader is that op (names in `keep`
    excluded)."""
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in _op_reads(op):
            last[n] = i
    frees: Dict[int, List[str]] = {}
    for n, i in last.items():
        if n not in keep:
            frees.setdefault(i, []).append(n)
    return frees


def _group_end(ops, i, key, record_slots):
    """The end of the run of ops from index i that one group lowering
    takes: the same type, equal keys, no forward record, and no op that
    reads what an earlier op of the run writes."""
    first = ops[i]
    k, written = key(first), set(first.output_arg_names)
    j = i + 1
    while j < len(ops):
        op = ops[j]
        if op.type != first.type or key(op) != k or \
                op.attr(OP_UID_ATTR) in record_slots or \
                written.intersection(op.input_arg_names):
            break
        written.update(op.output_arg_names)
        j += 1
    return j


# Row-preserving ops that share their first LoD input's offsets with
# same-row-count outputs — the opt-in analog of the reference's per-op
# ShareLoD calls (a blanket row-count heuristic would mis-tag e.g.
# transpose of a square tensor). Covers the common token-wise pipeline:
# embedding -> fc/mul -> activation -> norm -> emission.
_LOD_SHARING_OPS = frozenset({
    "lookup_table", "mul", "sum", "scale", "cast", "clip", "dropout",
    "softmax", "log_softmax", "layer_norm", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow", "assign",
    "relu", "relu6", "sigmoid", "tanh", "exp", "log", "sqrt", "rsqrt",
    "abs", "square", "gelu", "swish", "softplus", "softsign",
    "leaky_relu", "elu", "brelu", "soft_relu", "hard_sigmoid", "selu",
    "stanh", "logsigmoid", "pow", "concat", "row_conv",
})


def _share_lod(op, env, lod_env):
    """Default LoD propagation (reference ShareLoD in InferShape): for
    row-preserving ops, an output that kept the row count of a
    LoD-carrying input inherits its offsets, unless the lowering set
    one explicitly. This is what lets `emission = fc(embedding(word))`
    stay per-sequence for the CRF."""
    if op.type not in _LOD_SHARING_OPS:
        return
    src = None
    for slot in op.input_slots():
        for n in op.input(slot):
            if lod_env.get(n):
                src = n
                break
        if src:
            break
    if src is None:
        return
    sv = env.get(src)
    src_rows = sv.shape[0] if hasattr(sv, "shape") and \
        getattr(sv, "shape", None) else None
    if src_rows is None:
        return
    for slot in op.output_slots():
        for n in op.output(slot):
            if n in lod_env:
                continue
            v = env.get(n)
            shape = getattr(v, "shape", None)
            if shape and shape[0] == src_rows:
                lod_env[n] = lod_env[src]


# how run_block_ops runs a span of ops
_PLAIN, _RECORD, _GROUP = 0, 1, 2


def block_spans(block, record_slots, frees):
    """The steps of one run of `block`: (i, j, kind, info, drop) for ops
    i..j-1, where kind is _RECORD (a forward op that leaves a record for
    its grad op), _GROUP (a run of ops for one group lowering) or
    _PLAIN, info the OpInfo of op i, and drop the names to free from env
    after the step (`frees` maps an op index to the names whose last
    reader it is)."""
    ops = block.ops
    spans = []
    i = 0
    while i < len(ops):
        op = ops[i]
        info = OPS.get(op.type)
        j, kind = i + 1, _PLAIN
        if op.attr(OP_UID_ATTR) in record_slots and not info.is_grad_op:
            kind = _RECORD
        elif info.group is not None:
            kind = _GROUP
            j = _group_end(ops, i, info.group[0], record_slots)
        drop = tuple(n for k in range(i, j) for n in frees.get(k, ()))
        spans.append((i, j, kind, info, drop))
        i = j
    return spans


class SubBlocks:
    """The block runner of one program's runs (RunState.blocks): runs
    the ops of block `idx` on an env the control-flow op gives, in the
    same run (its seeds, LoDs, index cache and capture state), with the
    block's steps worked out once. A sub-block's ops leave no forward
    records: the grad op of a control-flow op differentiates the whole
    op (the generic gradient runs the sub-block under autograd)."""

    __slots__ = ("program", "_spans")

    def __init__(self, program):
        self.program = program
        self._spans: Dict[int, list] = {}

    def __call__(self, idx, env, device, run):
        block = self.program.block(idx)
        spans = self._spans.get(idx)
        if spans is None:
            spans = self._spans[idx] = block_spans(block, {}, {})
        run_block_ops(block, env, device, run, spans)


def _run_span(block, env, device, run, span):
    i, j, kind, info, _ = span
    op = block.ops[i]
    if kind == _RECORD:
        uid = op.attr(OP_UID_ATTR)
        run.records[uid] = run_forward_for_vjp(
            op.type, op._inputs, op._outputs, op._attrs,
            run.record_slots[uid], env, env, device, run)
    elif kind == _GROUP:
        info.group[1]([ExecContext(o, env, device, run)
                       for o in block.ops[i:j]])
    else:
        info.lowering(ExecContext(op, env, device, run))


def run_block_ops(block, env: Dict[str, torch.Tensor], device, run, spans):
    """Run the ops of `block` step by step as `spans` (block_spans)
    says, reading and writing `env`; `run` is the RunState, whose
    lod_env the row-preserving ops extend (_share_lod)."""
    lod_env = run.lod_env
    for span in spans:
        try:
            _run_span(block, env, device, run, span)
        except EnforceNotMet:
            raise
        except Exception as exc:  # re-raise with op and var context
            raise wrap_op_error(exc, block.ops[span[0]], env,
                                span[0]) from exc
        if lod_env:
            for k in range(span[0], span[1]):
                _share_lod(block.ops[k], env, lod_env)
        for n in span[4]:
            env.pop(n, None)


def _persistable_inputs(block) -> List[str]:
    """Persistable vars the block reads (its sub-blocks included) before
    (or without) writing them: they must come from the scope."""
    names, written = [], set()
    for op in block.ops:
        for n in _op_reads(op):
            if n in written or n in names:
                continue
            v = block.find_var(n)
            if v is not None and v.persistable:
                names.append(n)
        written.update(op.output_arg_names)
    return names


def _persistable_outputs(block) -> List[str]:
    out = []
    for op in block.ops:
        for n in op.output_arg_names:
            v = block.find_var(n)
            if v is not None and v.persistable and n not in out:
                out.append(n)
    return out


def _missing_error(missing):
    return RuntimeError(
        f"persistable variable(s) not initialized in the scope "
        f"(run the startup program first?): {missing}")


def _split_lods(feed):
    """(values, lods): each feed's array or tensor, and the offsets of
    each fed LoDTensor that carries them."""
    values, lods = {}, {}
    for n, v in feed.items():
        if isinstance(v, LoDTensor):
            if v.tensor is None:
                raise ValueError(f"feed {n!r} is a LoDTensor that holds no "
                                 f"tensor")
            if v.lod():
                lods[n] = [list(level) for level in v.lod()]
            v = v.tensor
        values[n] = v
    return values, lods


def _feed_signature(feed, lods=None):
    """(name, shape, dtype, LoD) of each feed, numpy arrays and torch
    tensors alike: two batches with the same shapes and other offsets
    have two signatures, as the JAX engine compiles one step a LoD."""
    return tuple(sorted((n, tuple(a.shape), str(a.dtype),
                         tuple(map(tuple, (lods or {}).get(n, ()))))
                        for n, a in feed.items()))


def _device(place) -> torch.device:
    """The torch device of a Place, a torch.device, or None (the default
    place, CUDAPlace(0), which raises naming CPUPlace() where torch sees
    no card)."""
    if place is None:
        place = default_place()
    if isinstance(place, Place):
        return place.torch_device()
    if isinstance(place, torch.device):
        return place
    raise TypeError(f"place must be a Place (CPUPlace(), CUDAPlace(i)) or "
                    f"a torch.device, got {type(place).__name__}")


def _fetch_numpy(value):
    """A fetch as return_numpy=True gives it. A SelectedRows comes back
    as the JAX engine gives one: a 0-d object array holding it."""
    if is_selected_rows(value):
        out = np.empty((), dtype=object)
        out[()] = value
        return out
    return tensor_to_numpy(value)


def _fetch(value, lod, return_numpy):
    """One fetch: a var with a LoD comes back as a LoDTensor holding the
    tensor and its offsets (return_numpy or not, as from the JAX
    engine); else numpy (return_numpy) or the tensor."""
    if lod:
        return LoDTensor(value, lod)
    return _fetch_numpy(value) if return_numpy else value


def _amp_guard(program):
    amp = program._amp
    return amp_guard(amp is not None,
                     *((amp["dtype"], amp["black_ops"], amp["white_ops"])
                       if amp is not None else ()))


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def capture_blocker(program, block, plan, feeds, fetch_names):
    """The rule that decides, before any launch, whether the engine
    captures a block (the counterpart of the JAX engine's eval_shape
    probe): the block runs once on the meta device, on meta tensors of
    the persistables and feeds, as build-time shape inference runs its
    ops. None when every op ran there and every fetch and persistable
    written is a tensor (plan.written then holds the meta tensors of the
    persistables written); else the reason the block stays eager: the
    type of the first op that could not run there (a shape that depends
    on values, a host read), or the fetch or state that is no tensor."""
    env = {}
    for n, var in plan.in_vars:
        t = var.get_tensor().tensor
        if not isinstance(t, torch.Tensor):
            return f"state {n}"
        env[n] = _meta(t)
    env.update((n, _meta(t)) for n, t in feeds.items())
    run = RunState(program.random_seed, 0, plan.record_slots,
                   plan.grad_uids, lod_env=dict(plan.feed_lods),
                   blocks=plan.blocks)
    meta = torch.device("meta")
    with torch.no_grad(), _amp_guard(program):
        for span in plan.spans:
            try:
                _run_span(block, env, meta, run, span)
            except Exception:   # the op cannot run on meta: the rule
                return block.ops[span[0]].type
            for k in range(span[0], span[1]):
                _share_lod(block.ops[k], env, run.lod_env)
            for n in span[4]:
                env.pop(n, None)
    for n in list(fetch_names) + [n for n, _ in plan.out_vars]:
        if not isinstance(env.get(n), torch.Tensor):
            return f"fetch {n}" if n in fetch_names else f"state {n}"
    plan.written = {n: env[n] for n, _ in plan.out_vars}
    return None


def _routing():
    """What a capture bakes in besides the plan: the kernel registry's
    routing (kernels.registry.routing_state), torch's deterministic mode
    and its float32 matmul precision. The convolution library's own
    switches are read when a block is captured: set them before a
    program's first runs."""
    from ..kernels import registry as kreg
    return (kreg.routing_state(),
            torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


class _Captured:
    """A plan's block captured as one CUDA graph (core/cuda_graph.py),
    the counterpart of the JAX engine's jitted TracedStep. It holds one
    static input tensor a feed, one static tensor a persistable the block
    reads or writes (the scope's Variables point at them; the block's
    new values are copied into them at the end of the graph, in the
    holder's dtype), the fetch targets the graph writes, the block's
    GraphRandom and the launch counts and registry decisions of one run
    (`counted`). On a card the step runs twice on a side stream on
    clones of the state (its draws make the GraphRandom's generators and
    seed tensors; it launches nothing a run counts), then is captured.

    On the CPU there is no graph: a replay runs the step itself on the
    same static tensors with the same bookkeeping (feeds copied in,
    state synced, random state prepared, fetches copied out). The first
    replay draws the GraphRandom's generators and seed tensors and
    counts its launches and decisions as `counted`; each later one
    counts `counted` in place of its own, as a graph replay does."""

    __slots__ = ("device", "routing", "inputs", "state", "holders",
                 "outputs", "random", "counted", "graph", "_body")

    def __init__(self, program, block, scope, device, plan, feeds,
                 fetch_names, routing, pool):
        from ..kernels import registry as kreg
        self.device = device
        self.routing = routing
        self.graph = self.outputs = self.counted = None
        self.inputs = {n: t.clone() for n, t in feeds.items()}
        self.holders = {n: var.get_tensor()
                        for n, var in plan.in_vars + plan.out_vars}
        self.state = {n: self.holders[n].tensor.to(device, copy=True)
                      for n, _ in plan.in_vars}
        for n, meta in plan.written.items():   # written, never read
            if n not in self.state:
                old = self.holders[n].tensor
                self.state[n] = torch.empty(
                    meta.shape, device=device,
                    dtype=meta.dtype if old is None else old.dtype)
        self.random = random = GraphRandom(program.random_seed, device)
        # the closures hold no reference to self or the plan: a dropped
        # engine frees its graphs without waiting for the cycle collector
        inputs, state = self.inputs, self.state
        written = {n: state[n] for n in plan.written}
        records, grad_uids, spans = plan.record_slots, plan.grad_uids, \
            plan.spans
        feed_lods, host_tables = plan.feed_lods, plan.host_tables
        blocks = plan.blocks

        def step(start, index):
            env = dict(start)
            env.update(inputs)
            run = RunState(program.random_seed, index, records, grad_uids,
                           graph=random, lod_env=dict(feed_lods),
                           host_tables=host_tables, blocks=blocks)
            with torch.no_grad(), _amp_guard(program):
                run_block_ops(block, env, device, run, spans)
            return env

        first = scope.peek_run(program._uid)

        def body(index=first):
            env = step(state, index)
            cuda_graph.copy_back(written, env.__getitem__)
            return {n: env[n] for n in fetch_names}

        self._body = body
        if device.type != "cuda":
            return
        snap = kreg.counts_snapshot()
        try:
            cuda_graph.warm_up(lambda: step(
                {n: t.clone() for n, t in state.items()}, first), device)
            kreg.counts_restore(snap)
            random.seal()
            if random.generators and not cuda_graph.can_register():
                raise RuntimeError(
                    "capture: the block draws random numbers, and this "
                    "torch cannot register a generator with a CUDA graph, "
                    "so every replay would draw the same ones")
            self.graph, self.outputs = cuda_graph.capture(
                body, random.generators.values(), pool)
            self.counted = kreg.counts_delta(snap, kreg.counts_snapshot())
        finally:
            kreg.counts_restore(snap)

    def load_feeds(self, feed):
        """Copy the run's feeds into the static inputs: a tensor on the
        run's device on the device, a numpy array through pinned host
        memory."""
        for n, static in self.inputs.items():
            a = feed[n]
            if isinstance(a, torch.Tensor) and a.device == static.device:
                static.copy_(a)
                continue
            host = a if isinstance(a, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(a))
            if host.dtype != static.dtype:
                host = host.to(static.dtype)
            if static.device.type == "cuda":
                static.copy_(host.pin_memory(), non_blocking=True)
            else:
                static.copy_(host)

    def sync_state(self):
        """Point each scope Variable at its static tensor, copying in a
        value set since the last run. False when such a value no longer
        fits its static tensor (another shape or dtype): the block must
        be captured again."""
        for n, t in self.state.items():
            v = self.holders[n].tensor
            if v is not t and v is not None and (
                    v.shape != t.shape or v.dtype != t.dtype):
                return False
        for n, t in self.state.items():   # written, never set yet
            if self.holders[n].tensor is None:
                self.holders[n].set_tensor(t)
        cuda_graph.sync_state(self.state, lambda n: self.holders[n].tensor,
                              lambda n, t: self.holders[n].set_tensor(t))
        return True

    def replay(self, index):
        """One run with run index `index`: the random state prepared for
        it, the graph replayed (on the CPU: the step run), the launches
        and decisions of a run counted."""
        from ..kernels import registry as kreg
        self.random.prepare(index)
        if self.graph is not None:
            self.graph.replay()
        elif self.counted is None:
            before = kreg.counts_snapshot()
            self.outputs = self._body(index)
            self.counted = kreg.counts_delta(before, kreg.counts_snapshot())
            self.random.seal()
            return
        else:
            snap = kreg.counts_snapshot()
            self.outputs = self._body(index)
            kreg.counts_restore(snap)
        kreg.counts_add(self.counted)

    def release(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self._body = None


class _Plan:
    """What one run of a block needs that depends only on the program,
    the scope, the fetches and the feed signature: the persistable
    inputs and outputs with their scope Variables (by reference: valid
    while the plan's scope is the run's and erased nothing since), each
    feed's dtype, the forward records to take, and the steps with their
    free lists. Built at the first run of a key; the runs after it reuse
    it and read each Variable's current tensor. The feed signature
    holds the feeds' LoDs (`feed_lods`), so a plan's host tables (the
    LoD-derived index tensors and attr constants, `host_tables`) and
    the LoDs of its fetches (`fetch_lods`, set by its first run, which
    is eager) are the same at every run."""

    __slots__ = ("scope", "generation", "device", "feed_sig", "feed_lods",
                 "host_tables", "fetch_lods", "in_vars", "out_vars",
                 "feed_dtypes", "record_slots", "grad_uids", "spans",
                 "blocks", "runs", "blocker", "written", "captured")

    def __init__(self, block, scope, device, feed_sig, fetch_names,
                 feed_lods=None):
        self.scope = scope
        self.generation = scope.generation
        self.device = device
        self.feed_sig = feed_sig
        self.feed_lods = feed_lods or {}
        self.host_tables = HostTableCache()
        self.fetch_lods = {}
        inputs = _persistable_inputs(block)
        missing = [n for n in inputs if scope.find_var(n) is None]
        if missing:
            raise _missing_error(missing)
        self.in_vars = [(n, scope.find_var(n)) for n in inputs]
        outputs = _persistable_outputs(block)
        self.out_vars = [(n, scope.var(n)) for n in outputs]
        self.feed_dtypes = {}
        for name, _, _, _ in feed_sig:
            var = block.find_var(name)
            if var is not None:
                self.feed_dtypes[name] = dtype_to_torch(var.dtype)
        self.record_slots, self.grad_uids = training_plan(block)
        frees = _last_reads(block, set(fetch_names) | set(outputs))
        self.spans = block_spans(block, self.record_slots, frees)
        self.blocks = SubBlocks(block.program)
        self.runs = 0
        self.blocker = _UNPROBED
        self.written = None
        self.captured = None

    def valid_for(self, scope, device, feed_sig):
        return self.scope is scope and \
            self.generation == scope.generation and \
            self.device == device and self.feed_sig == feed_sig


# plans kept per key: one per live feed signature (a training loop sees
# one or two: the batches and a shorter last one)
_MAX_PLANS = 4
# _Plan.blocker before the capture rule has run
_UNPROBED = object()


class Engine:
    """Runs blocks; keeps each block's plan (_Plan) by (program
    fingerprint, block, fetch names, AMP config, op registry generation),
    at most _MAX_PLANS a key, one per feed signature. Kernel selection
    happens inside each lowering on every call, so the registry's flags
    and environment are not part of the key; a captured block is
    captured again when they change (_routing).

    With the plan cache on, the second run of a plan captures its block
    as one CUDA graph (_Captured) when the capture rule admits it
    (capture_blocker), and every later run replays it: the counterpart
    of the JAX engine's jitted step. The first run is eager (it builds
    the plan and the kernels); a block the rule refuses stays eager, and
    `eager_reasons` maps its (program fingerprint, fetch names) to the
    reason. On the CPU the same bookkeeping replays by running the step
    on the static tensors. The graphs of an engine share one memory pool.

    `counters`: runs (Engine.run calls), fast_path_hits (runs that
    reused a plan), traces (plans built), captures (blocks captured),
    replays (runs of a captured block) and eager_runs (runs of the
    block op by op). `max_plans` bounds the plans kept a key (None: no
    bound, for a caller that declares its signatures, as the inference
    predictor does)."""

    def __init__(self, max_plans=_MAX_PLANS):
        self._max_plans = max_plans
        self._plans: Dict[tuple, List[_Plan]] = {}
        # the graphs' shared memory pool, and the live graphs in it (torch
        # frees a pool with its last graph: a new one is made then)
        self._pool = None
        self._live = 0
        self.counters = {"runs": 0, "fast_path_hits": 0, "traces": 0,
                         "captures": 0, "replays": 0, "eager_runs": 0}
        self.eager_reasons: Dict[tuple, str] = {}

    @staticmethod
    def _key(program, fetch_names):
        amp = program._amp
        return (program.fingerprint, 0, tuple(fetch_names),
                None if amp is None else
                (amp["dtype"], amp["black_ops"], amp["white_ops"]),
                OPS.generation)

    def _plan(self, block, key, scope, device, feed, lods, fetch_names):
        sig = _feed_signature(feed, lods)
        if key is not None:
            for plan in self._plans.get(key, ()):
                if plan.valid_for(scope, device, sig):
                    self.counters["fast_path_hits"] += 1
                    return plan
        plan = _Plan(block, scope, device, sig, fetch_names, lods)
        self.counters["traces"] += 1
        if key is not None:
            plans = self._plans.setdefault(key, [])
            plans.append(plan)
            if self._max_plans is not None and \
                    len(plans) > self._max_plans:
                self._release(plans.pop(0))
        return plan

    def captured_tensors(self):
        """(label, tensor) of the static tensors of every captured plan:
        its feeds' inputs, its state and its fetch targets (for the
        memory census)."""
        for i, plan in enumerate(p for plans in self._plans.values()
                                 for p in plans):
            cap = plan.captured
            if cap is None:
                continue
            for kind, tensors in (("in", cap.inputs), ("state", cap.state),
                                  ("out", cap.outputs or {})):
                for n, t in tensors.items():
                    yield f"plan{i}.{kind}:{n}", t

    def _release(self, plan):
        """Release a plan's captured graph, if it has one."""
        cap, plan.captured = plan.captured, None
        if cap is not None:
            self._live -= cap.graph is not None
            cap.release()

    def close(self):
        """Release every plan and captured graph, and the graphs' memory
        pool."""
        for plans in self._plans.values():
            for plan in plans:
                self._release(plan)
        self._plans.clear()
        self._pool = None

    def run(self, program, scope: Scope, place, feed, fetch_names,
            block_idx: int = 0, return_numpy: bool = True,
            iterations: int = 1, use_program_cache: bool = True):
        """Run the program's global block `iterations` times on the same
        feeds (numpy arrays, torch tensors, or LoDTensors whose offsets
        the sequence ops read), each run with its own run index (random
        ops draw anew), and return the fetches of the last run (a fetch
        with a LoD as a LoDTensor). use_program_cache=False builds the
        plan for this call alone: it neither reuses one nor keeps it,
        and captures nothing.
        A captured block returns clones of its fetches (numpy copies with
        return_numpy), so no caller holds a tensor the next replay
        overwrites."""
        if block_idx != 0:
            raise NotImplementedError(
                f"block_idx={block_idx}: the engine runs block 0; "
                f"sub-blocks run inside the control-flow ops that name "
                f"them")
        iterations = int(iterations)
        if iterations < 1:
            raise ValueError(f"iterations must be at least 1, got "
                             f"{iterations}")
        device = _device(place)
        self.counters["runs"] += 1
        block = program.global_block()
        key = self._key(program, fetch_names) if use_program_cache \
            else None
        feed, lods = _split_lods(feed)
        plan = self._plan(block, key, scope, device, feed, lods,
                          fetch_names)
        plan.runs += 1
        feeds = None
        if key is not None and plan.runs > 1:
            missing = [n for n, var in plan.in_vars
                       if var.get_tensor().tensor is None]
            if missing:
                raise _missing_error(missing)
            if plan.blocker is _UNPROBED:
                feeds = self._feeds(plan, feed, device)
                plan.blocker = capture_blocker(program, block, plan, feeds,
                                               fetch_names)
                if plan.blocker is not None:
                    self.eager_reasons.setdefault(
                        (program.fingerprint, tuple(fetch_names)),
                        plan.blocker)
            if plan.blocker is None:
                return self._replay(program, block, scope, device, plan,
                                    feed, feeds, fetch_names,
                                    return_numpy, iterations)
        if feeds is None:
            feeds = self._feeds(plan, feed, device)
        for _ in range(iterations):
            env = self._run_once(program, block, scope, device, plan, feeds,
                                 fetch_names)
            self.counters["eager_runs"] += 1
        results = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not computed by "
                               f"the program")
            results.append(_fetch(env[n], plan.fetch_lods.get(n),
                                  return_numpy))
        return results

    @staticmethod
    def _feeds(plan, feed, device):
        """The feeds as tensors on the device in the dtypes the block
        declares."""
        feeds = {}
        for name, arr in feed.items():
            if isinstance(arr, torch.Tensor):
                t = arr if arr.device == device else arr.to(device)
            else:
                t = torch.tensor(arr, device=device)
            dt = plan.feed_dtypes.get(name)
            if dt is not None and t.dtype != dt:
                t = t.to(dt)                  # bf16 feeds
            feeds[name] = t
        return feeds

    def _replay(self, program, block, scope, device, plan, feed, feeds,
                fetch_names, return_numpy, iterations):
        """The captured runs of a plan: the block captured at its first
        call here (and again when the routing changed or a scope value no
        longer fits), then one replay a run."""
        cap = plan.captured
        routing = _routing()
        if cap is not None and (cap.routing != routing or
                                not cap.sync_state()):
            self._release(plan)
            cap = None
        if cap is None:
            if feeds is None:
                feeds = self._feeds(plan, feed, device)
            if device.type == "cuda" and not self._live:
                self._pool = torch.cuda.graph_pool_handle()
            cap = plan.captured = _Captured(
                program, block, scope, device, plan, feeds, fetch_names,
                routing, self._pool)
            self._live += cap.graph is not None
            self.counters["captures"] += 1
            cap.sync_state()
        else:
            cap.load_feeds(feed)
        for _ in range(iterations):
            cap.replay(scope.next_run(program._uid))
            self.counters["replays"] += 1
        results = []
        for n in fetch_names:
            lod = plan.fetch_lods.get(n)
            # numpy is a copy already; a tensor is cloned
            v = cap.outputs[n] if return_numpy and not lod \
                else cap.outputs[n].clone()
            results.append(_fetch(v, lod, return_numpy))
        return results

    @staticmethod
    def _run_once(program, block, scope, device, plan, feeds, fetch_names):
        """One run of the plan: the persistables from the scope, the ops,
        the persistables written back. Returns the env."""
        env: Dict[str, torch.Tensor] = {}
        missing = []
        for n, var in plan.in_vars:
            t = var.get_tensor().tensor
            if t is None:
                missing.append(n)
            elif isinstance(t, torch.Tensor) and t.device != device:
                env[n] = t.to(device)
            else:
                env[n] = t    # a tensor, or a host object (an eager op's)
        if missing:
            raise _missing_error(missing)
        env.update(feeds)

        run = RunState(program.random_seed, scope.next_run(program._uid),
                       plan.record_slots, plan.grad_uids,
                       lod_env=dict(plan.feed_lods),
                       host_tables=plan.host_tables,
                       blocks=plan.blocks)
        with torch.no_grad(), _amp_guard(program):
            run_block_ops(block, env, device, run, plan.spans)
        plan.fetch_lods = {n: run.lod_env[n] for n in fetch_names
                           if run.lod_env.get(n)}

        for n, var in plan.out_vars:
            t = env[n]
            holder = var.get_tensor()
            old = holder.tensor
            if isinstance(old, torch.Tensor) and \
                    isinstance(t, torch.Tensor) and old.dtype != t.dtype:
                t = t.to(old.dtype)   # params and optimizer state keep
            holder.set_tensor(t)      # their dtype (float32 under AMP)
        return env
