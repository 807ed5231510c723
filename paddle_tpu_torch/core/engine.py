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

Engine.run takes the reference's arguments: a Place (or a torch.device;
None is default_place(), CUDAPlace(0)), block_idx 0 (sub-blocks are not
ported) and `iterations`: K runs of the plan on the same feeds, each
with its own run index, returning the fetches of the last. A feed that
is already a torch tensor on the run's device is used as it is. Values
in the env may be SelectedRows (core/selected_rows.py): the sparse
gradients of lookup_table.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .amp import amp_guard
from .enforce import EnforceNotMet, wrap_op_error
from .place import Place, default_place
from .registry import (OP_UID_ATTR, OPS, ExecContext, RunState,
                       grad_diff_slots, has_generic_grad,
                       run_forward_for_vjp)
from .scope import Scope, tensor_to_numpy
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


def _last_reads(block, keep):
    """op index -> names whose last reader is that op (names in `keep`
    excluded)."""
    last: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names:
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


def run_block_ops(block, env: Dict[str, torch.Tensor], device, run, spans):
    """Run the ops of `block` step by step as `spans` (block_spans)
    says, reading and writing `env`; `run` is the RunState."""
    ops = block.ops
    for i, j, kind, info, drop in spans:
        op = ops[i]
        try:
            if kind == _RECORD:
                uid = op.attr(OP_UID_ATTR)
                run.records[uid] = run_forward_for_vjp(
                    op.type, op._inputs, op._outputs, op._attrs,
                    run.record_slots[uid], env, env, device, run)
            elif kind == _GROUP:
                info.group[1]([ExecContext(o, env, device, run)
                               for o in ops[i:j]])
            else:
                info.lowering(ExecContext(op, env, device, run))
        except EnforceNotMet:
            raise
        except Exception as exc:  # re-raise with op and var context
            raise wrap_op_error(exc, op, env, i) from exc
        for n in drop:
            env.pop(n, None)


def _persistable_inputs(block) -> List[str]:
    """Persistable vars the block reads before (or without) writing
    them: they must come from the scope."""
    names, written = [], set()
    for op in block.ops:
        for n in op.input_arg_names:
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


def _feed_signature(feed):
    """(name, shape, dtype) of each feed, numpy arrays and torch tensors
    alike."""
    return tuple(sorted((n, tuple(a.shape), str(a.dtype))
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


class _Plan:
    """What one run of a block needs that depends only on the program,
    the scope, the fetches and the feed signature: the persistable
    inputs and outputs with their scope Variables (by reference: valid
    while the plan's scope is the run's and erased nothing since), each
    feed's dtype, the forward records to take, and the steps with their
    free lists. Built at the first run of a key; the runs after it reuse
    it and read each Variable's current tensor."""

    __slots__ = ("scope", "generation", "device", "feed_sig", "in_vars",
                 "out_vars", "feed_dtypes", "record_slots", "grad_uids",
                 "spans")

    def __init__(self, block, scope, device, feed_sig, fetch_names):
        self.scope = scope
        self.generation = scope.generation
        self.device = device
        self.feed_sig = feed_sig
        inputs = _persistable_inputs(block)
        missing = [n for n in inputs if scope.find_var(n) is None]
        if missing:
            raise _missing_error(missing)
        self.in_vars = [(n, scope.find_var(n)) for n in inputs]
        outputs = _persistable_outputs(block)
        self.out_vars = [(n, scope.var(n)) for n in outputs]
        self.feed_dtypes = {}
        for name, _, _ in feed_sig:
            var = block.find_var(name)
            if var is not None:
                self.feed_dtypes[name] = dtype_to_torch(var.dtype)
        self.record_slots, self.grad_uids = training_plan(block)
        frees = _last_reads(block, set(fetch_names) | set(outputs))
        self.spans = block_spans(block, self.record_slots, frees)

    def valid_for(self, scope, device, feed_sig):
        return self.scope is scope and \
            self.generation == scope.generation and \
            self.device == device and self.feed_sig == feed_sig


# plans kept per key: one per live feed signature (a training loop sees
# one or two: the batches and a shorter last one)
_MAX_PLANS = 4


class Engine:
    """Runs blocks; keeps each block's plan (_Plan) by (program
    fingerprint, block, fetch names, AMP config, op registry generation),
    at most _MAX_PLANS a key, one per feed signature. Kernel selection
    happens inside each lowering on every call, so the registry's flags
    and environment are not part of the key. `counters`: runs,
    fast_path_hits (runs that reused a plan) and traces (plans built)."""

    def __init__(self):
        self._plans: Dict[tuple, List[_Plan]] = {}
        self.counters = {"runs": 0, "fast_path_hits": 0, "traces": 0}

    @staticmethod
    def _key(program, fetch_names):
        amp = program._amp
        return (program.fingerprint, 0, tuple(fetch_names),
                None if amp is None else
                (amp["dtype"], amp["black_ops"], amp["white_ops"]),
                OPS.generation)

    def _plan(self, block, key, scope, device, feed, fetch_names):
        sig = _feed_signature(feed)
        if key is not None:
            for plan in self._plans.get(key, ()):
                if plan.valid_for(scope, device, sig):
                    self.counters["fast_path_hits"] += 1
                    return plan
        plan = _Plan(block, scope, device, sig, fetch_names)
        self.counters["traces"] += 1
        if key is not None:
            plans = self._plans.setdefault(key, [])
            plans.append(plan)
            if len(plans) > _MAX_PLANS:
                plans.pop(0)
        return plan

    def run(self, program, scope: Scope, place, feed, fetch_names,
            block_idx: int = 0, return_numpy: bool = True,
            iterations: int = 1, use_program_cache: bool = True):
        """Run the program's global block `iterations` times on the same
        feeds (numpy arrays or torch tensors), each run with its own run
        index (random ops draw anew), and return the fetches of the last
        run. use_program_cache=False builds the plan for this call
        alone: it neither reuses one nor keeps it."""
        if block_idx != 0:
            raise NotImplementedError(
                f"block_idx={block_idx}: sub-blocks are not ported; the "
                f"engine runs block 0")
        iterations = int(iterations)
        if iterations < 1:
            raise ValueError(f"iterations must be at least 1, got "
                             f"{iterations}")
        device = _device(place)
        self.counters["runs"] += 1
        block = program.global_block()
        key = self._key(program, fetch_names) if use_program_cache \
            else None
        plan = self._plan(block, key, scope, device, feed, fetch_names)
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
        for _ in range(iterations):
            env = self._run_once(program, block, scope, device, plan, feeds)
        results = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not computed by "
                               f"the program")
            results.append(_fetch_numpy(env[n]) if return_numpy
                           else env[n])
        return results

    @staticmethod
    def _run_once(program, block, scope, device, plan, feeds):
        """One run of the plan: the persistables from the scope, the ops,
        the persistables written back. Returns the env."""
        env: Dict[str, torch.Tensor] = {}
        missing = []
        for n, var in plan.in_vars:
            t = var.get_tensor().tensor
            if t is None:
                missing.append(n)
            elif t.device != device:
                env[n] = t.to(device)
            else:
                env[n] = t
        if missing:
            raise _missing_error(missing)
        env.update(feeds)

        run = RunState(program.random_seed, scope.next_run(program._uid),
                       plan.record_slots, plan.grad_uids)
        amp = program._amp
        with torch.no_grad(), amp_guard(
                amp is not None,
                *((amp["dtype"], amp["black_ops"], amp["white_ops"])
                  if amp is not None else ())):
            run_block_ops(block, env, device, run, plan.spans)

        for n, var in plan.out_vars:
            t = env[n]
            holder = var.get_tensor()
            old = holder.tensor
            if old is not None and old.dtype != t.dtype:
                t = t.to(old.dtype)   # params and optimizer state keep
            holder.set_tensor(t)      # their dtype (float32 under AMP)
        return env
