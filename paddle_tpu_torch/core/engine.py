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
still needs and little else.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .amp import amp_guard
from .enforce import EnforceNotMet, wrap_op_error
from .registry import (OP_UID_ATTR, OPS, ExecContext, RunState,
                       grad_diff_slots, has_generic_grad,
                       run_forward_for_vjp)
from .scope import Scope, tensor_to_numpy
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


def run_block_ops(block, env: Dict[str, torch.Tensor], device, run=None,
                  frees=None):
    """Run every op of `block` in order, reading and writing `env`.
    `run` is the RunState (None: no records, program seed 0); `frees`
    maps an op index to the names to drop from env after it."""
    record_slots = run.record_slots if run is not None else {}
    for i, op in enumerate(block.ops):
        info = OPS.get(op.type)
        try:
            uid = op.attr(OP_UID_ATTR)
            if uid in record_slots and not info.is_grad_op:
                run.records[uid] = run_forward_for_vjp(
                    op.type, op._inputs, op._outputs, op._attrs,
                    record_slots[uid], env, env, device, run)
            else:
                info.lowering(ExecContext(op, env, device, run))
        except EnforceNotMet:
            raise
        except Exception as exc:  # re-raise with op and var context
            raise wrap_op_error(exc, op, env, i) from exc
        for n in (frees or {}).get(i, ()):
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


class Engine:
    def run(self, program, scope: Scope, device: torch.device,
            feed: Dict[str, np.ndarray], fetch_names: List[str]):
        block = program.global_block()
        env: Dict[str, torch.Tensor] = {}
        missing = []
        for n in _persistable_inputs(block):
            var = scope.find_var(n)
            if var is None or not var.is_initialized():
                missing.append(n)
                continue
            env[n] = var.get_tensor().tensor.to(device)
        if missing:
            raise RuntimeError(
                f"persistable variable(s) not initialized in the scope "
                f"(run the startup program first?): {missing}")
        for name, arr in feed.items():
            t = torch.tensor(arr, device=device)
            var = block.find_var(name)
            if var is not None and t.dtype != dtype_to_torch(var.dtype):
                t = t.to(dtype_to_torch(var.dtype))   # bf16 feeds
            env[name] = t

        outputs = _persistable_outputs(block)
        record_slots, grad_uids = training_plan(block)
        run = RunState(program.random_seed, scope.next_run(program._uid),
                       record_slots, grad_uids)
        frees = _last_reads(block, set(fetch_names) | set(outputs))
        amp = program._amp
        with torch.no_grad(), amp_guard(
                amp is not None,
                *((amp["dtype"], amp["black_ops"], amp["white_ops"])
                  if amp is not None else ())):
            run_block_ops(block, env, device, run, frees)

        for n in outputs:
            t = env[n]
            holder = scope.var(n).get_tensor()
            old = holder.tensor
            if old is not None and old.dtype != t.dtype:
                t = t.to(old.dtype)   # params and optimizer state keep
            holder.set_tensor(t)      # their dtype (float32 under AMP)
        results = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not computed by "
                               f"the program")
            results.append(tensor_to_numpy(env[n]))
        return results
