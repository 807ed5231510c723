"""Eager block interpreter.

Counterpart of paddle_tpu/core/engine.py. The JAX engine traces a whole
block into one XLA executable; the port runs each op's torch lowering in
order on the place's device, and PyTorch's asynchronous CUDA stream keeps
the card fed. Engine.run gathers the persistables the block reads from
the scope, places the feeds on the device, runs the ops, converts the
fetches to numpy and writes back the persistables the block wrote.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .enforce import EnforceNotMet, wrap_op_error
from .registry import OPS, ExecContext
from .scope import Scope, tensor_to_numpy
from .types import dtype_to_torch


def run_block_ops(block, env: Dict[str, torch.Tensor], device,
                  program_seed: int = 0):
    """Run every op of `block` in order, reading and writing `env`."""
    for i, op in enumerate(block.ops):
        info = OPS.get(op.type)
        try:
            info.lowering(ExecContext(op, env, device, program_seed))
        except EnforceNotMet:
            raise
        except Exception as exc:  # re-raise with op and var context
            raise wrap_op_error(exc, op, env, i) from exc


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
        with torch.no_grad():
            run_block_ops(block, env, device, program.random_seed)
        for n in _persistable_outputs(block):
            scope.var(n).get_tensor().set_tensor(env[n])
        results = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not computed by "
                               f"the program")
            results.append(tensor_to_numpy(env[n]))
        return results
