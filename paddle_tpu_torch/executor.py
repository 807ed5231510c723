"""Public Executor: the fluid.Executor-compatible entry point.

Counterpart of paddle_tpu/executor.py. Executor() with no place runs on
CUDAPlace(0) and raises at once when no CUDA device is visible; pass
CPUPlace() to run on the CPU. A closed Executor (close()) raises on run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import framework
from .core.engine import Engine
from .core.place import Place, default_place
from .core.scope import LoDTensor, global_scope, scope_guard
from .core.types import dtype_to_np

__all__ = ["Executor", "global_scope", "scope_guard"]


def _to_name_str(fetch):
    if isinstance(fetch, str):
        return fetch
    if isinstance(fetch, framework.Variable):
        return fetch.name
    raise TypeError(f"fetch target must be Variable or str, got "
                    f"{type(fetch)}")


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        self._engine = Engine()
        self._closed = False

    def close(self):
        """Close the Executor: its engine's plans, captured CUDA graphs
        and their memory pool are released, and a later run raises."""
        self._closed = True
        self._engine.close()
        self._engine = Engine()

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """Run `program` once: feeds (numpy arrays) in, fetches out, with
        the reference's arguments and defaults.

        feed_var_name / fetch_var_name name Fluid's feed and fetch
        holders. The port, like the JAX package, feeds and fetches
        variables by name and builds no feed or fetch ops, so they change
        nothing. return_numpy=True gives numpy arrays (bf16 as float32);
        False gives the fetched torch tensors as they lie on the device.
        use_program_cache=True reuses the engine's plan of the block
        (core/engine.py _Plan: the persistables, records, steps and free
        lists), built at the first run with this program version,
        fetch list, scope and feed signature; False builds the plan for
        this run alone and neither reuses nor keeps one: the reference's
        semantics for a program changed without a version bump."""
        del feed_var_name, fetch_var_name
        if self._closed:
            raise RuntimeError("Executor is closed")
        if program is None:
            program = framework.default_main_program()
        scope = scope or global_scope()
        fetch_names = [_to_name_str(f) for f in fetch_list or []]
        return self._engine.run(program, scope, self.place,
                                self._canonical_feed(feed, program),
                                fetch_names, return_numpy=return_numpy,
                                use_program_cache=use_program_cache)

    @staticmethod
    def _canonical_feed(feed, program):
        """numpy arrays in the dtypes the Program declares. Integer ids
        stay integer (the JAX package narrows int64 to int32; compare
        values, not dtypes). A torch tensor passes as it is: the engine
        takes it on its device (a batch already on the card is copied on
        the card) and casts it to the declared dtype there. A LoDTensor
        (create_lod_tensor) passes as it is, with its offsets, as the
        JAX Executor takes it; like the JAX Executor, this one refuses
        an (array, lod) pair."""
        out = {}
        for k, v in (feed or {}).items():
            if isinstance(v, (torch.Tensor, LoDTensor)):
                out[k] = v
                continue
            if isinstance(v, tuple):
                raise TypeError(
                    f"feed {k!r} is a tuple: feed a LoDTensor "
                    f"(create_lod_tensor(array, lengths, place)) for "
                    f"variable-length data, or an array")
            arr = np.asarray(v)
            var = program.global_block().find_var(k)
            if var is not None and arr.dtype != dtype_to_np(var.dtype):
                arr = arr.astype(dtype_to_np(var.dtype))
            out[k] = arr
        return out
