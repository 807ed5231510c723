"""One step as one CUDA graph: the warm-up, the capture with its
generators registered, and the static state, shared by the engine's
captured blocks (core/engine.py) and dygraph.jit.capture.

Counterpart of the JAX package's jit with donated state: a step whose
shapes and control flow are stable is captured once and replayed, and
its state lives in static tensors that the step reads and, at its end,
overwrites with the new values (the counterpart of donation).

* warm_up runs the step on a side stream before the capture, so that
  kernel builds, library handles, workspaces and algorithm choices
  happen outside the graph; the caller hands it clones of the state, so
  nothing moves.
* capture records the step into a new torch.cuda.CUDAGraph under sync
  debug mode "error" (a host sync in the step raises), with the step's
  generators registered first, so that every replay draws from the
  seed and offset each holds at that replay. The graphs of one owner
  may share a memory pool.
* sync_state copies a state value that a caller replaced between two
  replays into its static tensor and points the holder back at it;
  copy_back ends the captured step by copying each new state value into
  its static tensor.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

__all__ = ["WARMUP_RUNS", "warm_up", "can_register", "capture",
           "sync_state", "copy_back"]

WARMUP_RUNS = 2


def warm_up(step: Callable[[], object], device: torch.device,
            runs: int = WARMUP_RUNS):
    """Run step() `runs` times: on a card on a side stream that waits for
    the current one and that the current one then waits for, elsewhere
    in place."""
    if device.type != "cuda":
        for _ in range(runs):
            step()
        return
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(runs):
            step()
    cur.wait_stream(side)


def can_register() -> bool:
    """Whether this torch registers a generator with a CUDA graph."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


def capture(step: Callable[[], object],
            generators: Iterable[torch.Generator] = (), pool=None):
    """(graph, step's result): step() captured into a new CUDAGraph under
    sync debug mode "error", in memory pool `pool` (None: a pool of its
    own), with each generator registered first where this torch can
    (can_register())."""
    graph = torch.cuda.CUDAGraph()
    if can_register():
        for g in generators:
            graph.register_generator_state(g)
    sync_mode = torch.cuda.get_sync_debug_mode()
    with torch.cuda.graph(graph, pool=pool):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = step()
        finally:
            torch.cuda.set_sync_debug_mode(sync_mode)
    return graph, out


def sync_state(statics: Dict[str, torch.Tensor],
               current: Callable[[str], torch.Tensor],
               repoint: Callable[[str, torch.Tensor], None]):
    """For each static tensor whose holder holds another tensor now
    (current(name) is not it: the caller replaced the value), copy that
    value in and point the holder back at the static tensor."""
    for n, t in statics.items():
        v = current(n)
        if v is not t:
            t.copy_(v)
            repoint(n, t)


def copy_back(statics: Dict[str, torch.Tensor],
              values: Callable[[str], torch.Tensor]):
    """Copy each new state value (values(name)) into its static tensor, in
    the static tensor's dtype; a value that is the static tensor (updated
    in place) is left."""
    for n, t in statics.items():
        v = values(n)
        if v is not t:
            t.copy_(v)
