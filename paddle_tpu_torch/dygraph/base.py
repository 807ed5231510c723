"""Dygraph entry points: guard, enabled, to_variable and no_grad
(counterpart of paddle_tpu/dygraph/base.py). Eager execution runs the
same op lowerings as graph mode, at once, on the guard's device; the
tape records for backward through the shared grad registry."""
from __future__ import annotations

import contextlib

import numpy as np

from .. import framework
from ..core.place import Place, default_place
from .tracer import Tracer, VarBase

__all__ = ["guard", "enabled", "to_variable", "no_grad"]


def enabled():
    return framework.in_dygraph_mode()


@contextlib.contextmanager
def guard(place: Place = None):
    """Imperative mode on `place`: default_place(), CUDAPlace(0), when
    None, which raises where torch sees no card (pass CPUPlace() to run
    on the CPU)."""
    tracer = Tracer(place or default_place())
    with framework.dygraph_guard_level(tracer):
        yield


def to_variable(value, block=None, name=None):
    if isinstance(value, VarBase):
        return value
    tracer = framework._dygraph_tracer()
    assert tracer is not None, "to_variable must be called under guard()"
    return tracer.from_numpy(np.asarray(value), name)


@contextlib.contextmanager
def no_grad():
    tracer = framework._dygraph_tracer()
    old = tracer._no_grad if tracer else True
    if tracer:
        tracer._no_grad = True
    try:
        yield
    finally:
        if tracer:
            tracer._no_grad = old
