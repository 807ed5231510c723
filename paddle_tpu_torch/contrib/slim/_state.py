"""Host copies of scope values and writes back to where they live: the
passes and strategies of contrib.slim read and set persistables in a
scope (weights snapped to the int8 grid, pruning masks, teacher weights
under new names) with numpy, as the JAX package's do, so the values they
compute are the JAX package's to the bit."""
from __future__ import annotations

import numpy as np
import torch

from ...core.scope import tensor_to_numpy


def read(scope, name) -> np.ndarray:
    """A host copy of the value of `name` in `scope`."""
    return tensor_to_numpy(scope.find_var(name).get_tensor().tensor)


def device_of(scope, program) -> torch.device:
    """The device of the program's parameters in `scope` (the CPU where
    none is set yet: the engine moves such a value at its first run)."""
    for p in program.all_parameters():
        v = scope.find_var(p.name)
        t = v.get_tensor().tensor if v is not None else None
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def write(scope, name, value, device=None):
    """Set `name` in `scope` (created there if it is not) to the numpy
    array `value`, on the device of the value it replaces, else on
    `device` (the CPU when None)."""
    holder = scope.var(name).get_tensor()
    old = holder.tensor
    if isinstance(old, torch.Tensor):
        device = old.device
    holder.set_tensor(torch.from_numpy(np.array(value)).to(
        device or torch.device("cpu")))
