"""Variable containers and the scope.

Counterpart of paddle_tpu/core/scope.py. Values are torch.Tensors that
live on the device of the place that wrote them; LoDTensor keeps the
fluid-style surface (set / __array__) over one.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor. numpy has no bfloat16, so a bf16 tensor
    comes back as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class LoDTensor:
    """The fluid tensor holder over one torch.Tensor. Level-of-detail
    offsets arrive with the sequence ops; no op of the port reads them
    yet."""

    __slots__ = ("_tensor",)

    def __init__(self, tensor: Optional[torch.Tensor] = None):
        self._tensor = tensor

    def set(self, array, place=None):
        """Copy a numpy array (or tensor) in, onto `place`'s device
        (the CPU when no place is given)."""
        device = place.torch_device() if place is not None \
            else torch.device("cpu")
        if isinstance(array, torch.Tensor):
            self._tensor = array.to(device)
        else:
            self._tensor = torch.tensor(np.asarray(array), device=device)

    def set_tensor(self, tensor: torch.Tensor):
        self._tensor = tensor

    def shape(self):
        return tuple(self._tensor.shape) if self._tensor is not None \
            else ()

    @property
    def tensor(self) -> Optional[torch.Tensor]:
        return self._tensor

    def __array__(self, dtype=None, copy=None):
        a = tensor_to_numpy(self._tensor)
        return a.astype(dtype) if dtype else a

    def __repr__(self):
        return f"LoDTensor(shape={self.shape()})"


class Variable:
    """Type-erased runtime variable."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = None

    def get_tensor(self) -> LoDTensor:
        if not isinstance(self._value, LoDTensor):
            self._value = LoDTensor(self._value)
        return self._value

    def is_initialized(self) -> bool:
        v = self._value
        if isinstance(v, LoDTensor):
            return v.tensor is not None
        return v is not None


class Scope:
    """Name -> Variable map, and the count of runs of each Program in
    this scope (it seeds random ops: every run draws anew, and a fresh
    scope replays the same draws). Child scopes arrive with control
    flow."""

    def __init__(self):
        self._vars: Dict[str, Variable] = {}
        self._runs: Dict[int, int] = {}

    def next_run(self, program_uid: int) -> int:
        """Index of this run of the program in this scope (0, 1, ...)."""
        i = self._runs.get(program_uid, 0)
        self._runs[program_uid] = i + 1
        return i

    def var(self, name: str) -> Variable:
        v = self._vars.get(name)
        if v is None:
            v = Variable(name)
            self._vars[name] = v
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        return self._vars.get(name)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class _ScopeGuard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        global _global_scope
        self._old = _global_scope
        _global_scope = self._scope

    def __exit__(self, *exc):
        global _global_scope
        _global_scope = self._old


def scope_guard(scope: Scope):
    """`with scope_guard(scope):` swaps the global scope."""
    return _ScopeGuard(scope)
