"""Variable containers and the scope.

Counterpart of paddle_tpu/core/scope.py. Values are torch.Tensors that
live on the device of the place that wrote them; LoDTensor keeps the
fluid-style surface (set / __array__) over one. A block's env may also
hold a TensorArray (the array ops) or a LoDRankTable (DynamicRNN).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .place import default_place


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor. numpy has no bfloat16, so a bf16 tensor
    comes back as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class LoDTensor:
    """The fluid tensor holder over one torch.Tensor, with its
    level-of-detail offsets: a list of levels, each a list of ascending
    row offsets from 0 (counterpart of paddle_tpu/core/scope.py
    LoDTensor). The offsets are host-side Python ints: reading them
    never touches the card. The sequence ops read them (ops/sequence.py)
    and the engine keys its plans on them."""

    __slots__ = ("_tensor", "_lod")

    def __init__(self, array=None, lod=None):
        # a numpy array is taken as a CPU tensor (set() places one)
        self._tensor = torch.from_numpy(np.array(array)) \
            if isinstance(array, np.ndarray) else array
        self._lod = [list(map(int, level)) for level in (lod or [])]

    def set(self, array, place=None):
        """Copy a numpy array (or tensor) in, onto `place`'s device
        (the default place, CUDAPlace(0), when no place is given: it
        raises where torch sees no card; pass CPUPlace() for the CPU)."""
        device = (place if place is not None else default_place()) \
            .torch_device()
        if isinstance(array, torch.Tensor):
            self._tensor = array.to(device)
        else:
            self._tensor = torch.tensor(np.asarray(array), device=device)

    def set_tensor(self, tensor: torch.Tensor):
        self._tensor = tensor

    def set_lod(self, lod):
        self._lod = [list(map(int, level)) for level in lod]

    def lod(self):
        return self._lod

    def recursive_sequence_lengths(self):
        return [[b - a for a, b in zip(level[:-1], level[1:])]
                for level in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = []
        for level in lengths:
            offs = [0]
            for n in level:
                offs.append(offs[-1] + int(n))
            self._lod.append(offs)

    def has_valid_recursive_sequence_lengths(self):
        """Offsets ascending from 0, each level's last offset the number
        of entries of the next level (rows for the last level): the
        reference's CheckLoD."""
        t = self._tensor
        expect = t.shape[0] if t is not None and t.dim() else 0
        for level in reversed(self._lod):
            if not level or level[0] != 0:
                return False
            if any(b < a for a, b in zip(level[:-1], level[1:])):
                return False
            if level[-1] != expect:
                return False
            expect = len(level) - 1
        return True

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
        return f"LoDTensor(shape={self.shape()}, lod={self._lod})"


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """A LoDTensor of `data` (a numpy array, or a LoDTensor whose values
    are taken) on `place` (None: CUDAPlace(0)) with the offsets of
    `recursive_seq_lens`, one list of lengths a level."""
    t = LoDTensor()
    t.set(data.tensor if isinstance(data, LoDTensor) else data, place)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError(
            f"recursive_seq_lens {recursive_seq_lens} do not partition the "
            f"{t.shape()[0] if t.shape() else 0} rows of the data")
    return t


class TensorArray(list):
    """The LoDTensorArray: a list of tensors, written and read by index
    (write_to_array, read_from_array)."""

    def append(self, tensor):
        list.append(self, tensor)


class LoDRankTable:
    """The sequences of one LoD level sorted by length, longest first
    (ties in sequence order): `items` holds (sequence index, length)
    pairs. Host data, as the LoD it comes from: DynamicRNN's sort, pad
    and unsort (ops/control_flow.py) read it to build their index
    tensors."""

    __slots__ = ("items", "offsets")

    def __init__(self, offsets):
        lengths = [int(offsets[i + 1]) - int(offsets[i])
                   for i in range(len(offsets) - 1)]
        order = sorted(range(len(lengths)),
                       key=lambda i: (-lengths[i], i))
        self.items = [(i, lengths[i]) for i in order]
        self.offsets = [int(o) for o in offsets]

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)

    @property
    def indices(self):
        return [i for i, _ in self.items]

    @property
    def lengths(self):
        return [n for _, n in self.items]

    @property
    def max_len(self):
        return self.items[0][1] if self.items else 0

    def key(self):
        """Hashable: the offsets fix the table."""
        return tuple(self.offsets)


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
    """Name -> Variable map with a parent (the reference's hierarchical
    scope): `find_var` walks up to the parents, `var` creates a name in
    this scope, `new_scope` makes a child and `drop_kids` forgets the
    children. It also counts the runs of each Program in this scope (it
    seeds random ops: every run draws anew, and a fresh scope replays
    the same draws).

    `generation` says whether the Variables a name resolves to may have
    changed: the engine's plans hold Variables by reference and are
    valid only while it stays the same. It grows when this scope erases
    names, when a name created here hides a parent's Variable, when the
    parent drops this scope, and with the parent's own generation (a
    child resolves names to its parents' Variables)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Variable] = {}
        self._runs: Dict[int, int] = {}
        self._parent = parent
        self._kids = []
        self._changes = 0

    @property
    def generation(self) -> int:
        g, s = 0, self
        while s is not None:
            g += s._changes
            s = s._parent
        return g

    def next_run(self, program_uid: int) -> int:
        """Index of this run of the program in this scope (0, 1, ...)."""
        i = self._runs.get(program_uid, 0)
        self._runs[program_uid] = i + 1
        return i

    def peek_run(self, program_uid: int) -> int:
        """The index next_run would give, without taking it: the
        engine's warm-up runs before a capture draw with it and consume
        no run."""
        return self._runs.get(program_uid, 0)

    def var(self, name: str) -> Variable:
        """The Variable `name` of this scope, created here if it is not
        (a parent's Variable of that name is then hidden)."""
        v = self._vars.get(name)
        if v is None:
            if self._parent is not None and \
                    self._parent.find_var(name) is not None:
                self._changes += 1
            v = Variable(name)
            self._vars[name] = v
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        """The Variable `name` of this scope or of the nearest parent
        that has one; None if none has."""
        s = self
        while s is not None:
            v = s._vars.get(name)
            if v is not None:
                return v
            s = s._parent
        return None

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        """Forget the child scopes. A plan made for one of them (or for
        a scope below it) is no longer valid."""
        for kid in self._kids:
            kid._changes += 1
        self._kids.clear()

    def local_var_names(self):
        return list(self._vars)

    def erase(self, names):
        """Remove the named variables of this scope (names not in it are
        skipped)."""
        for n in names:
            self._vars.pop(n, None)
        self._changes += 1


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
