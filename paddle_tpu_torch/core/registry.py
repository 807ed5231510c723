"""Operator registry: one registration per op gives its lowering, and its
shape inference by running that lowering on meta tensors.

Counterpart of paddle_tpu/core/registry.py. A lowering is a plain
function ``lowering(ctx)`` that reads torch.Tensors through an
ExecContext and sets its outputs; the engine calls it eagerly, op by op.
Forward only so far: OpInfo keeps a ``grad_lowering`` slot, which the
training slice fills.
"""
from __future__ import annotations

import zlib
from typing import Dict, Optional

import torch

# Attr name for the program-unique op id (seeds per-op randomness).
OP_UID_ATTR = "__op_uid__"


class OpInfo:
    __slots__ = ("type", "lowering", "grad_lowering")

    def __init__(self, type, lowering, grad_lowering=None):
        self.type = type
        self.lowering = lowering
        self.grad_lowering = grad_lowering


class OpInfoMap:
    def __init__(self):
        self._map: Dict[str, OpInfo] = {}

    def insert(self, info: OpInfo):
        if info.type in self._map:
            raise ValueError(f"op '{info.type}' registered twice")
        self._map[info.type] = info

    def get(self, op_type: str) -> OpInfo:
        try:
            return self._map[op_type]
        except KeyError:
            raise NotImplementedError(
                f"op '{op_type}' is not registered in paddle_tpu_torch "
                f"({len(self._map)} ops are)") from None

    def types(self):
        return sorted(self._map)


OPS = OpInfoMap()


def register_op(op_type: str):
    """Decorator registering a forward lowering ``fn(ctx)``."""
    def deco(fn):
        OPS.insert(OpInfo(op_type, fn))
        return fn
    return deco


def op_seed(program_seed: int, uid: int) -> int:
    """Seed of one random op, from the program's seed and the op's uid:
    two builds of one Program draw the same numbers."""
    return zlib.crc32(f"{int(program_seed)}:{int(uid)}".encode())


class ExecContext:
    """Per-op view while a block runs. `env` maps var name -> tensor;
    `device` is where new tensors go (the meta device during build-time
    shape inference); `program_seed` seeds the op's generator."""

    __slots__ = ("op", "env", "device", "program_seed")

    def __init__(self, op, env, device: torch.device, program_seed=0):
        self.op = op
        self.env = env
        self.device = device
        self.program_seed = program_seed

    # ---- inputs / outputs -------------------------------------------------
    def has_input(self, slot: str) -> bool:
        return bool(self.op.input(slot))

    def has_output(self, slot: str) -> bool:
        return bool(self.op.output(slot))

    def input(self, slot: str) -> Optional[torch.Tensor]:
        names = self.op.input(slot)
        if not names:
            return None
        if len(names) != 1:
            raise ValueError(f"op {self.op.type} input slot {slot} is "
                             f"multi-arg")
        return self.env[names[0]]

    def set_output(self, slot: str, value: torch.Tensor):
        names = self.op.output(slot)
        if not names:
            return  # optional output not bound
        if len(names) != 1:
            raise ValueError(f"{self.op.type}.{slot} is multi-arg")
        self.env[names[0]] = value

    # ---- attrs ------------------------------------------------------------
    def attr(self, name: str, default=None):
        return self.op.attr(name, default)

    # ---- randomness -------------------------------------------------------
    def generator(self) -> Optional[torch.Generator]:
        """A generator on the op's device, seeded from the op's `seed`
        attr when nonzero, else from the program seed and the op uid.
        None on the meta device, where nothing is drawn."""
        if self.device.type == "meta":
            return None
        seed = self.op.attr("seed", 0) or op_seed(
            self.program_seed, self.op.attr(OP_UID_ATTR, 0))
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g
