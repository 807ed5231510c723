"""Program IR: Program / Block / Operator / Variable / Parameter.

Counterpart of paddle_tpu/framework.py. These classes are the desc; the
port has no protobuf round trip yet (Program serialization comes with a
codec that needs no protobuf package). Build-time shape inference runs
the op's torch lowering on ``device="meta"`` tensors, the counterpart of
the JAX package's jax.eval_shape: every lowering is meta-safe, reading
no tensor value on the host.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch

from .core.registry import OPS, ExecContext, OP_UID_ATTR
from .core.types import (DT_FLOAT32, convert_dtype, dtype_to_str,
                         dtype_to_torch)

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_startup_program", "default_main_program", "program_guard",
    "unique_name",
]

# Stands in for -1 (dynamic) dims during shape inference. Highly
# composite, so merged dims stay multiples of it; mapped back to -1.
_DYN_SENTINEL = 55440
_META = torch.device("meta")


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------

class _UniqueNameGenerator:
    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, key: str) -> str:
        with self._lock:
            i = self._ids.get(key, 0)
            self._ids[key] = i + 1
        return f"{key}_{i}"

    def reset(self):
        self._ids.clear()


_name_gen = _UniqueNameGenerator()


class _UniqueNameNS:
    """fluid.unique_name compatible helper."""

    @staticmethod
    def generate(key):
        return _name_gen(key)

    @staticmethod
    def reset():
        _name_gen.reset()
        # also reset the op uid counter, so two identical builds seed
        # their random ops identically
        _uid_counter[0] = 0

    @staticmethod
    @contextlib.contextmanager
    def guard(new_generator=None):
        global _name_gen
        old = _name_gen
        _name_gen = new_generator or _UniqueNameGenerator()
        try:
            yield
        finally:
            _name_gen = old


unique_name = _UniqueNameNS()


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """Graph-mode symbolic variable."""

    def __init__(self, block: "Block", name: Optional[str] = None,
                 shape: Optional[Sequence[int]] = None, dtype=None,
                 persistable: bool = False, stop_gradient: bool = False):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(int(d) for d in shape) if shape is not None \
            else ()
        self.dtype = convert_dtype(dtype) if dtype is not None \
            else DT_FLOAT32
        self.persistable = persistable
        self.stop_gradient = stop_gradient

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={dtype_to_str(self.dtype)}, "
                f"persistable={self.persistable})")

    __str__ = __repr__


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, trainable=True, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = trainable
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.stop_gradient = not trainable


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

_uid_counter = [0]


def _next_uid() -> int:
    _uid_counter[0] += 1
    return _uid_counter[0]


def _names(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Operator:
    """One op in a block: slot name -> list of var names, plus attrs."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self._attrs: Dict[str, Any] = dict(attrs or {})
        self._attrs.setdefault(OP_UID_ATTR, _next_uid())
        self._inputs = {s: _names(v) for s, v in (inputs or {}).items()}
        self._outputs = {s: _names(v) for s, v in (outputs or {}).items()}

    def input(self, slot: str) -> List[str]:
        return self._inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self._outputs.get(slot, [])

    def input_slots(self):
        return list(self._inputs)

    def output_slots(self):
        return list(self._outputs)

    def attr(self, name: str, default=None):
        return self._attrs.get(name, default)

    def all_attrs(self):
        return {k: v for k, v in self._attrs.items()
                if not k.startswith("__")}

    @property
    def input_arg_names(self):
        return [n for ns in self._inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self._outputs.values() for n in ns]

    def __repr__(self):
        return f"Op({self.type}, in={self._inputs}, out={self._outputs})"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """Ordered ops + named vars. Sub-blocks (control flow) are not ported
    yet: a Program has its global block only."""

    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.idx = idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    # -- vars ---------------------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name") or unique_name.generate("_generated_var")
        kwargs["name"] = name
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        name = kwargs.get("name") or unique_name.generate("_param")
        kwargs["name"] = name
        gb = self.program.global_block()   # parameters live in block 0
        p = Parameter(gb, kwargs.pop("shape"), kwargs.pop("dtype"),
                      **kwargs)
        gb.vars[name] = p
        return p

    def find_var(self, name: str) -> Optional[Variable]:
        return self.vars.get(name)

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self._infer_op_shapes(op)
        return op

    def _infer_op_shapes(self, op: Operator):
        """Run the lowering on meta tensors, -1 dims replaced by a
        sentinel; write the inferred shapes/dtypes onto the outputs."""
        info = OPS.get(op.type)
        env: Dict[str, Any] = {}
        for name in op.input_arg_names:
            if name in env:
                continue
            v = self.find_var(name)
            if v is None:
                raise ValueError(f"op {op.type!r}: unknown input var "
                                 f"{name!r}")
            shape = [_DYN_SENTINEL if d == -1 else d for d in v.shape]
            env[name] = torch.empty(shape, dtype=dtype_to_torch(v.dtype),
                                    device=_META)
        try:
            info.lowering(ExecContext(op, env, _META))
        except NotImplementedError:
            # no meta kernel for some torch op: shapes stay as declared
            return
        for name in op.output_arg_names:
            val = env.get(name)
            v = self.find_var(name)
            if val is None or v is None:
                continue
            v.shape = tuple(
                -1 if (d >= _DYN_SENTINEL and d % _DYN_SENTINEL == 0)
                else int(d) for d in val.shape)
            v.dtype = convert_dtype(val.dtype)

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={[o.type for o in self.ops]})"


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

class Program:
    """A list of blocks; block 0 is the global block."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.random_seed = 0

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[0]   # no sub-blocks yet

    def all_parameters(self):
        return self.global_block().all_parameters()

    def __repr__(self):
        return (f"Program(blocks={len(self.blocks)}, "
                f"ops={[o.type for o in self.global_block().ops]})")


# ---------------------------------------------------------------------------
# default programs + guards
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
