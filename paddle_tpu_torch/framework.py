"""Program IR: Program / Block / Operator / Variable / Parameter.

Counterpart of paddle_tpu/framework.py. These classes are the desc;
`to_proto` / `from_proto` convert a Program to and from the ProgramDesc
messages of proto/framework_desc.py (the JAX package's schema and wire
format, written without a protobuf package), which `clone`,
`serialize_to_string` and `parse_from_string` use. Build-time shape
inference runs the op's torch lowering on ``device="meta"`` tensors, the
counterpart of the JAX package's jax.eval_shape: every lowering is
meta-safe, reading no tensor value on the host. A control-flow layer
builds its body in a sub-block (Program._create_block / _rollback);
the op names it by a block attr, written as AT_BLOCK.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.registry import GRAD_SUFFIX, OPS, ExecContext, OP_UID_ATTR
from .core.types import (DT_FLOAT32, convert_dtype, dtype_to_str,
                         dtype_to_torch)
from .proto import framework_desc as fd

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_startup_program", "default_main_program", "program_guard",
    "grad_var_name", "unique_name", "name_scope", "in_dygraph_mode",
    "_dygraph_tracer", "dygraph_guard_level",
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
# dygraph mode switch (the tracer lives in paddle_tpu_torch.dygraph)
# ---------------------------------------------------------------------------

_dygraph_tracer_holder = threading.local()


def _dygraph_tracer():
    return getattr(_dygraph_tracer_holder, "tracer", None)


def in_dygraph_mode() -> bool:
    return _dygraph_tracer() is not None


@contextlib.contextmanager
def dygraph_guard_level(tracer):
    old = getattr(_dygraph_tracer_holder, "tracer", None)
    _dygraph_tracer_holder.tracer = tracer
    try:
        yield
    finally:
        _dygraph_tracer_holder.tracer = old


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """Graph-mode symbolic variable."""

    def __init__(self, block: "Block", name: Optional[str] = None,
                 shape: Optional[Sequence[int]] = None, dtype=None,
                 lod_level: int = 0, persistable: bool = False,
                 stop_gradient: bool = False,
                 kind: int = fd.VK_DENSE_TENSOR, **kwargs):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(int(d) for d in shape) if shape is not None \
            else ()
        self.dtype = convert_dtype(dtype) if dtype is not None \
            else DT_FLOAT32
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.kind = kind
        self.is_data = kwargs.get("is_data", False)
        self.dim_sharding: List[str] = list(kwargs.get("dim_sharding", ()))

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={dtype_to_str(self.dtype)}, "
                f"persistable={self.persistable})")

    __str__ = __repr__

    # operator sugar: graph mode builds elementwise ops
    def _binary(self, other, op, reverse=False):
        from .layers import math_ops
        return math_ops.elementwise_binary_sugar(self, other, op, reverse)

    def __add__(self, o): return self._binary(o, "elementwise_add")
    def __radd__(self, o): return self._binary(o, "elementwise_add", True)
    def __sub__(self, o): return self._binary(o, "elementwise_sub")
    def __rsub__(self, o): return self._binary(o, "elementwise_sub", True)
    def __mul__(self, o): return self._binary(o, "elementwise_mul")
    def __rmul__(self, o): return self._binary(o, "elementwise_mul", True)
    def __truediv__(self, o): return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", True)

    def __pow__(self, o): return self._binary(o, "elementwise_pow")

    def __neg__(self):
        from .layers import tensor as _t
        return _t.scale(self, scale=-1.0)

    def to_proto(self) -> fd.VarDesc:
        return fd.VarDesc(
            name=self.name, kind=self.kind, persistable=self.persistable,
            stop_gradient=self.stop_gradient,
            tensor=fd.TensorDesc(data_type=self.dtype, dims=list(self.shape),
                                 lod_level=self.lod_level),
            dim_sharding=list(self.dim_sharding))

    @staticmethod
    def from_proto(block, p: fd.VarDesc) -> "Variable":
        t = p.tensor or fd.TensorDesc()
        return Variable(block, name=p.name, shape=t.dims,
                        dtype=t.data_type, persistable=p.persistable,
                        stop_gradient=p.stop_gradient,
                        lod_level=t.lod_level, kind=p.kind,
                        dim_sharding=list(p.dim_sharding or ()))


class Parameter(Variable):
    """Trainable persistable variable. optimize_attr carries a per-param
    learning-rate multiplier; regularizer and gradient_clip_attr are read
    by the optimizer's regularization and clip passes."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
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

    def _all_attrs(self):
        """Every attr, the internal ones (op uid) included."""
        return self._attrs.items()

    def all_attrs(self):
        return {k: v for k, v in self._attrs.items()
                if not k.startswith("__")}

    @property
    def input_arg_names(self):
        return [n for ns in self._inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self._outputs.values() for n in ns]

    def has_attr(self, name: str) -> bool:
        return name in self._attrs

    def set_attr(self, name, val):
        """Set an attr; the Program's version moves (its plans are made
        again)."""
        self._attrs[name] = val
        self.block.program._bump_version()

    def __repr__(self):
        return f"Op({self.type}, in={self._inputs}, out={self._outputs})"

    def to_proto(self) -> fd.OpDesc:
        return fd.OpDesc(
            type=self.type,
            inputs=[fd.IOSlot(parameter=s, arguments=list(n))
                    for s, n in self._inputs.items()],
            outputs=[fd.IOSlot(parameter=s, arguments=list(n))
                     for s, n in self._outputs.items()],
            attrs=[_encode_attr(k, v) for k, v in self._attrs.items()])

    @staticmethod
    def from_proto(block, p: fd.OpDesc) -> "Operator":
        """The op as it was written: no uid is added where it had none."""
        op = Operator.__new__(Operator)
        op.block = block
        op.type = p.type
        op._inputs = {s.parameter: list(s.arguments) for s in p.inputs}
        op._outputs = {s.parameter: list(s.arguments) for s in p.outputs}
        op._attrs = {a.name: _decode_attr(a) for a in p.attrs}
        return op


def _encode_attr(name, val) -> fd.Attr:
    """One attr as the JAX package writes it (paddle_tpu/framework.py
    _encode_attr): a bool is AT_BOOL, an int AT_LONG, a float AT_FLOAT in
    both `d` and `f`, a list by the type of its items (an empty list is
    AT_LONGS)."""
    a = fd.Attr(name=name)
    if isinstance(val, bool):
        a.type, a.b = fd.AT_BOOL, val
    elif isinstance(val, (int, np.integer)):
        a.type, a.i = fd.AT_LONG, int(val)
    elif isinstance(val, float):
        a.type, a.d, a.f = fd.AT_FLOAT, val, val
    elif isinstance(val, str):
        a.type, a.s = fd.AT_STRING, val
    elif isinstance(val, (list, tuple)):
        if all(isinstance(x, bool) for x in val) and val:
            a.type, a.bools = fd.AT_BOOLS, list(val)
        elif all(isinstance(x, (int, np.integer)) for x in val):
            a.type, a.ints = fd.AT_LONGS, [int(x) for x in val]
        elif all(isinstance(x, float) for x in val):
            a.type, a.floats = fd.AT_FLOATS, list(val)
        elif all(isinstance(x, str) for x in val):
            a.type, a.strings = fd.AT_STRINGS, list(val)
        else:
            raise TypeError(f"unsupported list attr {name}: {val!r}")
    elif isinstance(val, (Block, _BlockRef)):
        a.type, a.block_idx = fd.AT_BLOCK, val.idx
    elif val is None:
        a.type = fd.AT_NONE
    else:
        raise TypeError(f"unsupported attr type for {name}: {type(val)}")
    return a


def _decode_attr(a: fd.Attr):
    t = a.type
    if t == fd.AT_BOOL:
        return a.b
    if t in (fd.AT_INT, fd.AT_LONG):
        return int(a.i)
    if t == fd.AT_FLOAT:
        return float(a.d) if a.d else float(a.f)
    if t == fd.AT_STRING:
        return a.s
    if t in (fd.AT_INTS, fd.AT_LONGS):
        return [int(x) for x in a.ints]
    if t == fd.AT_FLOATS:
        return list(a.floats)
    if t == fd.AT_STRINGS:
        return list(a.strings)
    if t == fd.AT_BOOLS:
        return list(a.bools)
    if t == fd.AT_BLOCK:
        return _BlockRef(a.block_idx)
    if t == fd.AT_BLOCKS:
        return [_BlockRef(i) for i in a.block_idxs]
    return None


class _BlockRef:
    """A block attr read from a desc: the index of a block of the
    program that holds the op."""

    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = int(idx)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """Ordered ops + named vars. Block 0 is the global block; a
    control-flow op's sub-block (an AT_BLOCK attr) has a parent, whose
    vars it reads by name (_find_var_recursive, var)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        return (self.program.block(self.parent_idx)
                if self.parent_idx >= 0 else None)

    # -- vars ---------------------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name") or unique_name.generate("_generated_var")
        kwargs["name"] = name
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        name = kwargs.get("name") or unique_name.generate("_param")
        kwargs["name"] = name
        gb = self.program.global_block()   # parameters live in block 0
        p = Parameter(gb, kwargs.pop("shape"), kwargs.pop("dtype"),
                      **kwargs)
        gb.vars[name] = p
        self.program._bump_version()
        return p

    def find_var(self, name: str) -> Optional[Variable]:
        return self.vars.get(name)

    def var(self, name: str) -> Variable:
        """The var of that name, in this block or an ancestor."""
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f"variable {name!r} not found in block "
                             f"{self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None,
                  attrs=None, infer_shape: bool = True) -> Operator:
        """Append an op; with infer_shape, run its lowering on meta
        tensors and write the output shapes and dtypes (grad ops are
        appended without: their vars take the forward vars' shapes)."""
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        if infer_shape:
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
            v = self._find_var_recursive(name)
            if v is None:
                raise ValueError(f"op {op.type!r}: unknown input var "
                                 f"{name!r}")
            shape = [_DYN_SENTINEL if d == -1 else d for d in v.shape]
            env[name] = torch.empty(shape, dtype=dtype_to_torch(v.dtype),
                                    device=_META)
        try:
            info.lowering(ExecContext(op, env, _META))
        except Exception:
            # no meta kernel for some torch op, or shapes that only the
            # data settle (a sentinel dim plus a static one, as a decode
            # step's concat of the cache and the new token gives): the
            # shapes stay as declared, as the JAX package leaves them
            return
        for name in op.output_arg_names:
            val = env.get(name)
            v = self._find_var_recursive(name)
            if not isinstance(val, torch.Tensor) or v is None:
                continue
            v.shape = tuple(
                -1 if (d >= _DYN_SENTINEL and d % _DYN_SENTINEL == 0)
                else int(d) for d in val.shape)
            v.dtype = convert_dtype(val.dtype)

    def to_proto(self) -> fd.BlockDesc:
        return fd.BlockDesc(idx=self.idx, parent_idx=self.parent_idx,
                            forward_block_idx=self.forward_block_idx,
                            vars=[v.to_proto() for v in self.vars.values()],
                            ops=[op.to_proto() for op in self.ops])

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={[o.type for o in self.ops]})"


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

class Program:
    """A list of blocks; block 0 is the global block. `_amp` is the
    mixed-precision config the decorator sets (None: no AMP); `_uid` is
    unique per Program object and keys the per-scope run counter that
    seeds random ops."""

    _next_uid = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._uid = next(Program._next_uid)
        self._version = 0
        self._amp = None

    def _bump_version(self):
        self._version += 1

    @property
    def fingerprint(self):
        """(uid, version): changes with every mutation of the Program,
        so it keys the engine's per-step plans."""
        return (self._uid, self._version)

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block, child of the current one (or of `parent_idx`),
        made current: a control-flow layer builds its body there."""
        parent = self.current_block_idx if parent_idx is None \
            else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """A copy through the serialized form, as the JAX package clones.
        The desc has no parameter flag, so Parameters are restored from
        this Program; with for_test every op that has an is_test attr
        gets is_test=True. The seed and the AMP config carry over."""
        p = Program.from_proto(self.to_proto())
        p.random_seed = self.random_seed
        p._amp = self._amp
        for sb, db in zip(self.blocks, p.blocks):
            for name, v in sb.vars.items():
                old = db.vars.get(name)
                if isinstance(v, Parameter) and old is not None:
                    param = Parameter(
                        db, old.shape, old.dtype, name=name,
                        persistable=old.persistable, trainable=v.trainable,
                        optimize_attr=dict(v.optimize_attr),
                        regularizer=v.regularizer,
                        gradient_clip_attr=v.gradient_clip_attr,
                        do_model_average=v.do_model_average,
                        lod_level=old.lod_level, kind=old.kind)
                    db.vars[name] = param
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if op.has_attr("is_test"):
                        op._attrs["is_test"] = True
        p._bump_version()
        return p

    # ---- serialization ------------------------------------------------------
    def to_proto(self) -> fd.ProgramDesc:
        return fd.ProgramDesc(version=1,
                              blocks=[b.to_proto() for b in self.blocks])

    def serialize_to_string(self) -> bytes:
        return self.to_proto().SerializeToString()

    @staticmethod
    def parse_from_string(s: bytes) -> "Program":
        return Program.from_proto(fd.ProgramDesc.FromString(s))

    @staticmethod
    def from_proto(proto: fd.ProgramDesc) -> "Program":
        prog = Program()
        if proto.blocks:
            prog.blocks = []
        for bp in proto.blocks:
            b = Block(prog, bp.idx, bp.parent_idx)
            b.forward_block_idx = bp.forward_block_idx
            for vp in bp.vars:
                b.vars[vp.name] = Variable.from_proto(b, vp)
            b.ops = [Operator.from_proto(b, opp) for opp in bp.ops]
            prog.blocks.append(b)
        prog._bump_version()
        return prog

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


def grad_var_name(name: str) -> str:
    """The name of the gradient variable of `name` (`name@GRAD`)."""
    return name + GRAD_SUFFIX


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


@contextlib.contextmanager
def name_scope(prefix: str):
    """Accepted for the reference's scripts; names are unaffected, as in
    the JAX package."""
    yield
