"""The ProgramDesc messages of paddle_tpu/proto/framework.proto (proto3)
and their wire format, in plain Python: no protobuf package.

Each message class lists its fields as (number, name, kind, repeated);
a kind is a scalar type name of the .proto or a message class.
``SerializeToString`` writes what protobuf writes for the same values:
fields in field-number order; scalars equal to their default omitted
(proto3; a float counts as default only when its bits are 0, so -0.0 is
written); repeated scalars packed; int32 and int64 in two's complement
(a negative int32 takes a 10-byte varint), sint32 and sint64 zigzag,
float as fixed32 and double as fixed64; a singular message field
written whenever it is set, even when empty. ``FromString`` reads that
format, packed or not, merges a repeated singular message as protobuf
does, and skips unknown fields. So the JAX package's files
(Program.serialize_to_string, the ``__model__`` of
save_inference_model) and the port's are the same bytes.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = [
    "Message", "TensorDesc", "VarDesc", "Attr", "IOSlot", "OpDesc",
    "BlockDesc", "ProgramDesc",
]

# enum VarKind
VK_RAW = 0
VK_DENSE_TENSOR = 1
VK_SELECTED_ROWS = 2
VK_TENSOR_ARRAY = 3
VK_READER = 4
VK_STEP_SCOPES = 5
VK_RNG_STATE = 6
VK_FEED_MINIBATCH = 7
VK_FETCH_LIST = 8

# enum AttrType
AT_NONE = 0
AT_INT = 1
AT_FLOAT = 2
AT_STRING = 3
AT_INTS = 4
AT_FLOATS = 5
AT_STRINGS = 6
AT_BOOL = 7
AT_BOOLS = 8
AT_LONG = 9
AT_LONGS = 10
AT_BLOCK = 11
AT_BLOCKS = 12

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1
_RANGES = {"int32": 32, "sint32": 32, "enum": 32, "int64": 64,
           "sint64": 64}
_WIRE = {"int32": _VARINT, "int64": _VARINT, "sint32": _VARINT,
         "sint64": _VARINT, "enum": _VARINT, "bool": _VARINT,
         "float": _FIXED32, "double": _FIXED64, "string": _LEN}


# ---------------------------------------------------------------------------
# scalars
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _check_range(kind, v):
    bits = _RANGES[kind]
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    if not lo <= v < hi:
        raise ValueError(f"value {v} out of range for {kind}")


def _encode_scalar(kind: str, v) -> bytes:
    if kind in ("int32", "int64", "enum"):
        v = int(v)
        _check_range(kind, v)
        return _varint(v & _MASK64)
    if kind in ("sint32", "sint64"):
        v = int(v)
        _check_range(kind, v)
        return _varint(((v << 1) ^ (v >> 63)) & _MASK64)
    if kind == "bool":
        return b"\x01" if v else b"\x00"
    if kind == "float":
        # as protobuf stores a double in a float field: round to nearest,
        # overflow to +-inf
        with np.errstate(over="ignore"):
            return np.array(v, dtype="<f4").tobytes()
    if kind == "double":
        return struct.pack("<d", float(v))
    if kind == "string":
        data = v.encode("utf-8")
        return _varint(len(data)) + data
    raise TypeError(f"unknown scalar kind {kind!r}")


def _is_default(kind: str, v) -> bool:
    if kind in ("float", "double"):
        return _encode_scalar(kind, v) in (b"\0" * 4, b"\0" * 8)
    return not v


def _signed(n: int, bits: int) -> int:
    n &= (1 << bits) - 1
    return n - (1 << bits) if n >> (bits - 1) else n


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def varint(self) -> int:
        n = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n & _MASK64
            shift += 7
            if shift >= 70:
                raise ValueError("varint longer than 10 bytes")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("truncated field")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def skip(self, wire: int):
        if wire == _VARINT:
            self.varint()
        elif wire == _FIXED64:
            self.take(8)
        elif wire == _LEN:
            self.take(self.varint())
        elif wire == _FIXED32:
            self.take(4)
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _decode_scalar(kind: str, r: _Reader):
    if kind in ("int32", "enum"):
        return _signed(r.varint(), 32)
    if kind == "int64":
        return _signed(r.varint(), 64)
    if kind in ("sint32", "sint64"):
        n = r.varint()
        v = (n >> 1) ^ -(n & 1)
        return _signed(v, 32) if kind == "sint32" else v
    if kind == "bool":
        return r.varint() != 0
    if kind == "float":
        return struct.unpack("<f", r.take(4))[0]
    if kind == "double":
        return struct.unpack("<d", r.take(8))[0]
    if kind == "string":
        return r.take(r.varint()).decode("utf-8")
    raise TypeError(f"unknown scalar kind {kind!r}")


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

class Message:
    """A proto3 message: FIELDS holds (number, name, kind, repeated) in
    field-number order. Fields are plain attributes: lists for repeated
    fields, None for an unset message field."""

    FIELDS: Tuple[Tuple[int, str, Any, bool], ...] = ()

    def __init__(self, **values):
        for _, name, kind, repeated in self.FIELDS:
            if repeated:
                default: Any = []
            elif isinstance(kind, type):
                default = None
            else:
                default = {"string": "", "bool": False, "float": 0.0,
                           "double": 0.0}.get(kind, 0)
            setattr(self, name, default)
        for name, v in values.items():
            if not any(f[1] == name for f in self.FIELDS):
                raise AttributeError(f"{type(self).__name__} has no field "
                                     f"{name!r}")
            setattr(self, name, v)

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, f[1]) == getattr(other, f[1])
            for f in self.FIELDS)

    def __repr__(self):  # pragma: no cover - debugging aid
        vals = ", ".join(f"{f[1]}={getattr(self, f[1])!r}"
                         for f in self.FIELDS)
        return f"{type(self).__name__}({vals})"

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for num, name, kind, repeated in self.FIELDS:
            v = getattr(self, name)
            if isinstance(kind, type):
                for m in (v if repeated else ([] if v is None else [v])):
                    data = m.SerializeToString()
                    out += _varint(num << 3 | _LEN) + _varint(len(data))
                    out += data
            elif repeated and kind == "string":
                for s in v:
                    out += _varint(num << 3 | _LEN) + \
                        _encode_scalar(kind, s)
            elif repeated:
                if v:
                    data = b"".join(_encode_scalar(kind, x) for x in v)
                    out += _varint(num << 3 | _LEN) + _varint(len(data))
                    out += data
            elif not _is_default(kind, v):
                out += _varint(num << 3 | _WIRE[kind])
                out += _encode_scalar(kind, v)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        msg._merge(_Reader(bytes(data)), len(data))
        return msg

    def _merge(self, r: _Reader, end: int):
        fields = {f[0]: f for f in self.FIELDS}
        while r.pos < end:
            tag = r.varint()
            num, wire = tag >> 3, tag & 7
            field = fields.get(num)
            if field is None:
                r.skip(wire)
                continue
            _, name, kind, repeated = field
            if isinstance(kind, type):
                if wire != _LEN:
                    raise ValueError(f"{name}: wire type {wire} for a "
                                     f"message")
                n = r.varint()
                if repeated:
                    sub = kind()
                    getattr(self, name).append(sub)
                else:
                    sub = getattr(self, name)
                    if sub is None:
                        sub = kind()
                        setattr(self, name, sub)
                sub._merge(r, r.pos + n)
            elif repeated and wire == _LEN and kind != "string":
                n = r.varint()                  # packed
                stop = r.pos + n
                vals = getattr(self, name)
                while r.pos < stop:
                    vals.append(_decode_scalar(kind, r))
                if r.pos != stop:
                    raise ValueError(f"{name}: bad packed length")
            else:
                if wire != _WIRE[kind]:
                    raise ValueError(f"{name}: wire type {wire} for "
                                     f"{kind}")
                v = _decode_scalar(kind, r)
                if repeated:
                    getattr(self, name).append(v)
                else:
                    setattr(self, name, v)
        if r.pos != end:
            raise ValueError(f"{type(self).__name__}: truncated message")


class TensorDesc(Message):
    FIELDS = ((1, "data_type", "enum", False),
              (2, "dims", "int64", True),
              (3, "lod_level", "int32", False))


class VarDesc(Message):
    FIELDS = ((1, "name", "string", False),
              (2, "kind", "enum", False),
              (3, "tensor", TensorDesc, False),
              (4, "persistable", "bool", False),
              (5, "stop_gradient", "bool", False),
              (6, "dim_sharding", "string", True))


class Attr(Message):
    FIELDS = ((1, "name", "string", False),
              (2, "type", "enum", False),
              (3, "i", "sint64", False),
              (4, "f", "float", False),
              (5, "s", "string", False),
              (6, "ints", "sint64", True),
              (7, "floats", "float", True),
              (8, "strings", "string", True),
              (9, "b", "bool", False),
              (10, "bools", "bool", True),
              (11, "block_idx", "int32", False),
              (12, "block_idxs", "int32", True),
              (13, "d", "double", False))


class IOSlot(Message):
    FIELDS = ((1, "parameter", "string", False),
              (2, "arguments", "string", True))


class OpDesc(Message):
    FIELDS = ((1, "type", "string", False),
              (2, "inputs", IOSlot, True),
              (3, "outputs", IOSlot, True),
              (4, "attrs", Attr, True),
              (5, "is_target", "bool", False))


class BlockDesc(Message):
    FIELDS = ((1, "idx", "int32", False),
              (2, "parent_idx", "int32", False),
              (3, "vars", VarDesc, True),
              (4, "ops", OpDesc, True),
              (5, "forward_block_idx", "sint32", False))


class ProgramDesc(Message):
    FIELDS = ((1, "blocks", BlockDesc, True),
              (2, "version", "int64", False))

