"""Op versions and the compatibility check of serialized programs
(counterpart of paddle_tpu/core/op_version.py, on the port's own
ProgramDesc messages, proto/framework_desc.py).

Each op type has a version (default 1), bumped when its attr or semantic
contract changes. `stamp_program` appends a reserved carrier op,
``@OP_VERSIONS@``, to block 0 with one AT_LONG attr per op type used;
`check_program` refuses a program that needs a newer version of an op
than this runtime implements, and strips the carrier. The carrier and
its name are the JAX package's, so each side accepts the other's files.
"""
from __future__ import annotations

from typing import Dict

from ..proto import framework_desc as fd

__all__ = ["register_op_version", "get_op_version", "stamp_program",
           "check_program", "OpVersionError", "VERSION_OP"]

_VERSIONS: Dict[str, int] = {}
VERSION_OP = "@OP_VERSIONS@"     # reserved carrier op type


class OpVersionError(RuntimeError):
    pass


def register_op_version(op_type: str, version: int):
    """Bump when an op's attr or semantic contract changes."""
    _VERSIONS[op_type] = int(version)


def get_op_version(op_type: str) -> int:
    return _VERSIONS.get(op_type, 1)


def stamp_program(proto: fd.ProgramDesc) -> fd.ProgramDesc:
    """Record the version of every op type used in the program as the
    attrs of a carrier op appended to block 0."""
    if not proto.blocks:
        return proto
    used = {op.type for blk in proto.blocks for op in blk.ops}
    used.discard(VERSION_OP)
    # the JAX package writes AT_INT's number (1) here
    proto.blocks[0].ops.append(fd.OpDesc(type=VERSION_OP, attrs=[
        fd.Attr(name=t, type=fd.AT_INT, i=get_op_version(t))
        for t in sorted(used)]))
    return proto


def check_program(proto: fd.ProgramDesc, strip: bool = True):
    """Raise OpVersionError if the program needs newer op semantics than
    this runtime provides; optionally strip the carrier op."""
    for blk in proto.blocks:
        keep = []
        for op in blk.ops:
            if op.type != VERSION_OP:
                keep.append(op)
                continue
            for a in op.attrs:
                runtime_v = get_op_version(a.name)
                if a.i > runtime_v:
                    raise OpVersionError(
                        f"program was saved with op {a.name!r} version "
                        f"{a.i}, but this runtime implements version "
                        f"{runtime_v}: upgrade the framework or export "
                        f"the model again")
        if strip:
            blk.ops = keep
    return proto
