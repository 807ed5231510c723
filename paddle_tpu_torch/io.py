"""Checkpoints and inference models (counterpart of paddle_tpu/io.py):
save_vars / save_params / save_persistables, load_vars / load_params /
load_persistables, save_inference_model / load_inference_model, and
load_params_from_numpy.

The files are the JAX package's, byte for byte, so either package reads
what the other wrote:

* a tensor file is, per tensor, the magic ``PTCK``, ``<II`` (metadata
  length, payload length), JSON metadata ``{"name", "lod"}`` and an
  ``.npy`` payload written with allow_pickle=False; one file per
  variable (named after it) or all in one file (`filename`). Metadata
  that is not JSON (a pickle) is refused, and nothing is unpickled.
* ``__model__`` is format version 2: ``<I`` version, ``<I`` metadata
  length, JSON metadata ``{"feed", "fetch"}``, then the ProgramDesc
  bytes (proto/framework_desc.py) of the program pruned to what the
  fetch targets need, stamped with the op versions (core/op_version.py).

Values are read from and written to the global scope, as in the JAX
package: run under ``scope_guard`` to use another. A loaded tensor goes
to the executor's place. The JAX package's asynchronous sharded
checkpoint layout (FLAGS_async_checkpoint) is not ported.
"""
from __future__ import annotations

import contextlib
import io as _io
import json
import os
import struct
import warnings
from typing import Mapping, Sequence

import numpy as np

from .core.op_version import check_program, stamp_program
from .core.scope import Scope, global_scope, tensor_to_numpy
from .framework import Parameter, Program, Variable, default_main_program
from .proto import framework_desc as fd

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "load_params_from_numpy",
]

_MAGIC = b"PTCK"
_MODEL_FORMAT = 2   # __model__ with JSON metadata


def _is_persistable(var: Variable) -> bool:
    return var.persistable and var.kind not in (
        fd.VK_FEED_MINIBATCH, fd.VK_FETCH_LIST, fd.VK_READER, fd.VK_RAW)


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


@contextlib.contextmanager
def _atomic_write(path: str):
    """Write a sibling file, then rename it over `path`: the file at
    `path` is the old content or the whole new one, never a part."""
    tmp = path + ".tmp"
    f = open(tmp, "wb")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def _serialize_tensor(f, name: str, arr: np.ndarray, lod=()):
    payload = _io.BytesIO()
    np.save(payload, arr, allow_pickle=False)
    meta = json.dumps({"name": name,
                       "lod": [[int(x) for x in level] for level in lod]}
                      ).encode("utf-8")
    f.write(_MAGIC)
    f.write(struct.pack("<II", len(meta), payload.getbuffer().nbytes))
    f.write(meta)
    f.write(payload.getvalue())


def _deserialize_tensors(f):
    """{name: (array, lod)} of every tensor in a tensor file."""
    out = {}
    while True:
        head = f.read(4)
        if not head:
            return out
        if head != _MAGIC:
            raise ValueError("corrupt tensor file: bad chunk magic")
        meta_len, data_len = struct.unpack("<II", f.read(8))
        raw_meta = f.read(meta_len)
        try:
            meta = json.loads(raw_meta.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            raise ValueError(
                "tensor file carries non-JSON (pickled?) metadata; "
                "refusing to unpickle checkpoint data: save it again "
                "with a current build") from None
        out[meta["name"]] = (np.load(_io.BytesIO(f.read(data_len)),
                                     allow_pickle=False),
                             meta.get("lod") or [])


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, raise_on_missing=False):
    """Write the vars of `main_program` that `predicate` accepts (or
    `vars`) from the global scope: one file per var, or all in
    `filename`. Missing or uninitialized vars are skipped with a
    warning, or refused before anything is written with
    raise_on_missing."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    present, skipped = [], []
    for v in vars:
        sv = scope.find_var(v.name)
        if sv is None or not sv.is_initialized():
            skipped.append(v.name)
        else:
            t = sv.get_tensor()
            present.append((v.name, tensor_to_numpy(t.tensor), t.lod()))
    if skipped:
        if raise_on_missing:
            raise ValueError(
                f"save_vars: variable(s) {sorted(skipped)} are missing or "
                f"uninitialized in the scope; refusing to write a "
                f"checkpoint that leaves them out")
        warnings.warn(f"save_vars skipped missing/uninitialized variables: "
                      f"{sorted(skipped)}", stacklevel=2)
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        with _atomic_write(os.path.join(dirname, filename)) as f:
            for name, arr, lod in present:
                _serialize_tensor(f, name, arr, lod)
    else:
        for name, arr, lod in present:
            with _atomic_write(os.path.join(dirname, name)) as f:
                _serialize_tensor(f, name, arr, lod)


def save_params(executor, dirname, main_program=None, filename=None,
                raise_on_missing=False):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename,
                     raise_on_missing=raise_on_missing)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      raise_on_missing=False):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     raise_on_missing=raise_on_missing)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Read the vars of `main_program` that `predicate` accepts (or
    `vars`) into the global scope, on the executor's place. Without
    `filename` a wanted var with no file is an error (a partial
    checkpoint)."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    place = executor.place if executor is not None else None
    if filename is not None:
        wanted = {v.name for v in vars}
        with open(os.path.join(dirname, filename), "rb") as f:
            tensors = _deserialize_tensors(f)
        tensors = {n: a for n, a in tensors.items() if n in wanted}
    else:
        tensors = {}
        for v in vars:
            path = os.path.join(dirname, v.name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"checkpoint {dirname!r} has no file for variable "
                    f"{v.name!r}: partial or corrupt checkpoint")
            with open(path, "rb") as f:
                tensors.update(_deserialize_tensors(f))
    for name, (arr, lod) in tensors.items():
        t = scope.var(name).get_tensor()
        t.set(arr, place)
        t.set_lod(lod)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


# ---------------------------------------------------------------------------
# inference models
# ---------------------------------------------------------------------------

def _prune_program(program: Program, fetch_names: Sequence[str]) -> Program:
    """A test clone of `program` keeping only the forward ops of block
    0 that the fetch targets need (paddle_tpu/io.py _prune_program).
    Every sub-block is kept, those the kept control-flow ops name among
    them, as the JAX package keeps them: its __model__ is the same
    bytes."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if set(op.output_arg_names) & needed:
            keep.append(op)
            needed.update(op.input_arg_names)
    keep.reverse()
    block.ops = [op for op in keep
                 if op.attr("op_role", "forward") == "forward"]
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Write ``__model__`` (the pruned program) and, unless program_only,
    the persistables it holds. Returns the fetch names."""
    main_program = main_program or default_main_program()
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    pruned = _prune_program(main_program, fetch_names)
    os.makedirs(dirname, exist_ok=True)
    meta = json.dumps({"feed": list(feeded_var_names),
                       "fetch": fetch_names}).encode("utf-8")
    with _atomic_write(os.path.join(dirname,
                                    model_filename or "__model__")) as f:
        f.write(struct.pack("<I", _MODEL_FORMAT))
        f.write(struct.pack("<I", len(meta)))
        f.write(meta)
        f.write(stamp_program(pruned.to_proto()).SerializeToString())
    if not program_only:
        save_persistables(executor, dirname, pruned,
                          filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, pserver_endpoints=None):
    """(program, feed names, fetch vars) of a saved inference model, its
    persistables loaded into the global scope."""
    model_path = os.path.join(dirname, model_filename or "__model__")
    with open(model_path, "rb") as f:
        struct.unpack("<I", f.read(4))        # format version
        (meta_len,) = struct.unpack("<I", f.read(4))
        raw_meta = f.read(meta_len)
        try:
            meta = json.loads(raw_meta.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            raise ValueError(
                f"inference model {model_path!r} carries non-JSON "
                f"(pickled?) metadata; refusing to unpickle it: export it "
                f"again with a current build") from None
        proto = check_program(fd.ProgramDesc.FromString(f.read()))
    program = Program.from_proto(proto)
    load_persistables(executor, dirname, program, filename=params_filename)
    block = program.global_block()
    fetch_vars = []
    for n in meta["fetch"]:
        if block.find_var(n) is None:
            raise KeyError(f"inference model {model_path!r}: fetch target "
                           f"{n!r} is not a var of its program")
        fetch_vars.append(block.find_var(n))
    return program, meta["feed"], fetch_vars


def load_params_from_numpy(scope: Scope, arrays: Mapping[str, np.ndarray],
                           place):
    """Set each `name -> array` as a tensor on `place` in `scope`. This is
    how parameters initialized by another implementation (the JAX
    package names every Transformer parameter explicitly, as the port
    does) are carried into the port."""
    for name, arr in arrays.items():
        scope.var(name).get_tensor().set(np.asarray(arr), place)
