"""Data-entry layers (counterpart of paddle_tpu/layers/io.py: data and
load)."""
from __future__ import annotations

from ..framework import default_main_program

__all__ = ["data", "load"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    """A feed variable. `lod_level` (recorded on its VarDesc) is the
    number of LoD levels its LoDTensor feeds carry; `type` is accepted
    as the reference takes it and changes nothing: a dense tensor."""
    del type
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level,
                            stop_gradient=stop_gradient)


def load(out, file_path, load_as_fp16=None):
    """A load op filling `out` from the tensor file `file_path` (a host
    read: its block runs eagerly)."""
    from ..layer_helper import LayerHelper
    LayerHelper("load").append_op(
        "load", inputs={}, outputs={"Out": out},
        attrs={"file_path": file_path,
               "load_as_fp16": bool(load_as_fp16)})
    return out
