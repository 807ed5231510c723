"""Data-entry layers (counterpart of paddle_tpu/layers/io.py: data)."""
from __future__ import annotations

from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32",
         stop_gradient=True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            stop_gradient=stop_gradient)
