"""LoDTensor helpers (counterpart of paddle_tpu/lod_tensor.py):
create_lod_tensor and create_random_int_lodtensor, over core.scope's
LoDTensor with recursive-sequence-length inputs."""
from __future__ import annotations

import numpy as np

from .core.scope import LoDTensor, create_lod_tensor  # noqa: F401

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place,
                                low, high):
    """A LoDTensor of int64 ids drawn from np.random in [low, high], one
    row of `base_shape` for each entry of the innermost level."""
    if not isinstance(base_shape, list):
        raise TypeError("base_shape should be a list")
    overall = [sum(recursive_seq_lens[-1])] + list(base_shape)
    data = np.random.randint(low, high + 1, overall).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
