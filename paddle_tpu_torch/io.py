"""Parameter I/O (counterpart of paddle_tpu/io.py). One function so far:
Program and persistable (de)serialization come with a codec that needs no
protobuf package."""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .core.scope import Scope

__all__ = ["load_params_from_numpy"]


def load_params_from_numpy(scope: Scope, arrays: Mapping[str, np.ndarray],
                           place):
    """Set each `name -> array` as a tensor on `place` in `scope`. This is
    how parameters initialized by another implementation (the JAX
    package names every Transformer parameter explicitly, as the port
    does) are carried into the port."""
    for name, arr in arrays.items():
        scope.var(name).get_tensor().set(np.asarray(arr), place)
