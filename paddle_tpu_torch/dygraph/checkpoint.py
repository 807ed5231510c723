"""Dygraph checkpoints (counterpart of paddle_tpu/dygraph/checkpoint.py):
one `__dygraph__` file, a pickle of a name -> numpy dict, the same file
the JAX package writes and reads."""
from __future__ import annotations

import os
import pickle

__all__ = ["save_persistables", "load_persistables"]


def save_persistables(model_dict, dirname="save_dir", optimizers=None):
    os.makedirs(dirname, exist_ok=True)
    if hasattr(model_dict, "state_dict"):
        model_dict = model_dict.state_dict()
    arrays = {name: vb.numpy() for name, vb in model_dict.items()}
    with open(os.path.join(dirname, "__dygraph__"), "wb") as f:
        pickle.dump(arrays, f)


def load_persistables(dirname="save_dir"):
    with open(os.path.join(dirname, "__dygraph__"), "rb") as f:
        return pickle.load(f)
