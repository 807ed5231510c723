"""Pruning (counterpart of paddle_tpu/contrib/slim/prune/): magnitude
pruning of parameters, unstructured or by whole output channels, with
masks kept so that fine-tuning holds the pruned slots at zero. A pruned
parameter stays dense, its pruned slots zeros, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .._state import read as _scope_arr, write as _write

__all__ = ["MagnitudePruner", "StructuredPruner", "apply_prune_masks"]


class MagnitudePruner:
    """Unstructured: zero the smallest-|w| fraction per parameter."""

    def __init__(self, scope=None):
        self._scope = scope

    def prune(self, program, params: Sequence[str],
              ratios: Sequence[float]) -> Dict[str, np.ndarray]:
        from ....executor import global_scope
        scope = self._scope or global_scope()
        masks = {}
        for name, ratio in zip(params, ratios):
            w = _scope_arr(scope, name)
            k = int(round(w.size * ratio))
            if k == 0:
                mask = np.ones_like(w)
            else:
                thresh = np.partition(np.abs(w).ravel(), k - 1)[k - 1]
                mask = (np.abs(w) > thresh).astype(w.dtype)
            _write(scope, name, w * mask)
            masks[name] = mask
        return masks


class StructuredPruner:
    """Structured: remove whole output channels (conv filter dim 0 / fc
    columns) ranked by L1 norm — the reference's filter pruning."""

    def __init__(self, scope=None, criterion: str = "l1_norm"):
        self._scope = scope
        self._criterion = criterion

    def prune(self, program, params: Sequence[str],
              ratios: Sequence[float]) -> Dict[str, np.ndarray]:
        from ....executor import global_scope
        scope = self._scope or global_scope()
        masks = {}
        for name, ratio in zip(params, ratios):
            w = _scope_arr(scope, name)
            if w.ndim >= 2:
                # conv [Cout, ...]: rank output filters; fc [in, out]:
                # rank output columns
                axis = 0 if w.ndim > 2 else 1
                red = tuple(i for i in range(w.ndim) if i != axis)
                score = np.abs(w).sum(axis=red)
                n_prune = int(round(score.size * ratio))
                keep = np.ones(score.size, bool)
                if n_prune:
                    keep[np.argsort(score)[:n_prune]] = False
                shape = [1] * w.ndim
                shape[axis] = score.size
                mask = keep.reshape(shape).astype(w.dtype)
            else:
                mask = np.ones_like(w)
            _write(scope, name, w * np.broadcast_to(mask, w.shape))
            masks[name] = mask
        return masks


def apply_prune_masks(scope, masks: Dict[str, np.ndarray]):
    """Re-zero pruned slots (call after each fine-tune step or epoch so
    optimizer updates cannot resurrect pruned weights)."""
    for name, mask in masks.items():
        w = _scope_arr(scope, name)
        _write(scope, name, w * np.broadcast_to(mask, w.shape))


from .strategies import (  # noqa: E402,F401
    PruneStrategy, UniformPruneStrategy, SensitivePruneStrategy,
    AutoPruneStrategy)

__all__ += ["PruneStrategy", "UniformPruneStrategy",
            "SensitivePruneStrategy", "AutoPruneStrategy"]
