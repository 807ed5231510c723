"""Gradient clipping (counterpart of paddle_tpu/clip.py). Only the pass
that Optimizer.apply_gradients calls is ported, and only its pass-through
path: with no clip set, on the program or on a parameter, the
(param, grad) pairs come back unchanged. Setting a clip raises until the
clip ops are ported."""
from __future__ import annotations

__all__ = ["append_gradient_clip_ops"]


def append_gradient_clip_ops(params_grads):
    if any(getattr(p, "gradient_clip_attr", None) for p, _ in params_grads):
        raise NotImplementedError(
            "gradient clipping is not ported to paddle_tpu_torch yet")
    return params_grads
