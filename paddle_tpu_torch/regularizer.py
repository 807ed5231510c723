"""Weight regularization (counterpart of paddle_tpu/regularizer.py). Only
the pass that Optimizer.apply_gradients calls is ported, and only its
pass-through path: with no regularizer, on the optimizer or on a
parameter, the (param, grad) pairs come back unchanged. A regularizer
raises until the decay ops are ported."""
from __future__ import annotations

__all__ = ["append_regularization_ops"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    for param, grad in parameters_and_grads:
        if grad is not None and (getattr(param, "regularizer", None)
                                 or regularization) is not None:
            raise NotImplementedError(
                "weight regularization is not ported to paddle_tpu_torch "
                "yet")
    return list(parameters_and_grads)
