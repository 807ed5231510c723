"""Mixed-precision optimizer decorator (counterpart of
paddle_tpu/contrib/mixed_precision/decorator.py): bf16 compute with the
float32 parameters as master weights, and a static loss scale. bf16 has
float32's exponent range, so the scale defaults to 1 (no scale ops).
Dynamic loss scaling (the JAX package's stability-guard path) is not
ported: asking for it raises.

backward() sets Program._amp (dtype and op lists); the engine runs the
whole block under that policy (core/amp.py), forward, backward and
optimizer ops alike.
"""
from __future__ import annotations

import torch

from ... import layers
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, dtype="bfloat16"):
        if use_dynamic_loss_scaling:
            raise NotImplementedError(
                "dynamic loss scaling is not ported to paddle_tpu_torch; "
                "bf16 needs none (pass init_loss_scaling for a static "
                "scale)")
        if dtype not in ("bfloat16", "bf16"):
            raise NotImplementedError(
                f"paddle_tpu_torch mixed precision runs bfloat16, not "
                f"{dtype!r}")
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scaling = float(init_loss_scaling)
        self._dtype = torch.bfloat16

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        program._amp = {"dtype": self._dtype,
                        "black_ops": frozenset(self._amp_lists.black_list),
                        "white_ops": frozenset(self._amp_lists.white_list)}
        program._bump_version()
        scale = self._loss_scaling
        scaled_loss = layers.scale(loss, scale=scale) if scale != 1.0 \
            else loss
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        if scale != 1.0:
            params_grads = [(p, layers.scale(g, scale=1.0 / scale))
                            for p, g in params_grads]
        return scaled_loss, params_grads

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        scaled_loss, params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set)
        self._optimizer.apply_gradients(params_grads)
        return scaled_loss, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False, dtype="bfloat16"):
    """Wrap `optimizer` for bf16 mixed-precision training."""
    return OptimizerWithMixedPrecision(optimizer, amp_lists,
                                       init_loss_scaling,
                                       use_dynamic_loss_scaling, dtype)
