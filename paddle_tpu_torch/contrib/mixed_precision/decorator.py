"""Mixed-precision optimizer decorator (counterpart of
paddle_tpu/contrib/mixed_precision/decorator.py): bf16 compute with the
float32 parameters as master weights, and a static loss scale. bf16 has
float32's exponent range, so the scale defaults to 1 (no scale ops).
decorate() and the class take the JAX package's arguments in its order
and with its defaults; the dynamic-scaling knobs (incr_every_n_steps,
decr_every_n_nan_or_inf, incr_ratio, decr_ratio) are stored, but
dynamic loss scaling itself (the JAX package's stability-guard path)
and float16 are not ported: asking for either raises.

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
                 use_dynamic_loss_scaling=False, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                 decr_ratio=0.8, dtype="bfloat16"):
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
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._dtype = torch.bfloat16

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """callbacks: the JAX package takes the argument and calls
        nothing; the port refuses one rather than drop it unseen."""
        if callbacks is not None:
            raise NotImplementedError(
                "backward(callbacks=...): gradient callbacks are not "
                "ported")
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
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False, dtype="bfloat16"):
    """Wrap `optimizer` for bf16 mixed-precision training (the JAX
    package's arguments, in its order)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        decr_ratio, dtype)
