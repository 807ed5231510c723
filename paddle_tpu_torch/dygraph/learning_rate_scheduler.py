"""Dygraph learning-rate schedules (counterpart of
paddle_tpu/dygraph/learning_rate_scheduler.py): host-side
LearningRateDecay objects, stepped by every optimizer.minimize call; the
eager counterpart of the graph-mode schedule ops. Under
dygraph.jit.capture a schedule advances only when the step is captured:
the rate is baked into the graph."""
from __future__ import annotations

import math

__all__ = ["LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "NoamDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step
        self.dtype = dtype

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return float(lr)

    def create_lr_var(self, lr):
        """Reference LearningRateDecay.create_lr_var: wrap a python
        scalar as a dygraph variable holding the current lr."""
        import torch
        from .. import framework
        from .tracer import VarBase
        tracer = framework._dygraph_tracer()
        return VarBase(torch.full((1,), float(lr), dtype=torch.float32,
                                  device=tracer.device if tracer else None),
                       stop_gradient=True)

    def step(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr * math.exp(-self.decay_rate * div)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr * (self.decay_rate ** div)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.end_lr = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        t = self.step_num
        steps = self.decay_steps
        if self.cycle:
            mult = max(1.0, math.ceil(t / steps) if t > 0 else 1.0)
            steps = steps * mult
        else:
            t = min(t, steps)
        return (self.lr - self.end_lr) * \
            (1 - t / steps) ** self.power + self.end_lr


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.lr = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.lr * 0.5 * (math.cos(epoch * math.pi /
                                         self.epochs) + 1)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        n = max(self.step_num, 1)
        return (self.d_model ** -0.5) * min(
            n ** -0.5, n * (self.warmup_steps ** -1.5))
