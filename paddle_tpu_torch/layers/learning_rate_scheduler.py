"""Learning-rate schedules as graph ops over a persistable step counter
(counterpart of paddle_tpu/layers/learning_rate_scheduler.py):
noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup.

The first schedule built into a program creates the float32 [1]
persistable @LR_GLOBAL_STEP@ (0 after the startup program) and one
increment op that advances it at every run, before the schedule's ops
read it; every later schedule of the program reads the same counter.
The rate is a [1] float32 var of the main program, which the optimizer
takes as its learning rate: the adam, sgd and momentum ops (and their
group lowerings) read it from the device at every step, so a captured
step replays the increment and the schedule on the card and reads the
new rate, with no value taken on the host. piecewise_decay selects its
value arithmetically (cond * v + (1 - cond) * lr), as the JAX package's
does, so it holds no Switch and no sub-block.
"""
from __future__ import annotations

import math

from ..layer_helper import LayerHelper
from . import nn as nn_layers
from . import tensor
from .math_ops import less_than

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup",
]

_STEP_VAR = "@LR_GLOBAL_STEP@"


def _global_step():
    """The program's step counter, created (with its increment) at the
    first call."""
    helper = LayerHelper("global_step")
    block = helper.main_program.global_block()
    if block.has_var(_STEP_VAR):
        return block.vars[_STEP_VAR]
    counter = tensor.create_global_var([1], 0.0, "float32",
                                       persistable=True, name=_STEP_VAR)
    helper.append_op("increment", inputs={"X": counter},
                     outputs={"Out": counter}, attrs={"step": 1.0})
    return counter


def _decayed_steps(decay_steps, staircase):
    div = _global_step() / float(decay_steps)
    return nn_layers.floor(div) if staircase else div


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 * min(step^-0.5, step * warmup_steps^-1.5)."""
    step = _global_step()
    a = step ** -0.5
    b = step * float(warmup_steps) ** -1.5
    return (float(d_model) ** -0.5) * nn_layers.elementwise_min(a, b)


def _pow_scalar(base, exp_var):
    """base ** exp_var as exp(exp_var * ln base)."""
    return nn_layers.exp(tensor.scale(exp_var, scale=math.log(base)))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate * decay_rate ^ (step / decay_steps)."""
    div = _decayed_steps(decay_steps, staircase)
    return tensor.scale(_pow_scalar(float(decay_rate), div),
                        scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate * exp(-decay_rate * step / decay_steps)."""
    div = _decayed_steps(decay_steps, staircase)
    return tensor.scale(nn_layers.exp(tensor.scale(div, scale=-decay_rate)),
                        scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """learning_rate / (1 + decay_rate * step / decay_steps)."""
    div = _decayed_steps(decay_steps, staircase)
    denom = tensor.scale(div, scale=float(decay_rate), bias=1.0,
                         bias_after_scale=True)
    one = tensor.fill_constant([1], "float32", learning_rate)
    return nn_layers.elementwise_div(one, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(learning_rate - end) * (1 - step / decay_steps)^power + end, the
    step capped at decay_steps, or with `cycle` decay_steps stretched to
    the next multiple of itself past the step."""
    step = _global_step()
    if cycle:
        div_res = nn_layers.ceil(step / float(decay_steps))
        one = tensor.fill_constant([1], "float32", 1.0)
        div_res = nn_layers.elementwise_max(div_res, one)
        ratio = nn_layers.elementwise_div(
            step, tensor.scale(div_res, scale=float(decay_steps)))
    else:
        ratio = tensor.scale(nn_layers.elementwise_min(
            step, tensor.fill_constant([1], "float32", decay_steps)),
            scale=1.0 / decay_steps)
    one_minus = tensor.scale(ratio, scale=-1.0, bias=1.0)
    pw = nn_layers.pow(one_minus, factor=float(power))
    return tensor.scale(pw, scale=float(learning_rate - end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i] (the first such i), else
    values[-1]: selected arithmetically, smallest boundary last."""
    step = _global_step()
    lr = tensor.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = less_than(step, tensor.fill_constant([1], "float32",
                                                    float(b)))
        vvar = tensor.fill_constant([1], "float32", float(v))
        c = tensor.cast(cond, "float32")
        lr = nn_layers.elementwise_add(
            nn_layers.elementwise_mul(c, vvar),
            nn_layers.elementwise_mul(tensor.scale(c, -1.0, 1.0), lr))
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """learning_rate / 2 * (cos(pi * epoch / epochs) + 1), epoch =
    floor(step / step_each_epoch)."""
    epoch = nn_layers.floor(tensor.scale(_global_step(),
                                         scale=1.0 / step_each_epoch))
    inner = tensor.scale(epoch, scale=math.pi / epochs)
    return tensor.scale(tensor.scale(nn_layers.cos(inner), scale=1.0,
                                     bias=1.0),
                        scale=0.5 * learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr + (end_lr - start_lr) * step / warmup_steps while step <
    warmup_steps, then learning_rate (a number or a schedule's var)."""
    step = _global_step()
    warm = tensor.fill_constant([1], "float32", float(warmup_steps))
    cond = tensor.cast(less_than(step, warm), "float32")
    ramp = tensor.scale(step, scale=(end_lr - start_lr) / warmup_steps,
                        bias=start_lr)
    if isinstance(learning_rate, float):
        learning_rate = tensor.fill_constant([1], "float32", learning_rate)
    return nn_layers.elementwise_add(
        nn_layers.elementwise_mul(cond, ramp),
        nn_layers.elementwise_mul(tensor.scale(cond, -1.0, 1.0),
                                  learning_rate))
