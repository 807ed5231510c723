"""Activation ops (counterpart of paddle_tpu/ops/activations.py: relu,
sigmoid, tanh, square and log)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("relu")
def relu(ctx):
    ctx.set_output("Out", torch.relu(ctx.input("X")))


@register_op("sigmoid")
def sigmoid(ctx):
    ctx.set_output("Out", torch.sigmoid(ctx.input("X")))


@register_op("tanh")
def tanh(ctx):
    ctx.set_output("Out", torch.tanh(ctx.input("X")))


@register_op("square")
def square(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x * x)


@register_op("log")
def log(ctx):
    ctx.set_output("Out", torch.log(ctx.input("X")))
