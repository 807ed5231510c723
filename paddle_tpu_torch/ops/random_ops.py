"""Random ops (counterpart of paddle_tpu/ops/random_ops.py:
gaussian_random). Each op draws from its own torch.Generator on the op's
device, seeded from the `seed` attr or the program seed, the op uid and
the run index (ExecContext.generator). torch cannot reproduce
jax.random's bits: the same seed gives the same numbers within the port
only."""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op
from ..core.types import dtype_to_torch


@register_no_grad_op("gaussian_random")
def gaussian_random(ctx):
    shape = [int(s) for s in ctx.attr("shape", [])]
    dt = dtype_to_torch(ctx.attr("dtype", "float32"))
    mean = ctx.attr("mean", 0.0)
    std = ctx.attr("std", 1.0)
    out = torch.randn(shape, generator=ctx.generator(), dtype=torch.float32,
                      device=ctx.device)
    ctx.set_output("Out", (mean + std * out).to(dt))
