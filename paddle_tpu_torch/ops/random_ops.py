"""Random ops (counterpart of paddle_tpu/ops/random_ops.py:
uniform_random and gaussian_random). Each op draws from its own
torch.Generator on the op's device, seeded from the `seed` attr or the
program seed, the op uid and the run index (ExecContext.generator; in
a block the engine captures, a generator registered with the graph and
re-seeded for each run's index, so a replay draws what the eager run
with that index draws).
torch cannot reproduce jax.random's bits: the same seed gives the same
numbers within the port only."""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op
from ..core.types import dtype_to_torch


def _shape(ctx):
    return [int(s) for s in ctx.attr("shape", [])]


@register_no_grad_op("uniform_random")
def uniform_random(ctx):
    """Uniform on [min, max), drawn in float32 and cast to `dtype`."""
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.rand(_shape(ctx), generator=ctx.generator(),
                     dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (lo + (hi - lo) * out).to(
        dtype_to_torch(ctx.attr("dtype", "float32"))))


@register_no_grad_op("gaussian_random")
def gaussian_random(ctx):
    dt = dtype_to_torch(ctx.attr("dtype", "float32"))
    mean = ctx.attr("mean", 0.0)
    std = ctx.attr("std", 1.0)
    out = torch.randn(_shape(ctx), generator=ctx.generator(),
                      dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (mean + std * out).to(dt))
