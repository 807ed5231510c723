"""Random ops (counterpart of paddle_tpu/ops/random_ops.py): uniform_random,
gaussian_random and their batch_size_like forms, truncated_gaussian_random,
randint, sampling_id and random_crop. Each op draws from its own
torch.Generator on the op's device, seeded from the `seed` attr or the
program seed, the op uid and the run index (ExecContext.generator; in
a block the engine captures, a generator registered with the graph and
re-seeded for each run's index, so a replay draws what the eager run
with that index draws). No op reads a drawn value on the host: starts,
ids and crops stay on the device.
torch cannot reproduce jax.random's bits: the same seed gives the same
numbers within the port only; against the JAX package the draws agree
in shape, dtype, bounds and distribution.

A `ShapeTensor` input sets the shape of uniform_random,
gaussian_random, truncated_gaussian_random and randint as in the JAX
package. Its values are read on the host, so a block holding such an op
stays eager (the engine's capture rule fails on the meta device; its
reason is the op type)."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_no_grad_op
from ..core.types import dtype_to_torch


def _shape(ctx):
    if ctx.has_input("ShapeTensor"):
        t = ctx.input("ShapeTensor")
        if t.device.type == "meta":
            raise NotImplementedError(
                f"{ctx.op.type}: a ShapeTensor input is read on the host; "
                f"the op runs eagerly only")
        return [int(s) for s in t.reshape(-1).tolist()]
    return [int(s) for s in ctx.attr("shape", [])]


def _like_shape(ctx):
    """The `shape` attr with dim output_dim_idx taken from the Input's
    dim input_dim_idx."""
    shape = [int(s) for s in ctx.attr("shape", [])]
    shape[ctx.attr("output_dim_idx", 0)] = \
        ctx.input("Input").shape[ctx.attr("input_dim_idx", 0)]
    return shape


def _uniform(ctx, shape):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.rand(shape, generator=ctx.generator(),
                     dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (lo + (hi - lo) * out).to(
        dtype_to_torch(ctx.attr("dtype", "float32"))))


def _gaussian(ctx, shape):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    out = torch.randn(shape, generator=ctx.generator(),
                      dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (mean + std * out).to(
        dtype_to_torch(ctx.attr("dtype", "float32"))))


@register_no_grad_op("uniform_random")
def uniform_random(ctx):
    """Uniform on [min, max), drawn in float32 and cast to `dtype`."""
    _uniform(ctx, _shape(ctx))


@register_no_grad_op("uniform_random_batch_size_like")
def uniform_random_batch_size_like(ctx):
    _uniform(ctx, _like_shape(ctx))


@register_no_grad_op("gaussian_random")
def gaussian_random(ctx):
    _gaussian(ctx, _shape(ctx))


@register_no_grad_op("gaussian_random_batch_size_like")
def gaussian_random_batch_size_like(ctx):
    _gaussian(ctx, _like_shape(ctx))


# jax.random.truncated_normal's interval: erf(bound / sqrt 2) on each side
_TRUNC = 2.0
_ERF_LO, _ERF_HI = math.erf(-_TRUNC / math.sqrt(2)), \
    math.erf(_TRUNC / math.sqrt(2))


@register_no_grad_op("truncated_gaussian_random")
def truncated_gaussian_random(ctx):
    """mean + std * z, z standard normal truncated to [-2, 2] by the
    inverse CDF, as jax.random.truncated_normal draws it: a uniform draw
    on [erf(-sqrt 2), erf(sqrt 2)], sqrt 2 * erfinv of it, clamped to
    the interval. No rejection loop: the draw takes one pass."""
    u = torch.rand(_shape(ctx), generator=ctx.generator(),
                   dtype=torch.float32, device=ctx.device)
    z = math.sqrt(2.0) * torch.erfinv(_ERF_LO + (_ERF_HI - _ERF_LO) * u)
    z = z.clamp(math.nextafter(-_TRUNC, 0.0), math.nextafter(_TRUNC, 0.0))
    out = ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * z
    ctx.set_output("Out", out.to(dtype_to_torch(ctx.attr("dtype", 9))))


@register_no_grad_op("randint")
def randint(ctx):
    """Integers uniform on [low, high), in `dtype` (int32 by default)."""
    out = torch.randint(ctx.attr("low", 0), ctx.attr("high", 100),
                        _shape(ctx), generator=ctx.generator(),
                        dtype=torch.int64, device=ctx.device)
    ctx.set_output("Out", out.to(dtype_to_torch(ctx.attr("dtype", 5))))


@register_no_grad_op("sampling_id")
def sampling_id(ctx):
    """One id a row of X [batch, classes] (probabilities), drawn as
    jax.random.categorical(log(x + 1e-20)) draws it: the argmax of the
    log-probabilities plus Gumbel noise from the op's uniforms. int64
    [batch]."""
    x = ctx.input("X")
    u = torch.rand(x.shape, generator=ctx.generator(), dtype=torch.float32,
                   device=ctx.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    ids = torch.argmax(torch.log(x.float() + 1e-20) + gumbel, dim=-1)
    ctx.set_output("Out", ids.to(torch.int64))


@register_no_grad_op("random_crop")
def random_crop(ctx):
    """A window of the `shape` attr over X's last len(shape) dims, one
    start a cropped dim drawn uniformly from [0, dim - size], the leading
    dims kept. The starts stay on the device: each cropped dim is
    gathered by start + arange(size). SeedOut is int64 zeros [1], as in
    the JAX package."""
    x = ctx.input("X")
    shape = [int(s) for s in ctx.attr("shape")]
    lead = x.ndim - len(shape)
    u = torch.rand(len(shape), generator=ctx.generator(),
                   dtype=torch.float32, device=ctx.device)
    out = x
    for i, s in enumerate(shape):
        limit = max(x.shape[lead + i] - s, 0) + 1
        start = torch.floor(u[i] * limit).to(torch.int64).clamp_max(
            limit - 1)
        idx = start + torch.arange(s, device=ctx.device)
        out = out.index_select(lead + i, idx)
    ctx.set_output("Out", out)
    ctx.set_output("SeedOut", torch.zeros(1, dtype=torch.int64,
                                          device=ctx.device))
