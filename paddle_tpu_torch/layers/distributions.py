"""Probability distributions (counterpart of
paddle_tpu/layers/distributions.py): Uniform, Normal, Categorical and
MultivariateNormalDiag, graph-mode objects whose sample, log_prob,
entropy and kl_divergence build ops into the current program (the
samples through uniform_random, gaussian_random and sampling_id)."""
from __future__ import annotations

import math

import numpy as np

from . import nn as _nn
from . import tensor as _tensor
from .ops import uniform_random as _uniform_random
from .. import framework

__all__ = ["Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag"]


def _to_var(value, like=None):
    if isinstance(value, framework.Variable):
        return value
    arr = np.asarray(value, np.float32)
    return _tensor.assign(arr)


class Distribution:
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (reference distributions.py:113)."""

    def __init__(self, low, high):
        self.low = _to_var(low)
        self.high = _to_var(high)

    def sample(self, shape, seed=0):
        u = _uniform_random(list(shape), min=0.0, max=1.0, seed=seed)
        return _nn.elementwise_add(
            self.low,
            _nn.elementwise_mul(
                u, _nn.elementwise_sub(self.high, self.low)))

    def log_prob(self, value):
        lb = _tensor.cast(_greater(value, self.low), "float32")
        ub = _tensor.cast(_less(value, self.high), "float32")
        rng = _nn.elementwise_sub(self.high, self.low)
        inside = _nn.elementwise_mul(lb, ub)
        return _nn.elementwise_sub(
            _nn.log(_tensor.scale(inside, bias=1e-30)),
            _nn.log(rng))

    def entropy(self):
        return _nn.log(_nn.elementwise_sub(self.high, self.low))


class Normal(Distribution):
    """N(loc, scale) (reference distributions.py:246)."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def sample(self, shape, seed=0):
        eps = _nn.gaussian_random(list(shape), mean=0.0, std=1.0,
                          seed=seed)
        return _nn.elementwise_add(
            self.loc, _nn.elementwise_mul(eps, self.scale))

    def entropy(self):
        c = 0.5 + 0.5 * math.log(2.0 * math.pi)
        return _nn.elementwise_add(
            _tensor.scale(_tensor.ones_like(self.scale), scale=c),
            _nn.log(self.scale))

    def log_prob(self, value):
        var = _nn.elementwise_mul(self.scale, self.scale)
        diff = _nn.elementwise_sub(value, self.loc)
        return _nn.elementwise_sub(
            _tensor.scale(
                _nn.elementwise_div(_nn.elementwise_mul(diff, diff),
                                    var), scale=-0.5),
            _nn.elementwise_add(
                _nn.log(self.scale),
                _tensor.scale(_tensor.ones_like(self.scale),
                              scale=0.5 * math.log(2.0 * math.pi))))

    def kl_divergence(self, other):
        """KL(self || other) for two Normals (reference :282)."""
        var_ratio = _nn.elementwise_div(self.scale, other.scale)
        var_ratio = _nn.elementwise_mul(var_ratio, var_ratio)
        t1 = _nn.elementwise_div(
            _nn.elementwise_sub(self.loc, other.loc), other.scale)
        t1 = _nn.elementwise_mul(t1, t1)
        return _tensor.scale(
            _nn.elementwise_sub(
                _nn.elementwise_add(var_ratio, t1),
                _nn.elementwise_add(_nn.log(var_ratio),
                                    _tensor.ones_like(var_ratio))),
            scale=0.5)


class Categorical(Distribution):
    """Categorical over unnormalized logits."""

    def __init__(self, logits):
        self.logits = logits

    def _probs(self):
        return _nn.softmax(self.logits)

    def sample(self, shape=None, seed=0):
        if shape:
            raise NotImplementedError(
                "Categorical.sample draws one id per logits row "
                "(sampling_id); arbitrary sample shapes are not "
                "supported")
        return _nn.sampling_id(self._probs(), seed=seed)

    def entropy(self):
        p = self._probs()
        logp = _nn.log(_tensor.scale(p, bias=1e-12))
        return _tensor.scale(
            _nn.reduce_sum(_nn.elementwise_mul(p, logp), dim=-1),
            scale=-1.0)

    def log_prob(self, value):
        logp = _nn.log(_tensor.scale(self._probs(), bias=1e-12))
        idx = _tensor.cast(value, "int64")
        if len(idx.shape) == len(logp.shape) - 1:
            idx = _nn.unsqueeze(idx, axes=[-1])
        # per-row pick via one_hot (shape-stable)
        oh = _nn.one_hot(idx, depth=int(logp.shape[-1]))
        oh = _nn.reshape(oh, list(logp.shape[:-1]) +
                         [int(logp.shape[-1])]) \
            if len(oh.shape) != len(logp.shape) else oh
        return _nn.reduce_sum(_nn.elementwise_mul(logp, oh), dim=-1)

    def kl_divergence(self, other):
        p = self._probs()
        logp = _nn.log(_tensor.scale(p, bias=1e-12))
        logq = _nn.log(_tensor.scale(other._probs(), bias=1e-12))
        return _nn.reduce_sum(
            _nn.elementwise_mul(p, _nn.elementwise_sub(logp, logq)),
            dim=-1)


class MultivariateNormalDiag(Distribution):
    """N(loc, diag(scale)) with diagonal covariance."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)   # diagonal entries [..., D]

    def sample(self, shape=None, seed=0):
        shp = list(shape) if shape else [int(s) for s in
                                         self.loc.shape]
        eps = _nn.gaussian_random(shp, mean=0.0, std=1.0, seed=seed)
        return _nn.elementwise_add(
            self.loc, _nn.elementwise_mul(eps, self.scale))

    def entropy(self):
        d = int(self.scale.shape[-1])
        c = 0.5 * d * (1.0 + math.log(2.0 * math.pi))
        logdet = _nn.reduce_sum(_nn.log(self.scale), dim=-1)
        return _tensor.scale(logdet, bias=c)

    def log_prob(self, value):
        diff = _nn.elementwise_div(
            _nn.elementwise_sub(value, self.loc), self.scale)
        quad = _nn.reduce_sum(_nn.elementwise_mul(diff, diff), dim=-1)
        d = int(self.scale.shape[-1])
        logdet = _nn.reduce_sum(_nn.log(self.scale), dim=-1)
        return _tensor.scale(
            _nn.elementwise_add(
                _tensor.scale(quad, bias=d * math.log(2.0 * math.pi)),
                _tensor.scale(logdet, scale=2.0)),
            scale=-0.5)

    def kl_divergence(self, other):
        var_ratio = _nn.elementwise_div(self.scale, other.scale)
        var_ratio = _nn.elementwise_mul(var_ratio, var_ratio)
        t1 = _nn.elementwise_div(
            _nn.elementwise_sub(self.loc, other.loc), other.scale)
        t1 = _nn.elementwise_mul(t1, t1)
        inner = _nn.elementwise_sub(
            _nn.elementwise_add(var_ratio, t1),
            _nn.elementwise_add(_nn.log(var_ratio),
                                _tensor.ones_like(var_ratio)))
        return _tensor.scale(_nn.reduce_sum(inner, dim=-1), scale=0.5)


def _greater(a, b):
    from . import math_ops as _m
    return _m.greater_than(a, b)


def _less(a, b):
    from . import math_ops as _m
    return _m.less_than(a, b)
