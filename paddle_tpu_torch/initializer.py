"""Parameter initializers: each appends one init op to the startup
program (counterpart of paddle_tpu/initializer.py: Constant, Uniform,
Normal, TruncatedNormal, Xavier, MSRA, NumpyArrayInitializer and
Bilinear). A weight with no initializer gets Xavier, a
bias Constant(0), as in the JAX package (layer_helper.py)."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Initializer", "Constant", "Uniform", "Normal",
           "TruncatedNormal", "Xavier", "MSRA", "Bilinear",
           "NumpyArrayInitializer", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "BilinearInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return int(shape[0]) if shape else 1, \
                int(shape[0]) if shape else 1
        fan_in = int(np.prod(shape[1:]))
        fan_out = int(shape[0]) if len(shape) == 2 else \
            int(shape[0] * np.prod(shape[2:]))
        if len(shape) == 2:
            fan_in, fan_out = int(shape[0]), int(shape[1])
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    """`force_cpu` is taken as the JAX package takes it: the fill goes
    where every other op of the program runs."""

    def __init__(self, value=0.0, force_cpu=False):
        self.value = float(value)

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "value": self.value,
                   "dtype": int(var.dtype)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "min": self.low,
                   "max": self.high, "seed": self.seed,
                   "dtype": int(var.dtype)})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "seed": self.seed,
                   "dtype": int(var.dtype)})


class TruncatedNormalInitializer(Initializer):
    """Normal(loc, scale) truncated to two standard deviations (the
    truncated_gaussian_random op)."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "seed": self.seed,
                   "dtype": int(var.dtype)})


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """The values of a numpy array (an assign_value op: int32 and int64
    arrays as integers, any other as float32)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        flat = self.value.reshape(-1)
        if self.value.dtype in (np.int32, np.int64):
            attr = {"int64_values" if self.value.dtype == np.int64 else
                    "int32_values": [int(x) for x in flat]}
        else:
            attr = {"fp32_values": [float(x) for x in flat]}
        attrs = {"shape": list(self.value.shape), "dtype": int(var.dtype)}
        attrs.update(attr)
        block.append_op("assign_value", outputs={"Out": var}, attrs=attrs)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel of a [C_out, C_in, H, W]
    transposed-convolution weight."""

    def __call__(self, var, block):
        shape = var.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype=np.float32)
        for k in range(int(np.prod(shape))):
            idx = np.unravel_index(k, shape)
            x, y = idx[3], idx[2]
            w[idx] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        NumpyArrayInitializer(w)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
