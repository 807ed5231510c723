"""Parameter initializers: each appends one init op to the startup
program (counterpart of paddle_tpu/initializer.py; Constant and Normal so
far)."""
from __future__ import annotations

__all__ = ["Initializer", "Constant", "Normal", "ConstantInitializer",
           "NormalInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "value": self.value,
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


Constant = ConstantInitializer
Normal = NormalInitializer
