"""uniform_random and the inverse trigonometric layers (counterpart of
paddle_tpu/layers/ops.py)."""
from __future__ import annotations

from ..core.types import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["uniform_random", "acos", "asin", "atan"]


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random", outputs={"Out": out},
                     attrs={"shape": [int(s) for s in shape],
                            "min": float(min), "max": float(max),
                            "seed": seed,
                            "dtype": int(convert_dtype(dtype))})
    return out


def _make(op_type):
    def _f(x, name=None):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out})
        return out
    _f.__name__ = op_type
    return _f


acos = _make("acos")
asin = _make("asin")
atan = _make("atan")
