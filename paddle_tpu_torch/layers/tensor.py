"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py: scale)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["scale"]


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return out
