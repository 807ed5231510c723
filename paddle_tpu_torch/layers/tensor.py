"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py: scale,
create_global_var)."""
from __future__ import annotations

from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["scale", "create_global_var"]


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A var of the main program's global block, filled with `value` by
    a fill_constant op in the startup program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable,
        name=name or helper.name)
    sb = helper.startup_program.global_block()
    sv = sb.create_var(name=var.name, shape=shape, dtype=dtype,
                       persistable=persistable)
    Constant(value)(sv, sb)
    return var
