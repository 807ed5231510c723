"""Tensor layers (counterpart of paddle_tpu/layers/tensor.py: scale,
create_global_var, create_tensor, create_parameter, concat, fill_constant,
fill_constant_batch_size_like, zeros, ones, zeros_like, ones_like,
assign, increment, cast, sums, reverse, isfinite, has_inf, has_nan,
range, linspace, diag, eye). has_nan is has_inf, as in the JAX package:
both give isfinite's flag."""
from __future__ import annotations

import numpy as np

from ..core.types import convert_dtype
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["scale", "create_global_var", "fill_constant",
           "fill_constant_batch_size_like", "zeros", "ones", "assign",
           "increment", "create_tensor", "create_parameter", "cast",
           "concat", "sums", "ones_like", "zeros_like", "reverse", "has_inf",
           "has_nan", "isfinite", "range", "linspace", "diag", "eye"]


def concat(input, axis=0, name=None):
    """nn.concat, which the JAX module exports from here too."""
    from .nn import concat as _concat
    return _concat(input, axis, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


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


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "fill_constant", outputs={"Out": out},
        attrs={"shape": [int(s) for s in shape], "value": float(value),
               "dtype": int(convert_dtype(dtype))})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "fill_constant_batch_size_like", inputs={"Input": input},
        outputs={"Out": out},
        attrs={"shape": [int(s) for s in shape], "value": float(value),
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx,
               "dtype": int(convert_dtype(dtype))})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def assign(input, output=None):
    """A copy of a Variable (assign), or of a numpy array (assign_value,
    its values in the op's attrs)."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": input},
                         outputs={"Out": output})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype))
    attrs = {"shape": list(arr.shape),
             "dtype": int(convert_dtype(arr.dtype))}
    if arr.dtype == np.int32:
        attrs["int32_values"] = [int(v) for v in arr.reshape(-1)]
    elif arr.dtype == np.int64:
        attrs["int64_values"] = [int(v) for v in arr.reshape(-1)]
    else:
        attrs["fp32_values"] = [float(v) for v in arr.reshape(-1)]
    helper.append_op("assign_value", outputs={"Out": output}, attrs=attrs)
    return output


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
    return out


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"in_dtype": int(x.dtype),
                            "out_dtype": int(dtype)})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": input}, outputs={"Out": out})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_any_like", inputs={"X": x},
                     outputs={"Out": out}, attrs={"value": 1.0})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": x},
                     outputs={"Out": out})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reverse", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": [axis] if isinstance(axis, int)
                            else list(axis)})
    return out


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool", True)
    helper.append_op("isfinite", inputs={"X": x}, outputs={"Out": out})
    return out


def has_inf(x):
    return isfinite(x)


has_nan = has_inf


def _scalar(v, dtype):
    return v if isinstance(v, Variable) else fill_constant([1], dtype, v)


def range(start, end, step, dtype):
    """arange(start, end, step): numbers become fill_constant vars; the
    op reads them on the host."""
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("range", inputs={"Start": _scalar(start, dtype),
                                      "End": _scalar(end, dtype),
                                      "Step": _scalar(step, dtype)},
                     outputs={"Out": out})
    return out


def linspace(start, stop, num, dtype):
    helper = LayerHelper("linspace")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("linspace", inputs={"Start": _scalar(start, dtype),
                                         "Stop": _scalar(stop, dtype),
                                         "Num": _scalar(num, "int32")},
                     outputs={"Out": out})
    return out


def diag(diagonal):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op("diag", inputs={"Diagonal": diagonal},
                     outputs={"Out": out})
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("eye", outputs={"Out": out},
                     attrs={"num_rows": num_rows,
                            "num_columns": num_columns or num_rows,
                            "dtype": int(convert_dtype(dtype))})
    return out
