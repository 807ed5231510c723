"""Comparison and logical layers, cos_sim, and the operator sugar of a
graph-mode Variable (counterpart of paddle_tpu/layers/math_ops.py)."""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
    "cos_sim",
]


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": cond})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def _logical(op_type, x, y=None, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference("bool", True)
    inputs = {"X": x}
    if y is not None:
        inputs["Y"] = y
    helper.append_op(op_type, inputs=inputs, outputs={"Out": out})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out)


def elementwise_binary_sugar(x, other, op_type, reverse=False):
    """Variable.__add__ and the others: a number becomes a [1]
    fill_constant of x's dtype."""
    from . import tensor as t
    if not isinstance(other, Variable):
        other = t.fill_constant([1], x.dtype, float(other))
    a, b = (other, x) if reverse else (x, other)
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(a.dtype)
    helper.append_op(op_type, inputs={"X": a, "Y": b},
                     outputs={"Out": out}, attrs={"axis": -1})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity (with the norms as side outputs)."""
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op("cos_sim", inputs={"X": X, "Y": Y},
                     outputs={"Out": out, "XNorm": xn, "YNorm": yn})
    return out
