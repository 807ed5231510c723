"""NN layers (counterpart of paddle_tpu/layers/nn.py). The builders that
Transformer training and inference call: fc, embedding, layer_norm,
fused_attention, dropout, reshape, squeeze, reduce_sum,
add_position_encoding, elementwise_*."""
from __future__ import annotations

import copy

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..initializer import Constant

__all__ = [
    "fc", "embedding", "layer_norm", "fused_attention", "dropout",
    "reshape",
    "squeeze", "reduce_sum", "add_position_encoding", "elementwise_add",
    "elementwise_mul", "elementwise_div",
]


def _single_op(op_type, x, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out},
                     attrs=attrs)
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """One input only: multi-input fc (op `sum`) is not ported yet."""
    helper = LayerHelper("fc", bias_attr=bias_attr, act=act, name=name)
    x = input
    # a copy: the generated name must not stick to the caller's attr
    pattr = copy.copy(ParamAttr._to_attr(param_attr))
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = helper.create_parameter(pattr, [in_dim, size], x.dtype)
    tmp = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "mul", inputs={"X": x, "Y": w}, outputs={"Out": tmp},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    pre_act = helper.append_bias_op(tmp, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lookup_table", inputs={"W": w, "Ids": input},
        outputs={"Out": out},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else
               (padding_idx if padding_idx >= 0 else size[0] + padding_idx),
               "remote_prefetch": False})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("layer_norm", name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": input}
    if scale:
        inputs["Scale"] = helper.create_parameter(
            param_attr, norm_shape, dtype,
            default_initializer=Constant(1.0))
    if shift:
        inputs["Bias"] = helper.create_parameter(bias_attr, norm_shape,
                                                 dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, True)
    var = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(
        "layer_norm", inputs=inputs,
        outputs={"Y": out, "Mean": mean, "Variance": var},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return out


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": [int(s) for s in shape]})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("squeeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": axes})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    if dim is None:
        attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"reduce_all": False, "dim": list(dims),
                 "keep_dim": keep_dim}
    return _single_op("reduce_sum", input, attrs)


def fused_attention(q, k, v, bias=None, scale=None, block_q=None,
                    block_k=None, layout="bhsd", dropout_prob=0.0,
                    is_test=False, causal=False, name=None):
    """Fused multi-head attention through the flash-attention kernel
    (paddle_tpu_torch/kernels/flash_attention.py). q/k/v: [B, H, S, D]
    (layout="bhsd") or [B, S, H, D] ("bshd"); bias: [B, 1|H, Sq|1, Sk]
    additive mask or None. causal=True masks cols > rows inside the op.
    block_q/block_k are kept as attrs for Program parity with the JAX
    package; the CUDA kernel picks its own tiles."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": q, "K": k, "V": v}
    if bias is not None:
        inputs["BiasQK"] = bias
    helper.append_op("fused_attention", inputs=inputs,
                     outputs={"Out": out},
                     attrs={"scale": -1.0 if scale is None else
                            float(scale),
                            "block_q": int(block_q or 0),
                            "block_k": int(block_k or 0),
                            "layout": layout,
                            "dropout_prob": float(dropout_prob),
                            "is_test": bool(is_test),
                            "causal": bool(causal)})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Out = x with a random dropout_prob of its elements zeroed (and,
    with "upscale_in_train", the rest scaled up); Mask (uint8) marks the
    kept ones. The op's seed attr fixes the draw when nonzero."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op(
        "dropout", inputs={"X": x}, outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def add_position_encoding(input, alpha, beta, name=None):
    return _single_op("add_position_encoding", input,
                      {"alpha": float(alpha), "beta": float(beta)})


def _elementwise(op_type, x, y, axis=-1, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def elementwise_add(x, y, axis=-1, name=None):
    return _elementwise("elementwise_add", x, y, axis, name)


def elementwise_mul(x, y, axis=-1, name=None):
    return _elementwise("elementwise_mul", x, y, axis, name)


def elementwise_div(x, y, axis=-1, name=None):
    return _elementwise("elementwise_div", x, y, axis, name)
