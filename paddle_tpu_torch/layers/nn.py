"""NN layers (counterpart of paddle_tpu/layers/nn.py). The builders that
Transformer training and inference call: fc, embedding, layer_norm,
fused_attention, dropout, reshape, squeeze, unsqueeze, reduce_sum,
add_position_encoding, elementwise_*; matmul; those of LeNet:
conv2d, pool2d, softmax, mean, top_k/topk; those of ResNet:
batch_norm, relu; those of the CTR models: flatten, concat,
sigmoid, elementwise_sub; the recurrent layers of the sequence
models: dynamic_lstm, dynamic_gru; the activations tanh, square and
log; those of the beam-search decoder: stack, gather, beam_search
and beam_search_decode; and those of the basic, reduce, elementwise and
activation op families, with autoincreased_step_counter."""
from __future__ import annotations

import copy

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..initializer import Constant, Normal

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "layer_norm", "fused_attention",
    "dropout", "softmax", "mean", "top_k", "topk", "matmul", "reshape",
    "squeeze", "unsqueeze", "reduce_sum", "add_position_encoding",
    "elementwise_add", "elementwise_mul", "elementwise_div", "batch_norm",
    "relu", "flatten", "concat", "sigmoid", "elementwise_sub",
    "dynamic_lstm", "dynamic_gru", "tanh", "square", "log", "stack",
    "gather", "beam_search", "beam_search_decode",
    # the basic, reduce, elementwise and activation families
    "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "reduce_all",
    "reduce_any", "elementwise_max", "elementwise_min", "elementwise_pow",
    "elementwise_mod", "elementwise_floordiv", "exp", "sqrt", "rsqrt",
    "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal",
    "softplus", "softsign", "logsigmoid", "gelu", "tanh_shrink", "relu6",
    "leaky_relu", "elu", "swish", "prelu", "brelu", "soft_relu", "maxout",
    "hard_sigmoid", "selu", "pow", "hard_shrink", "softshrink",
    "thresholded_relu", "stanh", "one_hot", "transpose", "split",
    "unstack", "expand", "slice", "pad", "pad2d", "crop", "gather_nd",
    "scatter", "argsort", "argmax", "argmin", "cumsum", "clip",
    "clip_by_norm", "label_smooth", "multiplex", "shape", "size", "where",
    "hash", "shard_index", "autoincreased_step_counter",
]


def _single_op(op_type, x, attrs, dtype=None, in_slot="X"):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(op_type, inputs={in_slot: x}, outputs={"Out": out},
                     attrs=attrs)
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """One `mul` a input (each with its own weight; `param_attr` one for
    all or a list, one a input), then `sum` when there are several, the
    bias and the activation."""
    helper = LayerHelper("fc", bias_attr=bias_attr, act=act, name=name)
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    # copies: a generated name must not stick to the caller's attr, nor
    # one input's weight name to the next's
    pattrs = [copy.copy(ParamAttr._to_attr(a)) for a in param_attr] \
        if isinstance(param_attr, (list, tuple)) else \
        [copy.copy(ParamAttr._to_attr(param_attr)) for _ in inputs]
    muls = []
    for x, pattr in zip(inputs, pattrs):
        in_dim = int(np.prod(x.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, [in_dim, size], x.dtype)
        tmp = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            "mul", inputs={"X": x, "Y": w}, outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        muls.append(tmp)
    pre_bias = muls[0]
    if len(muls) > 1:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", inputs={"X": muls},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, data_format="NCHW", name=None):
    """The filter's default initializer is Normal(0, sqrt(2 / fan_in)); a
    conv whose groups equal its input and output channels (> 1) is a
    depthwise_conv2d op, as in the JAX package."""
    helper = LayerHelper("conv2d", bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(
            f"data_format must be NCHW or NHWC, got {data_format!r}")
    channel_last = data_format == "NHWC"
    num_channels = input.shape[-1] if channel_last else input.shape[1]
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * int(np.prod(filter_size))
    w = helper.create_parameter(
        param_attr, filter_shape, input.dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(input.dtype)
    op_type = "depthwise_conv2d" if (groups == num_channels and
                                     num_filters == num_channels and
                                     groups > 1) else "conv2d"
    helper.append_op(
        op_type, inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "data_format": data_format})
    pre_act = helper.append_bias_op(
        out, dim_start=3 if channel_last else 1,
        dim_end=None if channel_last else 2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, data_format="NCHW",
           name=None):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return _single_op("softmax", input, {"axis": axis})


def mean(x, name=None):
    return _single_op("mean", x, {})


def top_k(input, k=1, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def topk(input, k, name=None):
    return top_k(input, k, name=name)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
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
    return helper.append_activation(out)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale and Bias are trained parameters; the running Mean and
    Variance are persistables that are not trained (initialized to 0
    and 1), which the op updates in place through MeanOut and
    VarianceOut."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype
    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [ch], dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [ch], dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False,
                  initializer=Constant(0.0)), [ch], dtype)
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False,
                  initializer=Constant(1.0)), [ch], dtype)
    saved_mean = helper.create_variable_for_type_inference(dtype, True)
    saved_var = helper.create_variable_for_type_inference(dtype, True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias, "Mean": mean,
                "Variance": variance},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def _make_act(op_type):
    def _act(x, name=None, **attrs):
        return _single_op(op_type, x, attrs)
    _act.__name__ = op_type
    return _act


relu = _make_act("relu")
sigmoid = _make_act("sigmoid")
tanh = _make_act("tanh")
square = _make_act("square")
log = _make_act("log")
exp = _make_act("exp")
sqrt = _make_act("sqrt")
rsqrt = _make_act("rsqrt")
abs = _make_act("abs")
ceil = _make_act("ceil")
floor = _make_act("floor")
cos = _make_act("cos")
sin = _make_act("sin")
round = _make_act("round")
reciprocal = _make_act("reciprocal")
softplus = _make_act("softplus")
softsign = _make_act("softsign")
logsigmoid = _make_act("logsigmoid")
gelu = _make_act("gelu")
tanh_shrink = _make_act("tanh_shrink")


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("flatten2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": x}, outputs={"Y": out},
                     attrs={"axis": axis})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": input},
                     outputs={"Out": out}, attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    """reshape2 to `shape`, then `act`. `actual_shape` and `inplace`
    are taken as the JAX package takes them: the op's shape is `shape`,
    and the output is a new var."""
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("squeeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": axes})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("unsqueeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": axes})
    return out


def _reduce(op_type, input, dim, keep_dim):
    if dim is None:
        attrs = {"reduce_all": True, "dim": [0], "keep_dim": keep_dim}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"reduce_all": False, "dim": list(dims),
                 "keep_dim": keep_dim}
    return _single_op(op_type, input, attrs)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim)


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


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """The LoD LSTM (op `lstm`): `input` is the [T, 4 * hidden] LoD
    projection and size = 4 * hidden; the bias holds the peephole
    weights after the gate biases ([1, 7 * hidden]) with use_peepholes.
    Returns (hidden, cell), [T, hidden] each."""
    helper = LayerHelper("lstm", name=name)
    hidden = size // 4
    weight = helper.create_parameter(param_attr, [hidden, 4 * hidden],
                                     dtype)
    bias_size = [1, 7 * hidden] if use_peepholes else [1, 4 * hidden]
    bias = helper.create_parameter(bias_attr, bias_size, dtype,
                                   is_bias=True)
    h = helper.create_variable_for_type_inference(dtype)
    c = helper.create_variable_for_type_inference(dtype)
    h.shape = c.shape = (-1, hidden)
    batch_gate = helper.create_variable_for_type_inference(dtype, True)
    batch_cell = helper.create_variable_for_type_inference(dtype, True)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    if c_0 is not None:
        inputs["C0"] = c_0
    helper.append_op(
        "lstm", inputs=inputs,
        outputs={"Hidden": h, "Cell": c, "BatchGate": batch_gate,
                 "BatchCellPreAct": batch_cell},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation},
        infer_shape=False)
    return h, c


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None,
                origin_mode=False, name=None):
    """The LoD GRU (op `gru`): `input` is the [T, 3 * size] LoD
    projection. Returns the hidden states, [T, size]."""
    helper = LayerHelper("gru", name=name)
    dtype = input.dtype
    weight = helper.create_parameter(param_attr, [size, 3 * size], dtype)
    bias = helper.create_parameter(bias_attr, [1, 3 * size], dtype,
                                   is_bias=True)
    h = helper.create_variable_for_type_inference(dtype)
    h.shape = (-1, size)
    bg = helper.create_variable_for_type_inference(dtype, True)
    brh = helper.create_variable_for_type_inference(dtype, True)
    bh = helper.create_variable_for_type_inference(dtype, True)
    inputs = {"Input": input, "Weight": weight, "Bias": bias}
    if h_0 is not None:
        inputs["H0"] = h_0
    helper.append_op(
        "gru", inputs=inputs,
        outputs={"Hidden": h, "BatchGate": bg,
                 "BatchResetHiddenPrev": brh, "BatchHidden": bh},
        attrs={"is_reverse": is_reverse, "origin_mode": origin_mode,
               "gate_activation": gate_activation,
               "activation": candidate_activation}, infer_shape=False)
    return h


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """The top `beam_size` of each source's beam x candidate scores
    (ops/beam_search.py: finished beams are frozen, not pruned)."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(pre_ids.dtype)
    sel_scores = helper.create_variable_for_type_inference(
        pre_scores.dtype)
    parent_idx = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "beam_search",
        inputs={"pre_ids": pre_ids, "pre_scores": pre_scores,
                "ids": ids, "scores": scores},
        outputs={"selected_ids": sel_ids,
                 "selected_scores": sel_scores,
                 "parent_idx": parent_idx},
        attrs={"beam_size": beam_size, "end_id": end_id,
               "level": level, "is_accumulated": is_accumulated},
        infer_shape=False)
    if return_parent_idx:
        return sel_ids, sel_scores, parent_idx
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, parent_idx, beam_size, end_id,
                       name=None):
    """Backtrack stacked beam selections ([T, B*K] tensors) into padded
    hypotheses [B*K, T], padded with end_id, and their scores."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_variable_for_type_inference(ids.dtype)
    sent_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        "beam_search_decode",
        inputs={"Ids": ids, "Scores": scores, "ParentIdx": parent_idx},
        outputs={"SentenceIds": sent_ids,
                 "SentenceScores": sent_scores},
        attrs={"beam_size": beam_size, "end_id": end_id},
        infer_shape=False)
    return sent_ids, sent_scores


# ---------------------------------------------------------------------------
# the builders of the basic, reduce, elementwise and activation
# op families (the reductions and elementwise ops are above)
# ---------------------------------------------------------------------------

def relu6(x, threshold=6.0, name=None):
    return _single_op("relu6", x, {"threshold": threshold})


def leaky_relu(x, alpha=0.02, name=None):
    return _single_op("leaky_relu", x, {"alpha": alpha})


def elu(x, alpha=1.0, name=None):
    return _single_op("elu", x, {"alpha": alpha})


def swish(x, beta=1.0, name=None):
    return _single_op("swish", x, {"beta": beta})


def prelu(x, mode="all", param_attr=None, name=None):
    """where(x > 0, x, alpha x) with a learned alpha (0.25 at first): one
    ("all"), one a channel ("channel") or one an element ("element")."""
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = [1] + list(x.shape[1:])
    alpha = helper.create_parameter(param_attr, alpha_shape, x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _single_op("brelu", x, {"t_min": t_min, "t_max": t_max})


def soft_relu(x, threshold=40.0, name=None):
    return _single_op("soft_relu", x, {"threshold": threshold})


def maxout(x, groups, name=None):
    return _single_op("maxout", x, {"groups": groups})


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _single_op("hard_sigmoid", x, {"slope": slope,
                                          "offset": offset})


def selu(x, scale=None, alpha=None, name=None):
    attrs = {}
    if scale is not None:
        attrs["scale"] = scale
    if alpha is not None:
        attrs["alpha"] = alpha
    return _single_op("selu", x, attrs)


def pow(x, factor=1.0, name=None):
    return _single_op("pow", x, {"factor": factor})


def hard_shrink(x, threshold=0.5):
    return _single_op("hard_shrink", x, {"threshold": threshold})


def softshrink(x, alpha=0.5):
    return _single_op("softshrink", x, {"lambda": alpha})


def thresholded_relu(x, threshold=1.0):
    return _single_op("thresholded_relu", x, {"threshold": threshold})


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159, name=None):
    return _single_op("stanh", x, {"scale_a": scale_a, "scale_b": scale_b})


def one_hot(input, depth, allow_out_of_range=False):
    return _single_op("one_hot", input, {"depth": depth}, dtype="float32")


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """`num_or_sections` equal parts (an int) or parts of those sizes
    along `dim`: a list of vars."""
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op("unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    return _single_op("expand", x, {"expand_times": list(expand_times)})


def slice(input, axes, starts, ends):
    return _single_op("slice", input, {"axes": list(axes),
                                       "starts": list(starts),
                                       "ends": list(ends)},
                      in_slot="Input")


def pad(x, paddings, pad_value=0.0, name=None):
    return _single_op("pad", x, {"paddings": list(paddings),
                                 "pad_value": float(pad_value)})


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _single_op("pad2d", input,
                      {"paddings": list(paddings), "mode": mode,
                       "pad_value": float(pad_value)})


def crop(x, shape=None, offsets=None, name=None):
    return _single_op("crop", x, {"shape": list(shape),
                                  "offsets": list(offsets or
                                                  [0] * len(shape))})


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather_nd", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter", inputs={"X": input, "Ids": index,
                                        "Updates": updates},
                     outputs={"Out": out}, attrs={"overwrite": overwrite})
    return out


def argsort(input, axis=-1, name=None):
    """(sorted values, int64 indices) along `axis`."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("argsort", inputs={"X": input},
                     outputs={"Out": out, "Indices": ids},
                     attrs={"axis": axis})
    return out, ids


def argmax(x, axis=0):
    return _single_op("arg_max", x, {"axis": axis}, dtype="int64")


def argmin(x, axis=0):
    return _single_op("arg_min", x, {"axis": axis}, dtype="int64")


def cumsum(x, axis=None, exclusive=None, reverse=None):
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    return _single_op("cumsum", x, attrs)


def clip(x, min, max, name=None):
    return _single_op("clip", x, {"min": float(min), "max": float(max)})


def clip_by_norm(x, max_norm, name=None):
    return _single_op("clip_by_norm", x, {"max_norm": float(max_norm)})


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": out},
                     attrs={"epsilon": epsilon})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op("multiplex", inputs={"X": inputs, "Ids": index},
                     outputs={"Out": out})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("shape", inputs={"Input": input}, outputs={"Out": out})
    return out


def size(input):
    helper = LayerHelper("size")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("size", inputs={"Input": input}, outputs={"Out": out})
    return out


def where(condition):
    """int64 [N, rank]: the coordinates of the true elements (read on the
    host: a block holding it runs eagerly)."""
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("where", inputs={"Condition": condition},
                     outputs={"Out": out})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    return _single_op("hash", input, {"mod_by": hash_size,
                                      "num_hash": num_hash})


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    helper = LayerHelper("shard_index")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("shard_index", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"index_num": index_num, "nshards": nshards,
                            "shard_id": shard_id,
                            "ignore_value": ignore_value})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter (@STEP_COUNTER@ unless named),
    filled with begin - step by the startup program and advanced by
    `step` by an increment op every run of the main program, so the
    first run reads `begin`. A captured run replays the increment on the
    card: the counter advances at every replay."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    counter = helper.main_program.global_block()._find_var_recursive(name)
    if counter is None:
        counter = helper.main_program.global_block().create_var(
            name=name, dtype="int64", shape=[1], persistable=True)
        helper.startup_program.global_block().create_var(
            name=name, dtype="int64", shape=[1], persistable=True)
        helper.startup_program.global_block().append_op(
            "fill_constant", outputs={"Out": [name]},
            attrs={"shape": [1], "dtype": counter.dtype,
                   "value": float(begin - step)})
    helper.append_op("increment", inputs={"X": [name]},
                     outputs={"Out": [name]}, attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter
