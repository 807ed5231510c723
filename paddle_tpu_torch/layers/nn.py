"""NN layers (counterpart of paddle_tpu/layers/nn.py). The builders that
Transformer training and inference call: fc, embedding, layer_norm,
fused_attention, dropout, reshape, squeeze, unsqueeze, reduce_sum,
add_position_encoding, elementwise_*; matmul; those of LeNet:
conv2d, pool2d, softmax, mean, top_k/topk; those of ResNet:
batch_norm, relu; those of the CTR models: flatten, concat,
sigmoid, elementwise_sub; the recurrent layers of the sequence
models: dynamic_lstm, dynamic_gru; the activations tanh, square and
log; those of the beam-search decoder: stack, gather, beam_search
and beam_search_decode; those of the basic, reduce, elementwise and
activation op families, with autoincreased_step_counter; and those of
the nn family (group_norm, instance_norm, data_norm, log_softmax,
l2_normalize, lrn), sign, dice_loss and npair_loss; mul, sum,
gaussian_random, lstm_unit, gru_unit, merge_selected_rows,
get_tensor_from_selected_rows and rank; the conv family's
(conv2d_transpose, conv3d, conv3d_transpose, pool3d, the adaptive pools,
the resizes, the layout ops, unfold, spp); the RoI poolings
roi_align, roi_pool and psroi_pool; bilinear_tensor_product,
chunk_eval and mean_iou; and the random layers
uniform_random_batch_size_like, gaussian_random_batch_size_like,
sampling_id and random_crop, with fsp_matrix; and those of misc's
user-path ops (lod_reset ... deformable_roi_pooling, lstm: slice
26)."""
from __future__ import annotations

import builtins
import copy

import numpy as np

from ..core.types import convert_dtype
from ..framework import Variable
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
    # the nn family and the composed losses
    "group_norm", "instance_norm", "data_norm", "log_softmax",
    "l2_normalize", "lrn", "sign", "dice_loss", "npair_loss",
    # builders over ops registered earlier
    "mul", "sum", "gaussian_random", "lstm_unit", "gru_unit",
    "merge_selected_rows", "get_tensor_from_selected_rows", "rank",
    # the conv family
    "conv2d_transpose", "conv3d", "conv3d_transpose", "pool3d",
    "adaptive_pool2d", "adaptive_pool3d", "image_resize",
    "resize_bilinear", "resize_nearest", "image_resize_short",
    "pixel_shuffle", "space_to_depth", "shuffle_channel",
    "affine_channel", "unfold", "temporal_shift", "spp",
    # the RoI poolings
    "roi_align", "roi_pool", "psroi_pool",
    # slice 24: the bilinear product and the metric builders
    "bilinear_tensor_product", "chunk_eval", "mean_iou",
    # slice 25: the random layers and the FSP matrix of distillation
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "sampling_id", "random_crop", "fsp_matrix",
    # slice 26: misc's user-path ops
    "lod_reset", "lod_append", "row_conv", "unique", "unique_with_counts",
    "spectral_norm", "tree_conv", "dynamic_lstmp", "lstm", "affine_grid",
    "grid_sampler", "center_loss", "continuous_value_model",
    "pad_constant_like", "similarity_focus",
    "teacher_student_sigmoid_loss", "unpool2d", "deformable_conv",
    "deformable_roi_pooling",
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


def _pair(v, n=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


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


# ---------------------------------------------------------------------------
# the nn op family's norms, log_softmax, l2_normalize, lrn and sign, and
# two composed losses
# ---------------------------------------------------------------------------

def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", act=act, name=name)
    dtype = input.dtype
    ch = input.shape[1]
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            param_attr, [ch], dtype, default_initializer=Constant(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(bias_attr, [ch], dtype,
                                                 is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype, True)
    var = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"epsilon": epsilon, "groups": groups})
    return helper.append_activation(out)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    ch = input.shape[1]
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            param_attr, [ch], input.dtype,
            default_initializer=Constant(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(bias_attr, [ch],
                                                 input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("instance_norm", inputs=inputs,
                     outputs={"Y": out}, attrs={"epsilon": epsilon})
    return out


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """BatchSize, BatchSum and BatchSquareSum are parameters (1e4, 0 and
    1e4 at the start), as in the JAX package."""
    helper = LayerHelper("data_norm", act=act, name=name)
    c = input.shape[-1]
    dtype = input.dtype
    batch_size = helper.create_parameter(
        ParamAttr(initializer=Constant(1e4)), [c], dtype)
    batch_sum = helper.create_parameter(
        ParamAttr(initializer=Constant(0.0)), [c], dtype)
    batch_square = helper.create_parameter(
        ParamAttr(initializer=Constant(1e4)), [c], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    means = helper.create_variable_for_type_inference(dtype, True)
    scales = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(
        "data_norm",
        inputs={"X": input, "BatchSize": batch_size,
                "BatchSum": batch_sum, "BatchSquareSum": batch_square},
        outputs={"Y": out, "Means": means, "Scales": scales},
        attrs={"epsilon": epsilon})
    return helper.append_activation(out)


def log_softmax(input, axis=-1, name=None):
    return _single_op("log_softmax", input, {"axis": axis})


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    return _single_op("l2_normalize", x, {"axis": axis,
                                          "epsilon": epsilon})


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("lrn", inputs={"X": input},
                     outputs={"Out": out, "MidOut": mid},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def sign(x):
    helper = LayerHelper("sign")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sign", inputs={"X": x}, outputs={"Out": out})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2*|input . onehot(label)| / (|input| + |onehot|), averaged:
    composed of the builders, as the JAX package composes it."""
    label = one_hot(label, depth=input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inse = reduce_sum(elementwise_mul(input, label), dim=reduce_dims)
    dice_denominator = reduce_sum(input, dim=reduce_dims) + \
        reduce_sum(label, dim=reduce_dims)
    dice_score = 1 - inse * 2 / (dice_denominator + epsilon)
    return mean(dice_score)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: soft-label cross entropy of anchor @ positive^T
    against the same-label targets, normalized a row, plus l2_reg/4
    times the embeddings' mean squared norms (composed as in the JAX
    package)."""
    from .loss import softmax_with_cross_entropy
    from .math_ops import equal
    from .tensor import cast, scale
    labels = cast(reshape(labels, [-1, 1]), "float32")
    same = cast(equal(labels, transpose(labels, perm=[1, 0])), "float32")
    targets = elementwise_div(same, reduce_sum(same, dim=1, keep_dim=True))
    similarity = matmul(anchor, positive, transpose_y=True)
    ce = reduce_mean(softmax_with_cross_entropy(similarity, targets,
                                                soft_label=True))
    reg = scale(elementwise_add(
        reduce_mean(reduce_sum(square(anchor), dim=1)),
        reduce_mean(reduce_sum(square(positive), dim=1))),
        scale=l2_reg * 0.25)
    return elementwise_add(ce, reg)


# ---------------------------------------------------------------------------
# builders over ops registered earlier
# ---------------------------------------------------------------------------

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
    return out


def sum(x):
    """The elementwise sum of a variable or a list of them (a `sum`
    op)."""
    helper = LayerHelper("sum")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", inputs={"X": list(xs)}, outputs={"Out": out})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gaussian_random", outputs={"Out": out},
        attrs={"shape": list(shape), "mean": mean, "std": std,
               "seed": seed, "dtype": int(convert_dtype(dtype))})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    """Uniform on [min, max) in `shape`, dim output_dim_idx taken from
    `input`'s dim input_dim_idx."""
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "uniform_random_batch_size_like", inputs={"Input": input},
        outputs={"Out": out},
        attrs={"shape": list(shape), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx, "min": min, "max": max,
               "seed": seed, "dtype": int(convert_dtype(dtype))})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gaussian_random_batch_size_like", inputs={"Input": input},
        outputs={"Out": out},
        attrs={"shape": list(shape), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx, "mean": mean, "std": std,
               "seed": seed, "dtype": int(convert_dtype(dtype))})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """One id a row of the probabilities `x`, int64. `min`, `max` and
    `dtype` are taken and unused, as in the JAX package."""
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("sampling_id", inputs={"X": x},
                     outputs={"Out": out}, attrs={"seed": seed})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("random_crop", inputs={"X": x},
                     outputs={"Out": out},
                     attrs={"shape": list(shape),
                            "startup_seed": seed or 0})
    return out


def fsp_matrix(x, y):
    """The FSP matrix of two NCHW feature maps (the fsp op)."""
    helper = LayerHelper("fsp")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fsp", inputs={"X": x, "Y": y},
                     outputs={"Out": out})
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an fc of concat([x_t, hidden_t_prev]) to 4 * size,
    then the lstm_unit op. Returns (h, c)."""
    helper = LayerHelper("lstm_unit", name=name)
    size = cell_t_prev.shape[-1]
    fc_out = fc(concat([x_t, hidden_t_prev], axis=-1), 4 * size,
                param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit",
                     inputs={"X": fc_out, "C_prev": cell_t_prev},
                     outputs={"C": c, "H": h},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False, name=None):
    """One GRU step on the [N, 3 * hidden] projection `input`; `size` is
    3 * hidden. Returns (hidden, reset hidden, gate)."""
    helper = LayerHelper("gru_unit", name=name)
    dtype = input.dtype
    hidden_dim = size // 3
    weight = helper.create_parameter(param_attr,
                                     [hidden_dim, 3 * hidden_dim], dtype)
    bias = helper.create_parameter(bias_attr, [1, 3 * hidden_dim], dtype,
                                   is_bias=True)
    act_codes = {"identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
    gate = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "gru_unit",
        inputs={"Input": input, "HiddenPrev": hidden, "Weight": weight,
                "Bias": bias},
        outputs={"Gate": gate, "ResetHiddenPrev": reset_h,
                 "Hidden": updated},
        attrs={"activation": act_codes[activation],
               "gate_activation": act_codes[gate_activation],
               "origin_mode": origin_mode})
    return updated, reset_h, gate


def merge_selected_rows(x, name=None):
    helper = LayerHelper("merge_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("merge_selected_rows", inputs={"X": x},
                     outputs={"Out": out})
    return out


def get_tensor_from_selected_rows(x, name=None):
    helper = LayerHelper("get_tensor_from_selected_rows", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("get_tensor_from_selected_rows", inputs={"X": x},
                     outputs={"Out": out})
    return out


def rank(input):
    """The number of dimensions of `input`, a constant int32 [1]."""
    from .tensor import fill_constant
    return fill_constant([1], "int32", len(input.shape))


# ---------------------------------------------------------------------------
# the conv family
# ---------------------------------------------------------------------------

def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv3d", bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    num_channels = input.shape[1]
    w = helper.create_parameter(
        param_attr, [num_filters, num_channels // groups] +
        _pair(filter_size, 3), input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv3d", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": _pair(stride, 3),
               "paddings": _pair(padding, 3),
               "dilations": _pair(dilation, 3), "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def _conv_transpose(op_type, nd, input, num_filters, output_size,
                    filter_size, padding, stride, dilation, groups,
                    param_attr, bias_attr, act, name):
    helper = LayerHelper(op_type, bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    if filter_size is None:
        # the filter that makes `output_size` from the input's size
        osz = _pair(output_size, nd)
        st, pd = _pair(stride, nd), _pair(padding, nd)
        filter_size = [osz[i] - (input.shape[2 + i] - 1) * st[i] +
                       2 * pd[i] for i in range(nd)]
    w = helper.create_parameter(
        param_attr, [input.shape[1], num_filters // groups] +
        _pair(filter_size, nd), input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        op_type, inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": _pair(stride, nd),
               "paddings": _pair(padding, nd),
               "dilations": _pair(dilation, nd), "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    """The filter is [in_c, num_filters / groups, kh, kw]; without
    filter_size it is derived from output_size."""
    return _conv_transpose("conv2d_transpose", 2, input, num_filters,
                           output_size, filter_size, padding, stride,
                           dilation, groups, param_attr, bias_attr, act,
                           name)


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, padding=0, stride=1, dilation=1,
                     groups=None, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    """A conv3d_transpose op with 3-element attrs and a [in_c,
    num_filters / groups, kd, kh, kw] filter. (The JAX package's
    builder is its 2-D one, which cannot run on a 5-D input.)"""
    return _conv_transpose("conv3d_transpose", 3, input, num_filters,
                           output_size, filter_size, padding, stride,
                           dilation, groups, param_attr, bias_attr, act,
                           name)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool3d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type,
               "ksize": _pair(pool_size, 3),
               "strides": _pair(pool_stride, 3),
               "paddings": _pair(pool_padding, 3),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max",
                    require_index=False, name=None):
    """A pool2d op pooling to output size `pool_size` in even windows
    (each spatial size must divide by its output size)."""
    helper = LayerHelper("adaptive_pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "adaptive": True})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max",
                    require_index=False, name=None):
    """A pool3d op pooling to output size `pool_size` in even windows;
    require_index returns (out, mask) from a max_pool3d_with_index op
    with adaptive bins."""
    helper = LayerHelper("adaptive_pool3d", name=name)
    if require_index:
        if pool_type != "max":
            raise ValueError("require_index needs pool_type='max'")
        out = helper.create_variable_for_type_inference(input.dtype)
        mask = helper.create_variable_for_type_inference("int32")
        helper.append_op(
            "max_pool3d_with_index", inputs={"X": input},
            outputs={"Out": out, "Mask": mask},
            attrs={"ksize": _pair(pool_size, 3), "adaptive": True})
        return out, mask
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool3d", inputs={"X": input}, outputs={"Out": out},
        attrs={"pooling_type": pool_type,
               "ksize": _pair(pool_size, 3), "adaptive": True})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None,
                 align_corners=True, align_mode=1):
    """A bilinear_interp or nearest_interp op to `out_shape` ([h, w]) or
    by `scale`. `actual_shape`, or `out_shape` given as a Variable, is
    the op's OutSize input, as in the reference (the JAX builder drops
    actual_shape): a shape read at run time, so the block that holds it
    runs eagerly."""
    op = "bilinear_interp" if resample.upper() == "BILINEAR" else \
        "nearest_interp"
    if isinstance(out_shape, Variable):
        actual_shape, out_shape = out_shape, None
    attrs = {"align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), \
            int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    if actual_shape is None:
        return _single_op(op, input, attrs)
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(op, inputs={"X": input, "OutSize": actual_shape},
                     outputs={"Out": out}, attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so that the short side is `out_short_len` (the other side
    rounded to keep the aspect)."""
    h, w = input.shape[2], input.shape[3]
    s = out_short_len / float(min(h, w))
    return image_resize(input, out_shape=[int(builtins.round(h * s)),
                                          int(builtins.round(w * s))],
                        resample=resample)


def pixel_shuffle(x, upscale_factor):
    return _single_op("pixel_shuffle", x,
                      {"upscale_factor": upscale_factor})


def space_to_depth(x, blocksize, name=None):
    return _single_op("space_to_depth", x, {"blocksize": blocksize})


def shuffle_channel(x, group, name=None):
    return _single_op("shuffle_channel", x, {"group": group})


def affine_channel(x, scale=None, bias=None, data_layout="NCHW",
                   name=None):
    helper = LayerHelper("affine_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("affine_channel",
                     inputs={"X": x, "Scale": scale, "Bias": bias},
                     outputs={"Out": out},
                     attrs={"data_layout": data_layout})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """An unfold op, its output in slot Y, as the op writes it (the JAX
    builder binds Out, which the op never writes)."""
    helper = LayerHelper("unfold", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "unfold", inputs={"X": x}, outputs={"Y": out},
        attrs={"kernel_sizes": _pair(kernel_sizes),
               "strides": _pair(strides), "paddings": _pair(paddings, 4),
               "dilations": _pair(dilations)})
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _single_op("temporal_shift", x,
                      {"seg_num": seg_num, "shift_ratio": shift_ratio})


def spp(input, pyramid_height, pool_type="max"):
    return _single_op("spp", input, {"pyramid_height": pyramid_height,
                                     "pooling_type": pool_type})


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "roi_align", inputs={"X": input, "ROIs": rois},
        outputs={"Out": out},
        attrs={"pooled_height": pooled_height,
               "pooled_width": pooled_width,
               "spatial_scale": spatial_scale,
               "sampling_ratio": sampling_ratio})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "roi_pool", inputs={"X": input, "ROIs": rois},
        outputs={"Out": out, "Argmax": argmax},
        attrs={"pooled_height": pooled_height,
               "pooled_width": pooled_width,
               "spatial_scale": spatial_scale})
    return out


def psroi_pool(input, rois, output_channels, spatial_scale,
               pooled_height, pooled_width, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "psroi_pool", inputs={"X": input, "ROIs": rois},
        outputs={"Out": out},
        attrs={"output_channels": output_channels,
               "spatial_scale": spatial_scale,
               "pooled_height": pooled_height,
               "pooled_width": pooled_width})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out[b, o] = x[b] @ W[o] @ y[b] + bias: creates W [size, dx, dy]
    and, unless bias_attr is False, the bias [1, size]."""
    helper = LayerHelper("bilinear_tensor_product", act=act,
                         bias_attr=bias_attr, name=name)
    w = helper.create_parameter(param_attr,
                                [size, x.shape[1], y.shape[1]], x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": x, "Y": y, "Weight": w}
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(
            bias_attr, [1, size], x.dtype, is_bias=True)
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": out})
    return helper.append_activation(out)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk precision, recall, F1 and the inferred, labelled and
    correct chunk counts of the tag ids `input` against `label`
    (schemes IOB, IOE, IOBES, plain)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    n_infer = helper.create_variable_for_type_inference("int32")
    n_label = helper.create_variable_for_type_inference("int32")
    n_correct = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "chunk_eval", inputs={"Inference": input, "Label": label},
        outputs={"Precision": precision, "Recall": recall,
                 "F1-Score": f1, "NumInferChunks": n_infer,
                 "NumLabelChunks": n_label,
                 "NumCorrectChunks": n_correct},
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, n_infer, n_label, n_correct


def mean_iou(input, label, num_classes):
    """The mean IoU of the predicted class ids against the labels, and
    each class's wrong and correct counts (int32 [num_classes])."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "mean_iou", inputs={"Predictions": input, "Labels": label},
        outputs={"OutMeanIou": miou, "OutWrong": wrong,
                 "OutCorrect": correct},
        attrs={"num_classes": num_classes})
    return miou, wrong, correct


# ---------------------------------------------------------------------------
# slice 26: the builders of misc's user-path ops
# ---------------------------------------------------------------------------

def lod_reset(x, y=None, target_lod=None):
    """X with the LoD of `y` (its LoD, else its values as offsets) or
    `target_lod`."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs, attrs = {"X": x}, {}
    if y is not None:
        inputs["Y"] = y
    elif target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    helper.append_op("lod_reset", inputs=inputs, outputs={"Out": out},
                     attrs=attrs)
    return out


def lod_append(x, level):
    """X with `level` (offsets, or a Variable) appended under its
    LoD's levels: a lod_reset op with append_lod."""
    helper = LayerHelper("lod_append")
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs, attrs = {"X": x}, {"append_lod": True}
    if isinstance(level, Variable):
        inputs["Y"] = level
    else:
        attrs["target_lod"] = [int(v) for v in level]
    helper.append_op("lod_reset", inputs=inputs, outputs={"Out": out},
                     attrs=attrs)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", act=act)
    w = helper.create_parameter(
        param_attr, [future_context_size + 1, input.shape[-1]], input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("row_conv", inputs={"X": input, "Filter": w},
                     outputs={"Out": out})
    return helper.append_activation(out)


def unique(x, dtype="int32"):
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    helper.append_op("unique", inputs={"X": x},
                     outputs={"Out": out, "Index": index},
                     attrs={"dtype": dtype})
    return out, index


def unique_with_counts(x, dtype="int32"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    count = helper.create_variable_for_type_inference(dtype)
    helper.append_op("unique_with_counts", inputs={"X": x},
                     outputs={"Out": out, "Index": index, "Count": count},
                     attrs={"dtype": dtype})
    return out, index, count


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight over its largest singular value; the power iteration's
    vectors U [h] and V [w] are parameters that need no gradient, which
    each run advances."""
    helper = LayerHelper("spectral_norm", name=name)
    h = int(weight.shape[dim])
    w = int(np.prod(weight.shape)) // h
    u = helper.create_parameter(None, [h], "float32")
    v = helper.create_parameter(None, [w], "float32")
    u.stop_gradient = True
    v.stop_gradient = True
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op("spectral_norm",
                     inputs={"Weight": weight, "U": u, "V": v},
                     outputs={"Out": out},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """A tree_conv op (which applies tanh itself), then `act`, as the
    JAX builder does; bias_attr makes no bias there either."""
    helper = LayerHelper("tree_conv", name=name, bias_attr=bias_attr,
                         act=act)
    w = helper.create_parameter(
        param_attr, [int(nodes_vector.shape[-1]), 3, output_size,
                     num_filters], nodes_vector.dtype)
    out = helper.create_variable_for_type_inference(nodes_vector.dtype)
    helper.append_op("tree_conv",
                     inputs={"NodesVector": nodes_vector,
                             "EdgeSet": edge_set, "Filter": w},
                     outputs={"Out": out}, attrs={"max_depth": max_depth})
    return helper.append_activation(out)


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    helper = LayerHelper("lstmp", name=name)
    units = size // 4
    w = helper.create_parameter(param_attr, [proj_size, 4 * units], dtype)
    wp = helper.create_parameter(None, [units, proj_size], dtype)
    b = helper.create_parameter(
        bias_attr, [1, 7 * units if use_peepholes else 4 * units], dtype)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "lstmp",
        inputs={"Input": input, "Weight": w, "ProjWeight": wp, "Bias": b},
        outputs={"Projection": proj, "Cell": cell},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """A dense_lstm op (the reference's cudnn_lstm contract): input
    [B, T, D], init_h / init_c [layers * dirs, B, hidden]; one flat
    weight of every layer's and direction's Wx, Wh, bx and bh. Returns
    (out, last_h, last_c)."""
    helper = LayerHelper("cudnn_lstm", name=name)
    dtype = input.dtype
    d = int(input.shape[-1])
    dirs = 2 if is_bidirec else 1
    size = 0
    for i in range(num_layers):
        din = d if i == 0 else hidden_size * dirs
        size += (din + hidden_size) * hidden_size * 4 * dirs
        size += hidden_size * 8 * dirs
    w = helper.create_parameter(default_initializer, [size], dtype)
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "dense_lstm",
        inputs={"Input": input, "InitH": init_h, "InitC": init_c, "W": w},
        outputs={"Out": out, "LastH": last_h, "LastC": last_c},
        attrs={"hidden_size": hidden_size, "num_layers": num_layers,
               "is_bidirec": is_bidirec, "dropout_prob": dropout_prob,
               "is_test": is_test})
    return out, last_h, last_c


def affine_grid(theta, out_shape=None, name=None):
    """A tensor out_shape is the op's OutputShape (read on the host: its
    block runs eagerly), else its output_shape attr."""
    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    inputs, attrs = {"Theta": theta}, {}
    if isinstance(out_shape, Variable):
        inputs["OutputShape"] = out_shape
    else:
        attrs["output_shape"] = [int(v) for v in out_shape]
    helper.append_op("affine_grid", inputs=inputs, outputs={"Output": out},
                     attrs=attrs)
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("grid_sampler", inputs={"X": x, "Grid": grid},
                     outputs={"Output": out})
    return out


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """The center loss; the centers are a parameter the op updates
    (CentersOut is the same var), at rate `alpha` (a fill_constant)."""
    from .tensor import fill_constant
    helper = LayerHelper("center_loss")
    centers = helper.create_parameter(
        param_attr, [num_classes, int(input.shape[-1])], input.dtype)
    centers.stop_gradient = True
    rate = fill_constant([1], "float32", float(alpha))
    loss = helper.create_variable_for_type_inference(input.dtype)
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "center_loss",
        inputs={"X": input, "Label": label, "Centers": centers,
                "CenterUpdateRate": rate},
        outputs={"Loss": loss, "CentersOut": centers,
                 "SampleCenterDiff": diff},
        attrs={"need_update": update_center})
    return loss


def continuous_value_model(input, cvm, use_cvm=True):
    helper = LayerHelper("cvm")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cvm", inputs={"X": input, "CVM": cvm},
                     outputs={"Y": out}, attrs={"use_cvm": use_cvm})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op("pad_constant_like", inputs={"X": x, "Y": y},
                     outputs={"Out": out},
                     attrs={"pad_value": float(pad_value)})
    return out


def similarity_focus(input, axis, indexes, name=None):
    helper = LayerHelper("similarity_focus", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("similarity_focus", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"axis": axis,
                            "indexes": [int(i) for i in indexes]})
    return out


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    helper = LayerHelper("teacher_student_sigmoid_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "teacher_student_sigmoid_loss",
        inputs={"X": input, "Label": label}, outputs={"Y": out},
        attrs={"soft_max_up_bound": soft_max_up_bound,
               "soft_max_lower_bound": soft_max_lower_bound})
    return out


def unpool2d(input, indices, ksize, strides=None, paddings=None):
    helper = LayerHelper("unpool")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "unpool", inputs={"X": input, "Indices": indices},
        outputs={"Out": out},
        attrs={"ksize": list(ksize), "strides": list(strides or [1, 1]),
               "paddings": list(paddings or [0, 0])})
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, name=None):
    helper = LayerHelper("deformable_conv", name=name, bias_attr=bias_attr)
    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size] * 2
    w = helper.create_parameter(
        param_attr, [num_filters, input.shape[1] // groups, ks[0], ks[1]],
        input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)

    def two(v):
        return [v] * 2 if isinstance(v, int) else list(v)

    helper.append_op(
        "deformable_conv",
        inputs={"Input": input, "Offset": offset, "Mask": mask,
                "Filter": w},
        outputs={"Output": out},
        attrs={"strides": two(stride), "paddings": two(padding),
               "dilations": two(dilation), "groups": groups,
               "deformable_groups": deformable_groups,
               "im2col_step": im2col_step})
    return helper.append_bias_op(out, dim_start=1)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    helper = LayerHelper("deformable_psroi_pooling", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ph, pw = pooled_height, pooled_width
    out_dim = input.shape[1] // (group_size[0] * group_size[1]) \
        if position_sensitive else input.shape[1]
    helper.append_op(
        "deformable_psroi_pooling",
        inputs={"Input": input, "ROIs": rois, "Trans": trans},
        outputs={"Output": out},
        attrs={"no_trans": no_trans, "spatial_scale": spatial_scale,
               "output_dim": int(out_dim), "group_size": list(group_size),
               "pooled_height": ph, "pooled_width": pw,
               "part_size": list(part_size) if part_size else [ph, pw],
               "sample_per_part": sample_per_part, "trans_std": trans_std})
    return out
