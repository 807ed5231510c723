"""Sequence layers over LoD inputs (counterpart of
paddle_tpu/layers/sequence.py): the layer functions of the ops of
ops/sequence.py. Their outputs' rows depend on the LoD of the feeds, so
they are appended without shape inference (infer_shape=False), as in
the JAX package, and each declares its output's width (rows
-1), as the reference's InferShape does at build time: a layer built
on it (an fc's weight, sequence_conv's bias) takes its width from there.
The JAX package leaves those outputs without a shape, so an fc after
sequence_pool(dynamic_lstm(...)) gets a weight of width 1 there."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_first_step",
    "sequence_last_step", "sequence_softmax", "sequence_expand",
    "sequence_expand_as", "sequence_concat", "sequence_reverse",
    "sequence_reshape", "sequence_pad", "sequence_unpad",
    "sequence_conv", "sequence_enumerate", "sequence_scatter",
    "im2sequence", "sequence_erase", "sequence_slice", "edit_distance",
]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("sequence_mask", inputs={"X": x},
                     outputs={"Y": out},
                     attrs={"maxlen": maxlen if maxlen is not None
                            else -1, "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (-1,) + tuple(input.shape[1:])  # one row per sequence
    max_index = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("sequence_pool", inputs={"X": input},
                     outputs={"Out": out, "MaxIndex": max_index},
                     attrs={"pooltype": pool_type.upper(),
                            "is_test": is_test,
                            "pad_value": pad_value},
                     infer_shape=False)
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def _rows(shape):
    """(-1, rest of shape): the rows a LoD sets, the widths kept."""
    return (-1,) + tuple(shape[1:])


def _seq_op(op_type, inputs, dtype, shape, out_slot="Out", attrs=None,
            name=None, stop_gradient=False):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient)
    out.shape = tuple(shape)
    helper.append_op(op_type, inputs=inputs, outputs={out_slot: out},
                     attrs=attrs or {}, infer_shape=False)
    return out


def sequence_softmax(input, use_cudnn=False, name=None):
    return _seq_op("sequence_softmax", {"X": input}, input.dtype,
                   _rows(input.shape), name=name)


def sequence_expand(x, y, ref_level=-1, name=None):
    return _seq_op("sequence_expand", {"X": x, "Y": y}, x.dtype,
                   _rows(x.shape), attrs={"ref_level": ref_level},
                   name=name)


def sequence_expand_as(x, y, name=None):
    return _seq_op("sequence_expand_as", {"X": x, "Y": y}, x.dtype,
                   _rows(x.shape), name=name)


def sequence_concat(input, name=None):
    return _seq_op("sequence_concat", {"X": input}, input[0].dtype,
                   _rows(input[0].shape), name=name)


def sequence_reverse(x, name=None):
    return _seq_op("sequence_reverse", {"X": x}, x.dtype, _rows(x.shape),
                   out_slot="Y", name=name)


def sequence_reshape(input, new_dim):
    return _seq_op("sequence_reshape", {"X": input}, input.dtype,
                   (-1, new_dim), attrs={"new_dim": new_dim})


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (-1, maxlen if maxlen else -1) + tuple(x.shape[1:])
    length = helper.create_variable_for_type_inference("int64", True)
    length.shape = (-1,)
    helper.append_op("sequence_pad",
                     inputs={"X": x, "PadValue": pad_value},
                     outputs={"Out": out, "Length": length},
                     attrs={"padded_length": maxlen if maxlen else -1},
                     infer_shape=False)
    return out, length


def sequence_unpad(x, length, name=None):
    return _seq_op("sequence_unpad", {"X": x, "Length": length}, x.dtype,
                   (-1,) + tuple(x.shape[2:]), name=name)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", bias_attr=bias_attr, act=act,
                         name=name)
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(param_attr, filter_shape,
                                           input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (-1, num_filters)
    helper.append_op(
        "sequence_conv", inputs={"X": input, "Filter": filter_param},
        outputs={"Out": out},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size}, infer_shape=False)
    pre_act = helper.append_bias_op(out)
    return helper.append_activation(pre_act)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _seq_op("sequence_enumerate", {"X": input}, input.dtype,
                   (-1, win_size), attrs={"win_size": win_size, "pad_value": pad_value},
                   name=name, stop_gradient=True)


def sequence_scatter(input, index, updates, name=None):
    return _seq_op("sequence_scatter",
                   {"X": input, "Ids": index, "Updates": updates},
                   input.dtype, input.shape, name=name)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding] * 4
    width = input.shape[1] * filter_size[0] * filter_size[1]
    return _seq_op("im2sequence", {"X": input}, input.dtype, (-1, width),
                   attrs={"kernels": filter_size, "strides": stride,
                          "paddings": padding}, name=name)


def sequence_erase(input, tokens, name=None):
    """input's rows without the ids in `tokens` (read on the host)."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("sequence_erase", inputs={"X": input},
                     outputs={"Out": out}, attrs={"tokens": list(tokens)},
                     infer_shape=False)
    return out


def sequence_slice(input, offset, length, name=None):
    """Of each sequence, length[i] rows from its row offset[i] (both
    read on the host)."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_slice", inputs={"X": input, "Offset": offset,
                                               "Length": length},
                     outputs={"Out": out}, infer_shape=False)
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  name=None):
    """(distances [N, 1] float32, sequence count [1] int64) of each
    hypothesis in `input` to its reference in `label`, on the host."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference("float32", True)
    seq_num = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("edit_distance", inputs={"Hyps": input, "Refs": label},
                     outputs={"Out": out, "SequenceNum": seq_num},
                     attrs={"normalized": normalized}, infer_shape=False)
    return out, seq_num
