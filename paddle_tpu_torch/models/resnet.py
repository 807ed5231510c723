"""ResNet (18/34/50/101/152) built with paddle_tpu_torch.layers
(counterpart of paddle_tpu/models/resnet.py: the same structure and
parameter names, so parameters cross between the two packages).

BASELINE config 2 is ResNet-50 at 224x224 with Momentum under bf16 AMP.
NCHW by default, NHWC through `layout`; the filters are OIHW in both
layouts, so one scope serves either graph. Batch norm is its own op after
each convolution (no conv/bn fusion pass).
"""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr
from ..initializer import Constant


_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, name=None, is_test=False, layout="NCHW"):
    conv = layers.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False, data_format=layout,
        param_attr=ParamAttr(name=name + ".conv.w_0"))
    return layers.batch_norm(
        conv, act=act, is_test=is_test, data_layout=layout,
        param_attr=ParamAttr(name=name + ".bn.w_0",
                             initializer=Constant(1.0)),
        bias_attr=ParamAttr(name=name + ".bn.b_0",
                            initializer=Constant(0.0)),
        moving_mean_name=name + ".bn.mean",
        moving_variance_name=name + ".bn.var")


def _shortcut(input, ch_out, stride, name, is_test, layout):
    ch_in = input.shape[-1] if layout == "NHWC" else input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test, layout=layout)
    return input


def _bottleneck(input, num_filters, stride, name, is_test, layout):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name + ".branch2a", is_test=is_test,
                          layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=name + ".branch2b", is_test=is_test,
                          layout=layout)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          name=name + ".branch2c", is_test=is_test,
                          layout=layout)
    short = _shortcut(input, num_filters * 4, stride,
                      name=name + ".branch1", is_test=is_test,
                      layout=layout)
    return layers.relu(layers.elementwise_add(short, conv2))


def _basic(input, num_filters, stride, name, is_test, layout):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          name=name + ".branch2a", is_test=is_test,
                          layout=layout)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None,
                          name=name + ".branch2b", is_test=is_test,
                          layout=layout)
    short = _shortcut(input, num_filters, stride, name=name + ".branch1",
                      is_test=is_test, layout=layout)
    return layers.relu(layers.elementwise_add(short, conv1))


def resnet(input, class_dim=1000, depth=50, is_test=False,
           layout="NCHW"):
    """input: [B, 3, H, W] (NCHW) or [B, H, W, 3] (NHWC); weights are
    OIHW in both layouts, so a trained scope serves either graph.
    Returns logits [B, class_dim]."""
    if layout not in ("NCHW", "NHWC"):
        raise ValueError(f"layout must be NCHW or NHWC, got {layout!r}")
    block_fn_name, stages = _DEPTH_CFG[depth]
    block_fn = _bottleneck if block_fn_name == "bottleneck" else _basic
    x = conv_bn_layer(input, 64, 7, stride=2, act="relu", name="res_conv1",
                      is_test=is_test, layout=layout)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max", data_format=layout)
    num_filters = [64, 128, 256, 512]
    for stage, n_blocks in enumerate(stages):
        for blk in range(n_blocks):
            stride = 2 if blk == 0 and stage != 0 else 1
            x = block_fn(x, num_filters[stage], stride,
                         f"res{stage + 2}{chr(ord('a') + blk)}", is_test,
                         layout)
    x = layers.pool2d(x, pool_type="avg", global_pooling=True,
                      data_format=layout)
    return layers.fc(x, class_dim, param_attr=ParamAttr(name="res_fc.w_0"),
                     bias_attr=ParamAttr(name="res_fc.b_0"))


def resnet_train(class_dim=1000, depth=50, image_shape=None,
                 is_test=False, layout="NCHW"):
    """Training graph: returns (avg_cost, accuracy, feed_names)."""
    if image_shape is None:
        image_shape = (224, 224, 3) if layout == "NHWC" else \
            (3, 224, 224)
    image = layers.data("image", list(image_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    logits = resnet(image, class_dim, depth, is_test, layout=layout)
    cost = layers.softmax_with_cross_entropy(logits, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(layers.softmax(logits), label)
    return avg_cost, acc, ["image", "label"]
