"""LeNet-5 for MNIST (BASELINE config 1: "MNIST LeNet via
fluid.Executor"), counterpart of paddle_tpu/models/lenet.py: conv 20 and
50 filters of 5x5 with relu, each followed by a 2x2 max pool, then fc 10
with softmax."""
from __future__ import annotations

from .. import layers


def lenet(img, class_dim=10, is_test=False):
    conv1 = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2,
                          pool_type="max")
    conv2 = layers.conv2d(pool1, num_filters=50, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2,
                          pool_type="max")
    return layers.fc(pool2, class_dim, act="softmax")


def lenet_train(is_test=False):
    """(mean cross-entropy cost, accuracy, feed names) of LeNet on
    img [-1, 1, 28, 28] float32 and label [-1, 1] int64."""
    img = layers.data("img", [1, 28, 28], dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    prediction = lenet(img, is_test=is_test)
    cost = layers.cross_entropy(prediction, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(prediction, label)
    return avg_cost, acc, ["img", "label"]
