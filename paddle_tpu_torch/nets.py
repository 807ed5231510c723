"""Composite layers (counterpart of paddle_tpu/nets.py):
sequence_conv_pool."""
from __future__ import annotations

from . import layers

__all__ = ["sequence_conv_pool"]


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """sequence_conv over each sequence's windows of `filter_size` rows,
    then sequence_pool: one row a sequence."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
