"""Dygraph NN layers (counterpart of paddle_tpu/dygraph/nn.py): FC,
Linear, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose, Pool2D,
BatchNorm, Embedding, LayerNorm, GroupNorm, PRelu, Dropout,
BilinearTensorProduct, GRUUnit, NCE, SpectralNorm and TreeConv. Each
layer calls the graph-mode layer builder, which in dygraph mode creates
the layer's parameters through the tracer (once: the tracer's lazy
creation memo) and runs its ops at once. BatchNorm's moving mean and
variance are parameters that are not trained; the batch_norm op updates
them in place (MeanOut and VarianceOut are the same VarBases);
spectral_norm advances SpectralNorm's U and V in place likewise."""
from __future__ import annotations

from .. import layers as L
from .layers import Layer

__all__ = ["Conv2D", "Pool2D", "FC", "Linear", "BatchNorm", "Embedding",
           "LayerNorm", "GroupNorm", "PRelu", "Dropout", "Conv2DTranspose",
           "Conv3D", "Conv3DTranspose", "BilinearTensorProduct", "GRUUnit",
           "NCE", "SpectralNorm", "TreeConv"]


class FC(Layer):
    def __init__(self, name_scope=None, size=None, num_flatten_dims=1,
                 param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._num_flatten_dims = num_flatten_dims
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act

    def forward(self, input):
        return L.fc(input, self._size,
                    num_flatten_dims=self._num_flatten_dims,
                    param_attr=self._param_attr,
                    bias_attr=self._bias_attr, act=self._act)


class Linear(FC):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(None, output_dim, 1, param_attr, bias_attr, act,
                         dtype)


class Conv2D(Layer):
    def __init__(self, name_scope=None, num_filters=None, filter_size=3,
                 stride=1, padding=0, dilation=1, groups=None,
                 param_attr=None, bias_attr=None, use_cudnn=True,
                 act=None, dtype="float32", num_channels=None):
        super().__init__(name_scope, dtype)
        self._kw = dict(num_filters=num_filters, filter_size=filter_size,
                        stride=stride, padding=padding, dilation=dilation,
                        groups=groups, param_attr=param_attr,
                        bias_attr=bias_attr, act=act)

    def forward(self, input):
        return L.conv2d(input, **self._kw)


class Conv2DTranspose(Layer):
    def __init__(self, name_scope=None, num_filters=None, output_size=None,
                 filter_size=None, padding=0, stride=1, dilation=1,
                 groups=None, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None):
        super().__init__(name_scope)
        self._kw = dict(num_filters=num_filters, output_size=output_size,
                        filter_size=filter_size, padding=padding,
                        stride=stride, dilation=dilation, groups=groups,
                        param_attr=param_attr, bias_attr=bias_attr,
                        act=act)

    def forward(self, input):
        return L.conv2d_transpose(input, **self._kw)


class Conv3D(Layer):
    def __init__(self, name_scope=None, num_filters=None, filter_size=3,
                 stride=1, padding=0, dilation=1, groups=None,
                 param_attr=None, bias_attr=None, use_cudnn=True,
                 act=None):
        super().__init__(name_scope)
        self._kw = dict(num_filters=num_filters, filter_size=filter_size,
                        stride=stride, padding=padding, dilation=dilation,
                        groups=groups, param_attr=param_attr,
                        bias_attr=bias_attr, act=act)

    def forward(self, input):
        return L.conv3d(input, **self._kw)


class Conv3DTranspose(Layer):
    def __init__(self, name_scope=None, num_filters=None,
                 output_size=None, filter_size=None, padding=0,
                 stride=1, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None):
        super().__init__(name_scope)
        self._kw = dict(num_filters=num_filters, output_size=output_size,
                        filter_size=filter_size, padding=padding,
                        stride=stride, dilation=dilation, groups=groups,
                        param_attr=param_attr, bias_attr=bias_attr,
                        act=act)

    def forward(self, input):
        return L.conv3d_transpose(input, **self._kw)


class Pool2D(Layer):
    def __init__(self, name_scope=None, pool_size=-1, pool_type="max",
                 pool_stride=1, pool_padding=0, global_pooling=False,
                 use_cudnn=True, ceil_mode=False, exclusive=True):
        super().__init__(name_scope)
        self._kw = dict(pool_size=pool_size, pool_type=pool_type,
                        pool_stride=pool_stride,
                        pool_padding=pool_padding,
                        global_pooling=global_pooling,
                        ceil_mode=ceil_mode, exclusive=exclusive)

    def forward(self, input):
        return L.pool2d(input, **self._kw)


class BatchNorm(Layer):
    def __init__(self, name_scope=None, num_channels=None, act=None,
                 is_test=False, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=False,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(name_scope, dtype)
        self._kw = dict(act=act, momentum=momentum, epsilon=epsilon,
                        param_attr=param_attr, bias_attr=bias_attr,
                        data_layout=data_layout,
                        use_global_stats=use_global_stats)

    def forward(self, input):
        return L.batch_norm(input, is_test=not self.training, **self._kw)


class Embedding(Layer):
    def __init__(self, name_scope=None, size=None, is_sparse=False,
                 is_distributed=False, padding_idx=None, param_attr=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._kw = dict(size=size, is_sparse=is_sparse,
                        padding_idx=padding_idx, param_attr=param_attr,
                        dtype=dtype)

    def forward(self, input):
        return L.embedding(input, **self._kw)


class LayerNorm(Layer):
    def __init__(self, name_scope=None, scale=True, shift=True,
                 begin_norm_axis=1, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None):
        super().__init__(name_scope)
        self._kw = dict(scale=scale, shift=shift,
                        begin_norm_axis=begin_norm_axis, epsilon=epsilon,
                        param_attr=param_attr, bias_attr=bias_attr,
                        act=act)

    def forward(self, input):
        return L.layer_norm(input, **self._kw)


class GroupNorm(Layer):
    def __init__(self, name_scope=None, groups=None, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None,
                 data_layout="NCHW"):
        super().__init__(name_scope)
        self._kw = dict(groups=groups, epsilon=epsilon,
                        param_attr=param_attr, bias_attr=bias_attr,
                        act=act)

    def forward(self, input):
        return L.group_norm(input, **self._kw)


class PRelu(Layer):
    def __init__(self, name_scope=None, mode="all", param_attr=None):
        super().__init__(name_scope)
        self._mode = mode
        self._param_attr = param_attr

    def forward(self, input):
        return L.prelu(input, self._mode, self._param_attr)


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation

    def forward(self, input):
        return L.dropout(input, self._p, is_test=not self.training,
                         dropout_implementation=self._impl)


class BilinearTensorProduct(Layer):
    def __init__(self, name_scope=None, size=None, param_attr=None,
                 bias_attr=None, act=None):
        super().__init__(name_scope)
        self._kw = dict(size=size, param_attr=param_attr,
                        bias_attr=bias_attr, act=act)

    def forward(self, x, y):
        return L.bilinear_tensor_product(x, y, **self._kw)


class GRUUnit(Layer):
    """One GRU step (gru_unit): forward(input [B, 3 * size], hidden [B,
    size]) returns (hidden, reset_hidden_prev, gate)."""

    def __init__(self, name_scope=None, size=None, param_attr=None,
                 bias_attr=None, activation="tanh",
                 gate_activation="sigmoid", origin_mode=False,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._kw = dict(size=size, param_attr=param_attr,
                        bias_attr=bias_attr, activation=activation,
                        gate_activation=gate_activation,
                        origin_mode=origin_mode)

    def forward(self, input, hidden):
        return L.gru_unit(input, hidden, **self._kw)


class NCE(Layer):
    """The nce loss of its constructor's settings (the sample_weight
    given there; forward's, as in the JAX package, is not read)."""

    def __init__(self, name_scope=None, num_total_classes=None,
                 sample_weight=None, param_attr=None, bias_attr=None,
                 num_neg_samples=None, sampler="uniform",
                 custom_dist=None, seed=0, is_sparse=False):
        super().__init__(name_scope)
        self._kw = dict(num_total_classes=num_total_classes,
                        sample_weight=sample_weight,
                        param_attr=param_attr, bias_attr=bias_attr,
                        num_neg_samples=num_neg_samples,
                        sampler=sampler, custom_dist=custom_dist,
                        seed=seed, is_sparse=is_sparse)

    def forward(self, input, label, sample_weight=None):
        return L.nce(input, label, **self._kw)


class SpectralNorm(Layer):
    def __init__(self, name_scope=None, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__(name_scope)
        self._kw = dict(dim=dim, power_iters=power_iters, eps=eps)

    def forward(self, weight):
        return L.spectral_norm(weight, **self._kw)


class TreeConv(Layer):
    def __init__(self, name_scope=None, output_size=None, num_filters=1,
                 max_depth=8, act="tanh", param_attr=None, bias_attr=None,
                 name=None):
        super().__init__(name_scope)
        self._kw = dict(output_size=output_size, num_filters=num_filters,
                        max_depth=max_depth, act=act,
                        param_attr=param_attr, bias_attr=bias_attr)

    def forward(self, nodes_vector, edge_set):
        return L.tree_conv(nodes_vector, edge_set, **self._kw)
