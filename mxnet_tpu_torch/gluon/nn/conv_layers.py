"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``; ref:
python/mxnet/gluon/nn/conv_layers.py). The transposed convolutions run
the ``Deconvolution`` op, their weight laid out (in, out/g, k...); the
reference lists no 3-D transpose, and neither does the port."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _pair(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._ndim = len(kernel_size)
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels,
                          in_channels // groups if in_channels else 0) \
                    + tuple(kernel_size)
            else:
                wshape = (in_channels, channels // groups) \
                    + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x, *args):
        groups = self._kwargs["num_group"]
        if self._op_name == "Convolution":
            lead = (self._channels, x.shape[1] // groups)
        else:
            lead = (x.shape[1], self._channels // groups)
        self.weight._shape = lead + tuple(self._kwargs["kernel"])

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return "{name}({mapping}, kernel_size={kernel}, stride={stride})" \
            .format(name=self.__class__.__name__,
                    mapping="{0} -> {1}".format(
                        shape[1] if shape[1] else None, shape[0]),
                    kernel=self._kwargs["kernel"],
                    stride=self._kwargs["stride"])


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_pair(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups, layout,
                         in_channels, activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=_pair(output_padding, 2), **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout="NCHW",
                 count_include_pad=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad})".format(
            name=self.__class__.__name__, **self._kwargs)


def _pool_class(name, ndim, pool_type, layout):
    def __init__(self, pool_size=(2,) * ndim if ndim > 1 else 2,
                 strides=None, padding=0, layout=layout, ceil_mode=False,
                 count_include_pad=True, **kwargs):
        _Pooling.__init__(
            self, _pair(pool_size, ndim),
            _pair(strides, ndim) if strides is not None else None,
            _pair(padding, ndim), ceil_mode, False, pool_type, layout,
            count_include_pad if pool_type == "avg" else None, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


def _global_pool_class(name, ndim, pool_type, layout):
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, (0,) * ndim, True, True,
                          pool_type, layout, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


MaxPool1D = _pool_class("MaxPool1D", 1, "max", "NCW")
MaxPool2D = _pool_class("MaxPool2D", 2, "max", "NCHW")
MaxPool3D = _pool_class("MaxPool3D", 3, "max", "NCDHW")
AvgPool1D = _pool_class("AvgPool1D", 1, "avg", "NCW")
AvgPool2D = _pool_class("AvgPool2D", 2, "avg", "NCHW")
AvgPool3D = _pool_class("AvgPool3D", 3, "avg", "NCDHW")
GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "max", "NCW")
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "max", "NCHW")
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "max", "NCDHW")
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "avg", "NCW")
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "avg", "NCHW")
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "avg", "NCDHW")
