"""Basic neural-net layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``; ref:
python/mxnet/gluon/nn/basic_layers.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "LayerNorm", "GroupNorm", "InstanceNorm", "Embedding", "Flatten",
           "Activation", "Lambda", "HybridLambda"]


class _Stack:
    """What both sequential containers share: ``add``, iteration,
    ``len`` and indexing (a slice is a new container of the same kind
    over the same blocks)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __iter__(self):
        return iter(self._children.values())

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers


class Sequential(_Stack, Block):
    """Stack of blocks run in order (ref: nn.Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x, *args):
        for block in self._children.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer (ref: nn.Dense → FullyConnected op).

    ``epilogue`` selects a fused Dense epilogue, served by the kernels
    of ops/cuda_epilogue.py:

    * ``"gelu"`` — the matmul feeds ``_contrib_bias_gelu`` (bias-add +
      exact GeLU in one pass) instead of the in-op bias add.
    * ``"residual"`` — the layer accepts an optional second input
      (``dense(x, residual)``) and feeds ``_contrib_bias_add_residual``.
      Called without a residual it behaves like a plain Dense.

    ``epilogue`` requires ``use_bias`` and excludes ``activation``.
    """

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, epilogue=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if epilogue is not None:
            if epilogue not in ("gelu", "residual"):
                raise ValueError("Dense: unknown epilogue %r" % (epilogue,))
            if not use_bias or activation is not None:
                raise ValueError(
                    "Dense: epilogue=%r requires use_bias=True and no "
                    "activation" % (epilogue,))
        self._epilogue = epilogue
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), init=bias_initializer, dtype=dtype,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x, *args):
        in_units = int(np.prod(x.shape[1:])) if self._flatten else x.shape[-1]
        self.weight._shape = (self._units, in_units)

    def hybrid_forward(self, F, x, residual=None, weight=None, bias=None):
        if self._epilogue != "residual":
            if residual is not None:
                # only the residual epilogue accepts a second input
                raise ValueError(
                    "Dense: a residual input requires "
                    "epilogue='residual' (got epilogue=%r)"
                    % (self._epilogue,))
        if self._epilogue == "gelu":
            y = F.FullyConnected(x, weight, None, no_bias=True,
                                 num_hidden=self._units,
                                 flatten=self._flatten)
            return F._contrib_bias_gelu(y, bias)
        if self._epilogue == "residual":
            if residual is not None:
                y = F.FullyConnected(x, weight, None, no_bias=True,
                                     num_hidden=self._units,
                                     flatten=self._flatten)
                return F._contrib_bias_add_residual(y, bias, residual)
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        shape = self.weight.shape
        return "Dense({0} -> {1}, {2})".format(
            shape[1] if shape[1] else None, shape[0],
            self.act if self.act else "linear")


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation({})".format(self._act_type)


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def __repr__(self):
        return "Dropout(p = {}, axes={})".format(self._rate, self._axes)


class BatchNorm(HybridBlock):
    """Batch norm with moving-statistic aux parameters (ref:
    nn.BatchNorm). The BatchNorm op writes the moving statistics back
    into ``running_mean`` and ``running_var`` in training mode."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                            "fix_gamma": not scale,
                            "use_global_stats": use_global_stats}
            self._axis = axis
            self._in_channels = in_channels
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_mean._is_aux = True
            self.running_var._is_aux = True

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._shape = (c,)

    def cast(self, dtype):
        if str(dtype) in ("float16", "bfloat16") or dtype in (
                torch.float16, torch.bfloat16):
            dtype = "float32"  # BN parameters and statistics stay f32
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        return "BatchNorm(axis={}, eps={}, momentum={}, in_channels={})" \
            .format(self._kwargs["axis"], self._kwargs["eps"],
                    self._kwargs["momentum"], self.gamma.shape[0])


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._axis = axis
            self._epsilon = epsilon
            self._in_channels = in_channels
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma._shape = (c,)
        self.beta._shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class _ChannelNorm(HybridBlock):
    """GroupNorm's and InstanceNorm's ``gamma`` and ``beta``, one per
    channel of axis 1."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix, params):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._epsilon = epsilon
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self.gamma._shape = (x.shape[1],)
        self.beta._shape = (x.shape[1],)


class GroupNorm(_ChannelNorm):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class InstanceNorm(_ChannelNorm):
    """Instance normalization; ``axis`` is accepted and, as in the
    reference, the channels are axis 1."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class Lambda(Block):
    """A block running ``function`` (or the ``nd`` function it names) on
    its inputs."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            function = getattr(nd_mod, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A hybrid block running ``function(F, x, *args)``, or the ``F`` op
    a string names on ``(x, *args)``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function
            self._func = None
        else:
            self._func = function
            self._func_name = function.__name__

    def hybrid_forward(self, F, x, *args):
        if self._func is None:
            return getattr(F, self._func_name)(x, *args)
        return self._func(F, x, *args)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Embedding(HybridBlock):
    """Token embedding (ref: nn.Embedding → Embedding op)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._input_dim = input_dim
            self._output_dim = output_dim
            self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                            "dtype": dtype, "sparse_grad": sparse_grad}
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "Embedding({} -> {}, {})".format(
            self._input_dim, self._output_dim, self._kwargs["dtype"])
