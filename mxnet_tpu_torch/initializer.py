"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``; ref:
python/mxnet/initializer.py).

Every random draw takes an explicit ``torch.Generator``: the one given
to the initializer, else the generator of the array's context from
:func:`mxnet_tpu_torch.random.generator`. Nothing draws from torch's
global generator.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch

from .base import MXNetError
from . import random as _random

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "create", "register", "InitDesc"]

_REG: Dict[str, type] = {}


def register(cls=None, *, name: Optional[str] = None):
    """Class decorator registering an initializer under its lowercased
    name (or ``name``)."""
    def _reg(c):
        _REG[(name or c.__name__).lower()] = c
        return c
    return _reg(cls) if cls is not None else _reg


class InitDesc(str):
    """A parameter's name with its attributes, as initializers receive
    it (ref: InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Fills an NDArray in place, dispatching on the parameter name's
    suffix as the reference does. ``generator`` overrides the context's
    generator for random draws."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 **kwargs):
        self._kwargs = kwargs
        self._generator = generator

    def __call__(self, name: str, arr):
        self._init_impl(str(name), arr)

    def _gen(self, arr) -> torch.Generator:
        return self._generator or _random.generator(arr.context)

    def _init_impl(self, name, arr):
        if name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(name, arr)
        else:
            self._init_weight(name, arr)

    def _init_zero(self, _, arr):
        arr.tensor().zero_()

    def _init_one(self, _, arr):
        arr.tensor().fill_(1.0)

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __eq__(self, other):
        return (isinstance(other, Initializer)
                and self.__class__ == other.__class__
                and self._kwargs == other._kwargs)

    __hash__ = object.__hash__


@register(name="zeros")
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr.tensor().zero_()


@register(name="ones")
class One(Initializer):
    def _init_weight(self, _, arr):
        arr.tensor().fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr.tensor().fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale) (ref: initializer.py :: Uniform)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr.tensor().uniform_(-self.scale, self.scale,
                              generator=self._gen(arr))


@register
class Normal(Initializer):
    """N(0, sigma^2) (ref: initializer.py :: Normal)."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr.tensor().normal_(0.0, self.sigma, generator=self._gen(arr))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal matrix (ref: initializer.py ::
    Orthogonal): the left or right singular vectors of a (rows, rest)
    draw, uniform in [-1, 1] or standard normal (``rand_type``), in
    float64 as the reference draws."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:]) if len(arr.shape) > 1 else 1
        tmp = torch.empty((nout, nin), dtype=torch.float64,
                          device=arr.tensor().device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=self._gen(arr))
        else:
            tmp.normal_(0.0, 1.0, generator=self._gen(arr))
        u, _, v = torch.linalg.svd(tmp.cpu(), full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.tensor().copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot (ref: initializer.py :: Xavier): scale
    sqrt(magnitude / factor) from the fans of the weight's shape, drawn
    uniform in [-scale, scale] or normal with that deviation."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2, got %s for %s"
                             % (shape, name))
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        t = arr.tensor()
        if self.rnd_type == "uniform":
            t.uniform_(-scale, scale, generator=self._gen(arr))
        elif self.rnd_type == "gaussian":
            t.normal_(0.0, scale, generator=self._gen(arr))
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He initialization for PReLU slope ``slope`` (ref: initializer.py
    :: MSRAPrelu): gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling weights for a (C, 1, k, k) deconvolution
    kernel (ref: initializer.py :: Bilinear), computed as the reference
    computes them in float32."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))) \
            .astype(np.float32).reshape(shape)
        arr.tensor().copy_(torch.from_numpy(weight))


@register
class LSTMBias(Initializer):
    """Zero biases with the forget gate's quarter at ``forget_bias``
    (ref: initializer.py :: LSTMBias; gates [i, f, g, o])."""

    def __init__(self, forget_bias=1.0, generator=None):
        super().__init__(generator, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        t = arr.tensor()
        t.zero_()
        num_hidden = arr.shape[0] // 4
        t[num_hidden:2 * num_hidden] = self.forget_bias

    _init_bias = _init_weight


class Mixed:
    """The initializer of the first pattern (a regular expression) that
    matches the start of a parameter's name (ref: initializer.py ::
    Mixed)."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError("parameter %s did not match any pattern" % name)


def create(name, **kwargs) -> Initializer:
    """An initializer from an instance (or a ``Mixed``) or a registered
    name."""
    if isinstance(name, (Initializer, Mixed)):
        return name
    cls = _REG.get(str(name).lower())
    if cls is None:
        raise MXNetError("Cannot find initializer %r. Registered: %s"
                         % (name, sorted(_REG)))
    return cls(**kwargs)
