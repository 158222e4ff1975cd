"""Elementwise, scalar and broadcast operators (counterpart of
``mxnet_tpu/ops/elemwise.py``; ref: src/operator/tensor/elemwise_*).

MXNet semantics kept: ``broadcast_*`` applies numpy broadcasting; a
scalar operand takes the array's dtype before the op, as in the
reference. The unary family is the reference's table, one torch call
each (``gamma`` as ``exp(lgamma)`` and ``logical_not`` in the input's
dtype, as the reference computes them).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register


for _n, _f in {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
               "div": torch.div, "maximum": torch.maximum,
               "minimum": torch.minimum}.items():
    register("broadcast_" + _n)(_f)


def _make_scalar(opname, fn, reverse=False):
    def impl(data, *, scalar=0.0):
        # a fill, not a host-to-device copy: capture-safe
        s = torch.full((), scalar, dtype=data.dtype, device=data.device)
        return fn(s, data) if reverse else fn(data, s)
    impl.__name__ = opname
    return impl


for _n, _f, _r in [
        ("_plus_scalar", torch.add, False),
        ("_minus_scalar", torch.sub, False),
        ("_rminus_scalar", torch.sub, True),
        ("_mul_scalar", torch.mul, False),
        ("_div_scalar", torch.div, False),
        ("_rdiv_scalar", torch.div, True),
        ("_maximum_scalar", torch.maximum, False),
        ("_minimum_scalar", torch.minimum, False)]:
    register(_n)(_make_scalar(_n, _f, _r))


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "round": torch.round,
    "square": torch.square, "sqrt": torch.sqrt, "cbrt": _cbrt,
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "negative": torch.neg, "reciprocal": lambda x: 1.0 / x,
    "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "rsqrt": torch.rsqrt,
    "relu": torch.relu, "sigmoid": torch.sigmoid,
}


def _make_unary(opname, fn):
    def impl(data):
        return fn(data)
    impl.__name__ = opname
    impl.__doc__ = "Elementwise %s." % opname
    return impl


for _n, _f in _UNARY.items():
    register(_n)(_make_unary(_n, _f))

register("identity", aliases=["_copy"])(lambda data: data)


@register("Cast", aliases=["cast"])
def cast(data, *, dtype):
    return data.to(torch_dtype(dtype))


@register("amp_cast")
def amp_cast(data, *, dtype):
    """AMP's cast (ref: amp_cast.cc): unlike Cast, integer inputs pass
    through untouched."""
    if not data.is_floating_point():
        return data
    return data.to(torch_dtype(dtype))


@register("amp_multicast")
def amp_multicast(*data, num_outputs):
    """Every floating input cast to the widest floating dtype present
    (ref: amp_cast.cc :: AMPMultiCast)."""
    fl = [d.dtype for d in data if d.is_floating_point()]
    if not fl:
        return tuple(data)
    widest = max(fl, key=lambda d: d.itemsize)
    return tuple(d.to(widest) if d.is_floating_point() else d for d in data)
