"""Elementwise, scalar and broadcast operators (counterpart of
``mxnet_tpu/ops/elemwise.py``; ref: src/operator/tensor/elemwise_*).

MXNet semantics kept: ``elemwise_*`` requires identical shapes;
``broadcast_*`` applies numpy broadcasting; a scalar operand takes the
array's dtype before the op, as in the reference; a comparison returns
0/1 in its first input's dtype; ``mod`` is the floored modulo (numpy's), an integer modulo by zero 0.
The unary family is the reference's table, one torch call
each (``gamma`` as ``exp(lgamma)`` and ``logical_not`` in the input's
dtype, as the reference computes them).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register


def float_in(x):
    """``x`` as f32 where it holds integers or booleans, else ``x``: the
    ops that the reference promotes (softmax, hypot, ...) compute there
    in f32 and return f32."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float32)


def mod(lhs, rhs):
    """The floored modulo; an integer modulo by zero answers 0, as
    ``jnp.mod`` does, with no host read (torch raises on the CPU)."""
    if lhs.is_floating_point() or rhs.is_floating_point():
        return torch.remainder(lhs, rhs)
    zero = rhs == 0
    safe = torch.where(zero, torch.ones_like(rhs), rhs)
    out = torch.remainder(lhs, safe)
    return torch.where(zero, torch.zeros_like(out), out)


def hypot(lhs, rhs):
    return torch.hypot(float_in(lhs), float_in(rhs))


_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "mod": mod, "power": torch.pow,
           "maximum": torch.maximum, "minimum": torch.minimum,
           "hypot": hypot}
_BINARY_CMP = {"equal": torch.eq, "not_equal": torch.ne,
               "greater": torch.gt, "greater_equal": torch.ge,
               "lesser": torch.lt, "lesser_equal": torch.le,
               "logical_and": torch.logical_and,
               "logical_or": torch.logical_or,
               "logical_xor": torch.logical_xor}


def _make_binary(opname, fn, cmp=False, same_shape=False):
    def impl(lhs, rhs):
        if same_shape and lhs.shape != rhs.shape:
            raise ValueError("%s requires identical shapes, got %s and %s"
                             % (opname, tuple(lhs.shape), tuple(rhs.shape)))
        out = fn(lhs, rhs)
        return out.to(lhs.dtype) if cmp else out
    impl.__name__ = opname
    return impl


_LEGACY_ALIAS = {"add": "_plus", "sub": "_minus", "mul": "_mul",
                 "div": "_div"}
for _n, _f in _BINARY.items():
    if _n in _LEGACY_ALIAS:
        register("elemwise_" + _n, aliases=[_LEGACY_ALIAS[_n]])(
            _make_binary("elemwise_" + _n, _f, same_shape=True))
    register("broadcast_" + _n)(_make_binary("broadcast_" + _n, _f))
for _n, _f in _BINARY_CMP.items():
    register("broadcast_" + _n)(_make_binary("broadcast_" + _n, _f, True))


def _make_scalar(opname, fn, reverse=False, cmp=False):
    def impl(data, *, scalar=0.0):
        # a fill, not a host-to-device copy: capture-safe
        s = torch.full((), scalar, dtype=data.dtype, device=data.device)
        out = fn(s, data) if reverse else fn(data, s)
        return out.to(data.dtype) if cmp else out
    impl.__name__ = opname
    return impl


for _n, _f, _r in [
        ("_plus_scalar", torch.add, False),
        ("_minus_scalar", torch.sub, False),
        ("_rminus_scalar", torch.sub, True),
        ("_mul_scalar", torch.mul, False),
        ("_div_scalar", torch.div, False),
        ("_rdiv_scalar", torch.div, True),
        ("_power_scalar", torch.pow, False),
        ("_rpower_scalar", torch.pow, True),
        ("_mod_scalar", mod, False),
        ("_rmod_scalar", mod, True),
        ("_maximum_scalar", torch.maximum, False),
        ("_minimum_scalar", torch.minimum, False)]:
    register(_n)(_make_scalar(_n, _f, _r))
for _n, _f in [("_equal_scalar", torch.eq), ("_not_equal_scalar", torch.ne),
               ("_greater_scalar", torch.gt),
               ("_greater_equal_scalar", torch.ge),
               ("_lesser_scalar", torch.lt),
               ("_lesser_equal_scalar", torch.le)]:
    register(_n)(_make_scalar(_n, _f, cmp=True))


def div_exact(x, d):
    """``x / d`` for a Python number ``d``, rounded as IEEE division on
    every device: CUDA divides by a host scalar as a product with its
    reciprocal, which can land a last bit away (and so flip a floor or
    a ceil that follows). ``d`` goes to the device as a 0-d tensor."""
    return x / torch.full((), d, dtype=x.dtype if x.is_floating_point()
                          else torch.get_default_dtype(), device=x.device)


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
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "softrelu": lambda x: torch.logaddexp(float_in(x),
                                          torch.zeros_like(float_in(x))),
    "log_sigmoid": lambda x: torch.nn.functional.logsigmoid(float_in(x)),
    "digamma": torch.digamma,
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
register("make_loss")(lambda data: data)
register("BlockGrad", aliases=["stop_gradient"])(lambda data: data.detach())


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("clip")
def clip(data, *, a_min, a_max):
    return torch.clamp(data, a_min, a_max)


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


@register("where")
def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


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
