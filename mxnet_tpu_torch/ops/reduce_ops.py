"""Reductions and orderings (counterpart of
``mxnet_tpu/ops/reduce_ops.py``; ref:
src/operator/tensor/broadcast_reduce_op_value.cc, ordering_op.cc,
broadcast_reduce_op_index.cc).

MXNet-1.x semantics kept: a full reduction (axis=None, keepdims=False)
returns shape ``(1,)``, not a 0-d scalar, and ``exclude=True`` reduces
over every axis but the given ones. ``argmax``/``argmin`` and the
indices of ``topk``/``argsort`` are float32 unless asked otherwise;
sorts are stable, and a descending sort is the ascending one reversed,
as the reference computes it; ``topk`` puts the lowest index first
among equal values, as ``lax.top_k`` does. Integer sums and products
keep the reference's dtype (int32, or uint32 for unsigned data), and
the mean of integers is f32.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register
from .elemwise import float_in


def _axes(data, axis, exclude):
    if axis is None or axis == () or axis == []:
        return None
    ax = tuple(int(a) % data.dim() for a in (
        axis if isinstance(axis, (list, tuple)) else (axis,)))
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


_UNSIGNED = (torch.uint8, torch.bool)


def _int_acc(fn):
    """``fn`` over integer data accumulated in int64 and returned as
    ``jnp``'s accumulator dtype: int32, or uint32 for unsigned data."""
    def run(data, *a, **kw):
        if data.is_floating_point() or data.is_complex():
            return fn(data, *a, **kw)
        out_dtype = torch.uint32 if data.dtype == torch.uint8 \
            else torch.int32
        return fn(data.to(torch.int64), *a, **kw).to(out_dtype)
    return run


def _mean(data, *a, **kw):
    return torch.mean(float_in(data), *a, **kw)


def _make_reduce(opname, fn):
    def impl(data, *, axis=None, keepdims=False, exclude=False):
        ax = _axes(data, axis, exclude)
        if ax is None:
            out = fn(data)
            return out.reshape((1,) * data.dim() if keepdims else (1,))
        if not ax:          # exclude=True over every axis: nothing left
            return data
        return fn(data, dim=ax, keepdim=bool(keepdims))
    impl.__name__ = opname
    impl.__doc__ = "Reduce-%s over the given axes (MXNet semantics)." % opname
    return impl


def _prod(data, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(data)
    for a in sorted(dim, reverse=True):
        data = torch.prod(data, dim=a, keepdim=keepdim)
    return data


def _nanprod(data, dim=None, keepdim=False):
    return _prod(torch.where(torch.isnan(data), torch.ones_like(data), data),
                 dim, keepdim)


def _nansum(data, dim=None, keepdim=False):
    if not data.is_floating_point():
        return torch.sum(data, dim=dim, keepdim=keepdim)
    return torch.nansum(data, dim=dim, keepdim=keepdim)


register("sum", aliases=["sum_axis"])(_make_reduce("sum", _int_acc(torch.sum)))
register("mean", aliases=["mean_axis"])(_make_reduce("mean", _mean))
register("prod")(_make_reduce("prod", _int_acc(_prod)))
register("nansum")(_make_reduce("nansum", _int_acc(_nansum)))
register("nanprod")(_make_reduce("nanprod", _int_acc(_nanprod)))
register("max", aliases=["max_axis"])(_make_reduce("max", torch.amax))
register("min", aliases=["min_axis"])(_make_reduce("min", torch.amin))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        out = out.reshape((1,) * data.dim() if keepdims else (1,))
    else:
        out = fn(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, *, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


@register("topk")
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """Top-k along an axis (ref: ordering_op.cc :: TopK); ``axis=None``
    takes the top k of the flattened array, as MXNet 1.x does (the
    reference answers along the last axis), its indices positions in the
    flattened array."""
    if axis is None:
        data, axis = data.reshape(-1), -1
    ax = int(axis) % data.dim()
    # a stable sort sliced to k: ties keep the lowest index first, as
    # lax.top_k does (torch.topk orders ties otherwise)
    vals, idx = torch.sort(data.movedim(ax, -1), dim=-1,
                           descending=not is_ascend, stable=True)
    vals = vals[..., :int(k)].movedim(-1, ax)
    idx = idx[..., :int(k)].movedim(-1, ax).to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    if ret_typ == "both":
        return vals, idx
    raise ValueError("unsupported ret_typ %r" % ret_typ)


@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    if axis is None:
        data, axis = data.reshape(-1), -1
    out = torch.sort(data, dim=int(axis), stable=True).values
    return out if is_ascend else torch.flip(out, (int(axis),))


@register("argsort")
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    if axis is None:
        data, axis = data.reshape(-1), -1
    idx = torch.argsort(data, dim=int(axis), stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (int(axis),))
    return idx.to(torch_dtype(dtype))


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    """L1 or L2 norm over ``axis`` (all axes by default): squares in the
    data's dtype, the sum taken in f32 and rounded to the data's dtype,
    the root in it (jnp.linalg.norm's rounding); a full reduction
    returns (1,). The L1 norm of integers is an integer sum; their L2
    norm is computed in f32 (the reference squares uint8 in uint8 and
    wraps)."""
    ax = _axes(data, axis, False)
    kw = {} if ax is None else {"dim": ax, "keepdim": bool(keepdims)}
    if ord == 1 and not data.is_floating_point():
        out = _int_acc(torch.sum)(data.abs(), **kw)
    elif ord == 1:
        out = data.abs().sum(dtype=torch.float32, **kw).to(data.dtype)
    elif ord == 2:
        data = float_in(data)
        out = torch.sqrt((data * data).sum(dtype=torch.float32, **kw)
                         .to(data.dtype))
    else:
        raise ValueError("norm only supports ord=1 or 2")
    if ax is None:
        out = out.reshape((1,) * data.dim() if keepdims else (1,))
    return out
