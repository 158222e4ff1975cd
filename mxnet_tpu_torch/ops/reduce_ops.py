"""Reductions, the subset the training slice runs (counterpart of
``mxnet_tpu/ops/reduce_ops.py``; ref:
src/operator/tensor/broadcast_reduce_op_value.cc).

MXNet-1.x semantics kept: a full reduction (axis=None, keepdims=False)
returns shape ``(1,)``, not a 0-d scalar, and ``exclude=True`` reduces
over every axis but the given ones.
"""
from __future__ import annotations

import torch

from . import register


def _axes(data, axis, exclude):
    if axis is None or axis == () or axis == []:
        return None
    ax = tuple(int(a) % data.dim() for a in (
        axis if isinstance(axis, (list, tuple)) else (axis,)))
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


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


register("sum", aliases=["sum_axis"])(_make_reduce("sum", torch.sum))
register("mean", aliases=["mean_axis"])(_make_reduce("mean", torch.mean))


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    """L1 or L2 norm over ``axis`` (all axes by default): squares in the
    data's dtype, the sum taken in f32 and rounded to the data's dtype,
    the root in it (jnp.linalg.norm's rounding); a full reduction
    returns (1,)."""
    ax = _axes(data, axis, False)
    kw = {} if ax is None else {"dim": ax, "keepdim": bool(keepdims)}
    if ord == 1:
        out = data.abs().sum(dtype=torch.float32, **kw).to(data.dtype)
    elif ord == 2:
        out = torch.sqrt((data * data).sum(dtype=torch.float32, **kw)
                         .to(data.dtype))
    else:
        raise ValueError("norm only supports ord=1 or 2")
    if ax is None:
        out = out.reshape((1,) * data.dim() if keepdims else (1,))
    return out
