"""`mx.nd` — the imperative NDArray namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``).

Creation helpers live here; every registered op is reachable as
``nd.<op name>`` through the same namespace ``hybrid_forward`` gets.
"""
from __future__ import annotations

import numbers

from .ndarray import (NDArray, array, concatenate, host_tensor, invoke,
                      ones, waitall, zeros)
from ..ops import F as _F

__all__ = ["NDArray", "array", "zeros", "ones", "invoke", "host_tensor",
           "concatenate", "waitall", "stack_list", "moveaxis", "maximum",
           "minimum"]


def stack_list(arrays, axis=0):
    return invoke("stack", list(arrays), {"axis": axis})


def moveaxis(data, source, destination):
    axes = list(range(data.ndim))
    axes.remove(source % data.ndim)
    axes.insert(destination % data.ndim, source % data.ndim)
    return data.transpose(axes)


def _minmax(lhs, rhs, name):
    """MXNet 1.x's ``nd.maximum``/``nd.minimum``: broadcasting between
    two arrays, or an array and a scalar."""
    if isinstance(lhs, numbers.Number):
        lhs, rhs = rhs, lhs
    if isinstance(rhs, numbers.Number):
        return invoke("_%s_scalar" % name, [lhs], {"scalar": float(rhs)})
    return invoke("broadcast_" + name, [lhs, rhs], {})


def maximum(lhs, rhs):
    return _minmax(lhs, rhs, "maximum")


def minimum(lhs, rhs):
    return _minmax(lhs, rhs, "minimum")


def __getattr__(name):
    return getattr(_F, name)
