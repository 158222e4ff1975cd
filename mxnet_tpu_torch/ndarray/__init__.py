"""`mx.nd` — the imperative NDArray namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``).

Creation helpers live here; every registered op is reachable as
``nd.<op name>`` through the same namespace ``hybrid_forward`` gets.
"""
from __future__ import annotations

from .ndarray import NDArray, array, host_tensor, invoke, ones, zeros
from ..ops import F as _F

__all__ = ["NDArray", "array", "zeros", "ones", "invoke", "host_tensor"]


def __getattr__(name):
    return getattr(_F, name)
