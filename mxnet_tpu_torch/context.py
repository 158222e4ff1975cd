"""Device contexts: ``mx.gpu(i)`` and ``mx.cpu()`` (counterpart of
``mxnet_tpu/context.py``; ref: python/mxnet/context.py).

A Context resolves to a ``torch.device``. The default context is
``gpu(0)``: on a machine without CUDA, resolving it raises
:class:`MXNetError`, so work lands on the CPU only when the caller asks
for ``mx.cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "context_of", "num_gpus", "device"]


class Context:
    """A device context; devtype in {'cpu', 'gpu', 'cpu_pinned'}."""

    _default = threading.local()
    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    def __init__(self, device_type: str = "cpu", device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.devtype2id:
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context. Raises for a GPU
        context on a machine without CUDA, or an id out of range."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s: no CUDA device is available; pass "
                "ctx=mx.cpu() to run on the CPU" % self)
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError("context %s out of range: %d CUDA device(s)"
                             % (self, n))
        return torch.device("cuda", self.device_id)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` in this context's memory: page-locked host
        memory for ``cpu_pinned`` (where a card can be reached), so
        that a copy to the card can run asynchronously."""
        out = t.to(self.torch_device, copy=True)
        if self.device_type == "cpu_pinned" and torch.cuda.is_available():
            out = out.pin_memory()
        return out

    def memory_info(self) -> dict:
        """Live tracked-NDArray footprint on this context: ``{"bytes",
        "count"}`` (counted while MXNET_TELEMETRY is on; see
        ``telemetry.memory_snapshot``)."""
        from . import telemetry
        return telemetry.ndarray_live(str(self))

    def __enter__(self):
        stack = getattr(Context._default, "stack", None)
        if stack is None:
            stack = Context._default.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()
        return False


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory (ref: context.py :: cpu_pinned)."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA cards this process sees."""
    return torch.cuda.device_count()


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return gpu(0)


def device(dev=None) -> Context:
    """``dev``, or the current context."""
    return dev if dev is not None else current_context()


def context_of(device: torch.device) -> Context:
    """The Context of a ``torch.device``."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    if device.type == "cpu":
        return cpu(0)
    raise MXNetError("no context for torch device %s" % device)
