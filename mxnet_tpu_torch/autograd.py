"""Autograd: recording scopes and backward (counterpart of
``mxnet_tpu/autograd.py``; ref: python/mxnet/autograd.py).

The tape is torch's. Every op runs through
:func:`mxnet_tpu_torch.ndarray.invoke`, which builds a graph only inside
``record()`` (outside it the op runs under ``torch.no_grad``), so
nothing is recorded unless the caller asks. A variable is an NDArray
whose tensor is a torch leaf that requires grad, marked by
``attach_grad`` or :func:`mark_variables` (a Parameter marks its data).

:func:`backward` asks ``torch.autograd.grad`` for the gradient of every
live variable and then writes or adds it into the variable's ``.grad``
by its ``grad_req``, as the reference does; torch's own ``.grad``
accumulation is never used, so ``write`` overwrites and ``add`` adds.
A variable the heads do not reach keeps its ``.grad`` as it was.

Ops whose reference backward is a Pallas kernel are
``torch.autograd.Function``s whose backward is the port's kernel
(``ops/cuda_*.py``). ``grad(create_graph=True)`` and
``autograd.Function`` wait for a later slice.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "mark_variables"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_rec: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(is_rec)
    return prev


def set_training(train_mode_: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(train_mode_)
    return prev


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with self.__class__(self._rec, self._train):
                return fn(*a, **kw)
        return wrapped


def record(train_mode: bool = True) -> _Scope:
    """Scope that records ops for :func:`backward` (train mode on by
    default)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Scope inside ``record()`` that records nothing."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


# every NDArray marked as a variable and still alive
_VARS: "weakref.WeakSet" = weakref.WeakSet()


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each of ``variables`` a leaf whose gradient goes to the
    matching NDArray of ``gradients`` (ref: autograd.mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        v._t = v._t.detach().requires_grad_(req != "null")
        v._grad = g
        v._grad_req = req
        if req == "null":
            _VARS.discard(v)
        else:
            _VARS.add(v)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every reachable variable's ``.grad``
    (ref: autograd.backward). A head gradient left out is ones of the
    head's shape, as in MXNet, whatever the head's size."""
    from .ndarray.ndarray import NDArray, to_tensor
    heads = [heads] if isinstance(heads, NDArray) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h.tensor()
        if not t.requires_grad:
            raise MXNetError(
                "cannot differentiate: output was not computed under "
                "autograd.record() from any array with attach_grad()")
        outs.append(t)
        cots.append(torch.ones_like(t) if hg is None
                    else to_tensor(hg).to(t.dtype))
    variables = [v for v in list(_VARS) if v._t.requires_grad]
    if not variables:
        return
    grads = torch.autograd.grad(outs, [v._t for v in variables], cots,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(variables, grads):
            if g is None:
                continue
            if v._grad_req == "write":
                v._grad.tensor().copy_(g)
            else:
                v._grad.tensor().add_(g.to(v._grad.dtype))
