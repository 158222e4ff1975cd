"""AMP — automatic mixed precision (counterpart of
``mxnet_tpu/contrib/amp/__init__.py``; ref: python/mxnet/contrib/amp/).

``init()`` installs a cast table that calls through ``F``/``nd``
consult (:func:`mxnet_tpu_torch.ops.set_casts`): the ops of
``FP16_FUNCS`` cast their floating inputs to the target dtype, those of
``FP32_FUNCS`` to float32, and those of ``WIDEST_TYPE_CASTS`` to the
widest floating dtype among them. The reference patches its ``nd``
module, which eager Gluon passes as ``F``; the port's ``F`` and ``nd``
are one namespace, so one table gives the same casts. NDArray operators
(``a + b``) go straight to ``invoke`` in both packages and are not
cast. A cast is an ``astype``, recorded like any op, so an f32
parameter gets an f32 gradient through low-precision compute. The
port's ``hybridize()`` runs eagerly, so a hybridized block is cast the
same way.

bfloat16 (the default) needs no loss scaling: ``init_trainer`` gives it
a static scaler at 1. float16 gets the dynamic :class:`LossScaler`
(2^16 to start).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from ...base import MXNetError, torch_dtype
from ...ndarray import NDArray
from ... import ops as _ops
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "reset", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_symbol", "is_initialized",
           "target_dtype", "LossScaler", "lists"]

_initialized = False
_target_dtype = "bfloat16"
_loss_scaler: Optional[LossScaler] = None


def _cast_input(arr, dtype: torch.dtype):
    if isinstance(arr, NDArray) and arr._tdtype.is_floating_point and \
            arr._tdtype != dtype:
        return arr.astype(dtype)
    return arr


def _to(dtype: torch.dtype):
    """Cast every floating NDArray input, positional or keyword."""
    def cast(inputs, attrs):
        return ([_cast_input(a, dtype) for a in inputs],
                {k: _cast_input(v, dtype) for k, v in attrs.items()})
    return cast


def _widest(inputs, attrs):
    """Cast the floating NDArray inputs to the widest of their dtypes
    (the first of equal width)."""
    dtypes = [a._tdtype for a in inputs
              if isinstance(a, NDArray) and a._tdtype.is_floating_point]
    if not dtypes:
        return inputs, attrs
    widest = max(dtypes, key=lambda d: d.itemsize)
    return [_cast_input(a, widest) for a in inputs], attrs


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on (ref: amp.init). ``conditional_fp32_ops`` entries are
    cast to f32 unconditionally, as in the reference. A second call
    changes nothing."""
    global _initialized, _target_dtype
    if _initialized:
        return
    if target_dtype not in ("float16", "bfloat16"):
        raise AssertionError("target_dtype must be float16 or bfloat16")
    _target_dtype = target_dtype
    cond = [c[0] if isinstance(c, (tuple, list)) else c
            for c in (conditional_fp32_ops or [])]
    lp, f32 = _to(torch_dtype(target_dtype)), _to(torch.float32)
    table, kinds = {}, {}
    # the reference patches each name once, low precision first
    for kind, names, fn in (
            ("low", list(lists.FP16_FUNCS) + list(target_precision_ops or
                                                  []), lp),
            ("f32", list(lists.FP32_FUNCS) + list(fp32_ops or []) + cond,
             f32),
            ("widest", lists.WIDEST_TYPE_CASTS, _widest)):
        for name in names:
            if name not in table:
                table[name], kinds[name] = fn, kind
    _ops.set_casts(table, key=(target_dtype, tuple(sorted(kinds.items()))))
    _initialized = True


def reset():
    """Turn AMP off again (a test helper in the reference too)."""
    global _initialized
    _ops.set_casts({})
    _initialized = False


def init_trainer(optimizer_or_trainer):
    """Give a Trainer its loss scaler (ref: amp.init_trainer): dynamic
    from 2^16 for float16, static at 1 for bfloat16."""
    global _loss_scaler
    if not _initialized:
        raise MXNetError("call amp.init() before amp.init_trainer()")
    fp16 = _target_dtype == "float16"
    _loss_scaler = LossScaler(init_scale=2.**16 if fp16 else 1.0,
                              dynamic=fp16)
    optimizer_or_trainer._amp_loss_scaler = _loss_scaler
    optimizer_or_trainer._amp_original_scale = optimizer_or_trainer._scale
    # a grad guard the Trainer resolved before this call drives this
    # scaler's backoff and growth (one code path with and without AMP)
    guard = getattr(optimizer_or_trainer, "_grad_guard", None)
    if guard is not None:
        guard.scaler = _loss_scaler
    return optimizer_or_trainer


@contextlib.contextmanager
def scale_loss(loss, optimizer_or_trainer):
    """Yield the loss times the loss scale and fold 1 / scale into the
    Trainer's gradient scale (ref: amp.scale_loss)."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    optimizer_or_trainer._scale = \
        optimizer_or_trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(optimizer_or_trainer):
    """Divide the Trainer's gradients by the loss scale and check them:
    on overflow a dynamic scaler halves its scale and zeroes them. The
    Trainer's gradient scale goes back to its value before
    ``scale_loss``, so the step does not divide a second time (MXNet's
    ``amp.unscale`` does this; the reference leaves it).

    A grad guard wired to this scaler that owns the overflow policy
    (``MXNET_GUARD_NONFINITE`` not ``off``) checks the gradients at
    ``step`` and backs the scale off or grows it there, once a step:
    here they are only divided. The restored scale is what the guard's
    clip then multiplies the norm by, so it clips the unscaled
    gradients' norm over the batch, as without AMP."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    grads: List[NDArray] = []
    for p in optimizer_or_trainer._params:
        if p.grad_req != "null" and p._grad is not None:
            grads.extend(p.list_grad())
    # the lazy property: on the first step the guard may not be resolved
    guard = getattr(optimizer_or_trainer, "grad_guard", None)
    if guard is not None and guard.scaler is scaler \
            and guard.nonfinite != "off":
        scaler.unscale(grads)
    else:
        scaler.unscale_and_check(grads)
    optimizer_or_trainer._scale = optimizer_or_trainer._amp_original_scale


def convert_model(net, target_dtype="bfloat16"):
    """Cast a model for low-precision inference (ref:
    amp.convert_model)."""
    net.cast(target_dtype)
    return net


def convert_symbol(sym, target_dtype=None, target_dtype_ops=None,
                   fp32_ops=None, widest_dtype_ops=None,
                   cast_optional_params=False):
    """The graph pass over a Symbol; the port has no ``symbol/``."""
    raise NotImplementedError(
        "amp.convert_symbol: the port has no symbol/ yet (ROADMAP.md "
        "queue 1, item 16); amp.init() casts eager and hybridized blocks "
        "alike")


def is_initialized() -> bool:
    return _initialized


def target_dtype() -> str:
    return _target_dtype
