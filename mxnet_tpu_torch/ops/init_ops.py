"""Creation operators (counterpart of ``mxnet_tpu/ops/init_ops.py``; ref:
src/operator/tensor/init_op.cc).

They take no input array: ``invoke`` hands each the ``torch.device`` of
the call's ``ctx`` (the current context by default) as ``_device``.
``nd.zeros`` and ``nd.ones`` call ``_zeros`` and ``_ones``.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


@register("_zeros", aliases=["zeros"], needs_device=True)
def zeros(*, shape, dtype="float32", _device=None):
    return torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                       device=_device)


@register("_ones", aliases=["ones"], needs_device=True)
def ones(*, shape, dtype="float32", _device=None):
    return torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                      device=_device)


@register("_full", aliases=["full"], needs_device=True)
def full(*, shape, value, dtype="float32", _device=None):
    return torch.full(_shape(shape), value, dtype=torch_dtype(dtype),
                      device=_device)


@register("_arange", aliases=["arange"], needs_device=True)
def arange(*, start=0, stop=None, step=1.0, repeat=1, dtype="float32",
           _device=None):
    """[start, stop) by ``step`` (``stop=None``: [0, start)), each value
    ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=_device)
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", aliases=["linspace"], needs_device=True)
def linspace(*, start, stop, num, endpoint=True, dtype="float32",
             _device=None):
    """``num`` points from start to stop (``endpoint``: stop included),
    computed as the reference computes them: start * (1 - s) + stop * s
    with s = i / (num - 1) (or i / num) in f32 (f64 for f64), floored
    for an integer dtype."""
    num = int(num)
    out_dtype = torch_dtype(dtype)
    acc = torch.float64 if out_dtype == torch.float64 else torch.float32
    div = num - 1 if endpoint else num
    step = torch.arange(num, dtype=acc, device=_device) / max(div, 1)
    out = torch.tensor(start, dtype=acc, device=_device) * (1 - step) \
        + torch.tensor(stop, dtype=acc, device=_device) * step
    if endpoint and num > 1:
        out[-1] = stop
    if not out_dtype.is_floating_point:
        out = torch.floor(out)
    return out.to(out_dtype)


@register("_eye", aliases=["eye"], needs_device=True)
def eye(*, N, M=0, k=0, dtype="float32", _device=None):
    """N x M (M=0: N x N) with ones on diagonal ``k``."""
    n = int(N)
    m = int(M) if M else n
    rows = torch.arange(n, device=_device).unsqueeze(1)
    cols = torch.arange(m, device=_device).unsqueeze(0)
    return (cols - rows == int(k)).to(torch_dtype(dtype))
