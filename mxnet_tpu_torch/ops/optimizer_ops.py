"""Optimizer-update operators, the subset the Trainer's aggregated path
runs for SGD and LAMB (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``;
ref: src/operator/optimizer_op.cc, contrib/multi_lamb.cc).

The reference computes these in XLA, outside any Pallas kernel, so here
they are plain PyTorch elementwise code. Each returns the new weight
first, then the new states, and leaves its inputs alone; the optimizer
writes the results into the weight and state tensors in place.

The dtype chain is the reference's, operation by operation. A Python
float hyperparameter is weakly typed in JAX: it takes the tensor's dtype
before the operation (``beta1 * m`` multiplies a bf16 ``m`` by beta1
rounded to bf16, and stays bf16). Torch would use the float at full
precision, so :func:`_weak` rounds it first. A
per-tensor hyperparameter that the reference carries as an f32 device
array (``lrs``/``wds`` of the preloaded SGD ops, ``lr``/``wd``/``t`` and
``rescale_grad`` of the LAMB runner) promotes a bf16 operand to f32
there, so the port widens that operand to f32 explicitly: torch would
otherwise keep bf16. The results therefore come back in f32 where the
reference's do; LAMB casts the new w, m and v back to their own dtypes,
as the reference does.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import register

_F32 = np.float32


def _f32(x) -> float:
    """A Python float holding the f32 value of ``x`` (how the reference
    sees a hyperparameter it carries as an f32 array)."""
    return float(_F32(x))


def _weak(v, t: torch.Tensor) -> float:
    """Python float ``v`` as JAX applies it to ``t``: rounded to t's
    dtype."""
    if t.dtype in (torch.float32, torch.float64):
        return v
    return torch.tensor(v, dtype=t.dtype).item()


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad * _weak(rescale_grad, grad)
    if clip_gradient is not None and clip_gradient >= 0:
        c = _weak(clip_gradient, g)
        g = g.clamp(-c, c)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return _rescale_clip(grad, rescale_grad, clip_gradient) + \
        _weak(wd, weight) * weight


@register("sgd_update")
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w - lr * (rescale * g + wd * w), in w's dtype."""
    return weight - _weak(lr, weight) * _apply_wd(grad, weight, wd,
                                                  rescale_grad, clip_gradient)


@register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom' = momentum * mom - lr * g; w' = w + mom'."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = _weak(momentum, mom) * mom - _weak(lr, g) * g
    return weight + new_mom, new_mom


def _preloaded_wd(grad, weight, wd, rescale_grad, clip_gradient):
    """The reference's ``_apply_wd`` with ``wd`` an f32 array element:
    the rescaled gradient stays in its dtype, ``wd * w`` and the sum are
    f32."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return g.float() + wd * weight.float()


@register("preloaded_multi_sgd_update")
def preloaded_multi_sgd_update(*arrays, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=1):
    """multi_sgd_update with lrs/wds as f32 tensors (the last two
    inputs); arrays = [w0, g0, w1, g1, ..., lrs, wds]. The new weights
    are f32, as in the reference."""
    n = int(num_weights)
    lrs, wds = arrays[2 * n], arrays[2 * n + 1]
    outs = []
    for i in range(n):
        w, g = arrays[2 * i], arrays[2 * i + 1]
        gg = _preloaded_wd(g, w, wds[i], rescale_grad, clip_gradient)
        outs.append(w.float() - lrs[i] * gg)
    return tuple(outs) if n > 1 else outs[0]


@register("preloaded_multi_sgd_mom_update")
def preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1):
    """arrays = [w0, g0, m0, w1, ..., lrs, wds]; returns (w0', ...,
    m0', ...), f32 as in the reference."""
    n = int(num_weights)
    lrs, wds = arrays[3 * n], arrays[3 * n + 1]
    ws, ms = [], []
    for i in range(n):
        w, g, m = arrays[3 * i:3 * i + 3]
        gg = _preloaded_wd(g, w, wds[i], rescale_grad, clip_gradient)
        nm = _weak(momentum, m) * m - lrs[i] * gg
        ms.append(nm)
        ws.append(w.float() + nm)
    return tuple(ws + ms)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm of the flattened x: squares in x's dtype, the sum
    taken in f32 and rounded to x's dtype, the root in x's dtype."""
    return torch.sqrt((x * x).sum(dtype=torch.float32).to(x.dtype))


def _lamb_one(w, g, m, v, lr, wd, beta1, beta2, epsilon, t,
              bias_correction, rescale_grad, clip_gradient, lower_bound,
              upper_bound):
    """One tensor of the reference's ``_lamb_one``; lr, wd, t and
    rescale_grad are f32 there, beta1, beta2 and epsilon weak floats."""
    g = g.float() * _f32(rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    new_m = _weak(beta1, m) * m + (1 - beta1) * g
    new_v = _weak(beta2, v) * v + (1 - beta2) * g.square()
    mh, vh = new_m, new_v
    if bias_correction:
        mh = mh / _f32(_F32(1) - _F32(beta1) ** _F32(t))
        vh = vh / _f32(_F32(1) - _F32(beta2) ** _F32(t))
    upd = mh / (vh.sqrt() + epsilon) + _f32(wd) * w.float()
    r1 = _norm(w)
    if lower_bound is not None and lower_bound >= 0:
        r1 = r1.clamp_min(_weak(lower_bound, r1))
    if upper_bound is not None and upper_bound >= 0:
        r1 = r1.clamp_max(_weak(upper_bound, r1))
    r2 = _norm(upd)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1.float() / r2,
                        torch.ones_like(r2))
    return w.float() - _f32(lr) * ratio * upd, new_m, new_v


def _per_tensor(v, n) -> Sequence:
    if isinstance(v, (int, float)):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 and n > 1 else v


@register("_multi_lamb_update", aliases=["multi_lamb_update"])
def multi_lamb_update(*arrays, learning_rates, wds, beta1=0.9, beta2=0.999,
                      epsilon=1e-6, step_count=(1,), bias_correction=True,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lower_bound=-1.0, upper_bound=-1.0, num_tensors=1):
    """Multi-tensor LAMB (ref: contrib/multi_lamb.cc); arrays = [w0, g0,
    m0, v0, w1, ...]. Returns (w0', ..., m0', ..., v0', ...), each cast
    back to its input's dtype."""
    n = int(num_tensors)
    lrs = _per_tensor(learning_rates, n)
    wds_t = _per_tensor(wds, n)
    ts = _per_tensor(step_count, n)
    ws, ms, vs = [], [], []
    for i in range(n):
        w, g, m, v = arrays[4 * i:4 * i + 4]
        nw, nm, nv = _lamb_one(w, g, m, v, lrs[i], wds_t[i], beta1, beta2,
                               epsilon, ts[i], bias_correction,
                               rescale_grad, clip_gradient, lower_bound,
                               upper_bound)
        ws.append(nw.to(w.dtype))
        ms.append(nm.to(m.dtype))
        vs.append(nv.to(v.dtype))
    return tuple(ws + ms + vs)
