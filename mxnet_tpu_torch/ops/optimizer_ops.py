"""Optimizer-update operators of SGD, LAMB, Adam and AdamW, with their
multi-tensor and multi-precision (``mp_``, f32 master weight) forms,
those of NAG, RMSProp (plain and centered), Ftrl, SignSGD, FTML and
grouped AdaGrad, ``multi_all_finite`` for the AMP loss scaler, and the
multi-tensor norms and LARS scaling (counterpart of
``mxnet_tpu/ops/optimizer_ops.py``; ref: src/operator/optimizer_op.cc,
contrib/multi_lamb.cc, contrib/adamw.cc, contrib/multi_lars.cc). The
reference's ``_sparse_adagrad_update`` waits with ``ndarray/sparse.py``
(ROADMAP.md queue 1, item 16).

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
reference's do; the multi-tensor LAMB, Adam and AdamW cast the new w, m
and v back to their own dtypes, as the reference does. An ``mp_`` op
takes the f32 master after the weight's states and returns the new
weight in the weight's dtype beside the new master.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import register
from .elemwise import float_in
from .reduce_ops import norm

_F32 = np.float32


def _f32(x) -> float:
    """A Python float holding the f32 value of ``x`` (how the reference
    sees a hyperparameter it carries as an f32 array)."""
    return float(_F32(x))


def _weak(v, t: torch.Tensor) -> float:
    """Python float ``v`` as JAX applies it to ``t``: rounded to t's
    dtype. A tensor (a hyperparameter staged on the device, already in
    t's dtype) passes through."""
    if isinstance(v, torch.Tensor) or t.dtype in (torch.float32,
                                                  torch.float64):
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
    r1 = norm(w).reshape(())
    if lower_bound is not None and lower_bound >= 0:
        r1 = r1.clamp_min(_weak(lower_bound, r1))
    if upper_bound is not None and upper_bound >= 0:
        r1 = r1.clamp_max(_weak(upper_bound, r1))
    r2 = norm(upd).reshape(())
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


# ---------------------------------------------------------------------------
# multi-precision SGD: the update on the f32 master, the gradient widened
# ---------------------------------------------------------------------------
@register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Returns (w', w32')."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """Returns (w', mom', w32')."""
    g = _apply_wd(grad.float(), weight32, wd, rescale_grad, clip_gradient)
    new_mom = _weak(momentum, mom) * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def _mp_sgd_multi(arrays, per, n, lrs, wds, momentum, rescale_grad,
                  clip_gradient):
    """arrays = [w, g, (m,) w32] per tensor; returns (w'..., (m'...,)
    w32'...)."""
    ws, ms, w32s = [], [], []
    for i in range(n):
        grp = arrays[per * i:per * i + per]
        w, g, w32 = grp[0], grp[1], grp[-1]
        gg = _apply_wd(g.float(), w32, wds[i], rescale_grad, clip_gradient)
        if per == 4:
            nm = _weak(momentum, grp[2]) * grp[2] - lrs[i] * gg
            ms.append(nm)
            nw32 = w32 + nm
        else:
            nw32 = w32 - lrs[i] * gg
        ws.append(nw32.to(w.dtype))
        w32s.append(nw32)
    return tuple(ws + ms + w32s)


@register("multi_mp_sgd_update")
def multi_mp_sgd_update(*arrays, lrs, wds, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    """arrays = [w0, g0, w32_0, ...]; returns (w'..., w32'...)."""
    n = int(num_weights)
    return _mp_sgd_multi(arrays, 3, n, _per_tensor(lrs, n),
                         _per_tensor(wds, n), 0.0, rescale_grad,
                         clip_gradient)


@register("multi_mp_sgd_mom_update")
def multi_mp_sgd_mom_update(*arrays, lrs, wds, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """arrays = [w0, g0, m0, w32_0, ...]; returns (w'..., m'...,
    w32'...)."""
    n = int(num_weights)
    return _mp_sgd_multi(arrays, 4, n, _per_tensor(lrs, n),
                         _per_tensor(wds, n), momentum, rescale_grad,
                         clip_gradient)


@register("preloaded_multi_mp_sgd_update")
def preloaded_multi_mp_sgd_update(*arrays, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=1):
    """multi_mp_sgd_update with lrs/wds as f32 tensors (the last two
    inputs)."""
    n = int(num_weights)
    return _mp_sgd_multi(arrays, 3, n, arrays[3 * n], arrays[3 * n + 1], 0.0,
                         rescale_grad, clip_gradient)


@register("preloaded_multi_mp_sgd_mom_update")
def preloaded_multi_mp_sgd_mom_update(*arrays, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0,
                                      num_weights=1):
    """multi_mp_sgd_mom_update with lrs/wds as f32 tensors (the last
    two inputs)."""
    n = int(num_weights)
    return _mp_sgd_multi(arrays, 4, n, arrays[4 * n], arrays[4 * n + 1],
                         momentum, rescale_grad, clip_gradient)


# ---------------------------------------------------------------------------
# LAMB's two phases (the one-tensor update): phase 1 the moments and the
# update direction, phase 2 the step scaled by ||w|| / ||update||
# ---------------------------------------------------------------------------
@register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, *, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    """Returns (update, mean', var')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_mean = _weak(beta1, mean) * mean + _weak(1 - beta1, g) * g
    new_var = _weak(beta2, var) * var + _weak(1 - beta2, g) * g.square()
    m, v = new_mean, new_var
    if bias_correction:
        m = m / _weak(1 - beta1 ** t, m)
        v = v / _weak(1 - beta2 ** t, v)
    update = m / (v.sqrt() + _weak(epsilon, v)) + _weak(wd, weight) * weight
    return update, new_mean, new_var


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """w - lr * (r1 / r2) * update, the ratio 1 where a norm is 0; r1
    clamped to the bounds given (>= 0)."""
    r1v, r2v = r1.reshape(()), r2.reshape(())
    if lower_bound is not None and lower_bound >= 0:
        r1v = r1v.clamp_min(_weak(lower_bound, r1v))
    if upper_bound is not None and upper_bound >= 0:
        r1v = r1v.clamp_max(_weak(upper_bound, r1v))
    ratio = torch.where((r1v > 0) & (r2v > 0), r1v / r2v,
                        torch.ones_like(r2v))
    return weight - _weak(lr, ratio) * ratio * g_update


@register("mp_lamb_update_phase1")
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, *, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    """Phase 1 on the f32 master; returns (update, mean', var')."""
    return lamb_update_phase1(weight32, grad.float(), mean, var, beta1=beta1,
                              beta2=beta2, epsilon=epsilon, t=t,
                              bias_correction=bias_correction, wd=wd,
                              rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)


@register("mp_lamb_update_phase2")
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, *, lr,
                          lower_bound=-1.0, upper_bound=-1.0):
    """Phase 2 on the f32 master; returns (w', w32')."""
    new_w32 = lamb_update_phase2(weight32, g_update, r1, r2, lr=lr,
                                 lower_bound=lower_bound,
                                 upper_bound=upper_bound)
    return new_w32.to(weight.dtype), new_w32


@register("_multi_mp_lamb_update", aliases=["multi_mp_lamb_update"])
def multi_mp_lamb_update(*arrays, learning_rates, wds, beta1=0.9,
                         beta2=0.999, epsilon=1e-6, step_count=(1,),
                         bias_correction=True, rescale_grad=1.0,
                         clip_gradient=-1.0, lower_bound=-1.0,
                         upper_bound=-1.0, num_tensors=1):
    """Multi-tensor LAMB on f32 masters; arrays = [w0, g0, m0, v0,
    w32_0, w1, ...]. Returns (w'..., m'..., v'..., w32'...)."""
    n = int(num_tensors)
    lrs = _per_tensor(learning_rates, n)
    wds_t = _per_tensor(wds, n)
    ts = _per_tensor(step_count, n)
    ws, ms, vs, w32s = [], [], [], []
    for i in range(n):
        w, g, m, v, w32 = arrays[5 * i:5 * i + 5]
        nw32, nm, nv = _lamb_one(w32, g, m, v, lrs[i], wds_t[i], beta1,
                                 beta2, epsilon, ts[i], bias_correction,
                                 rescale_grad, clip_gradient, lower_bound,
                                 upper_bound)
        ws.append(nw32.to(w.dtype))
        ms.append(nm.to(m.dtype))
        vs.append(nv.to(v.dtype))
        w32s.append(nw32)
    return tuple(ws + ms + vs + w32s)


# ---------------------------------------------------------------------------
# Adam and AdamW (bias correction folded into lr by the optimizer)
# ---------------------------------------------------------------------------
def _moments(g, mean, var, beta1, beta2):
    new_mean = _weak(beta1, mean) * mean + _weak(1 - beta1, g) * g
    new_var = _weak(beta2, var) * var + _weak(1 - beta2, g) * g.square()
    return new_mean, new_var


@register("adam_update")
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Returns (w', mean', var')."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mean, new_var = _moments(g, mean, var, beta1, beta2)
    new_w = weight - _weak(lr, new_mean) * new_mean / (
        new_var.sqrt() + _weak(epsilon, new_var))
    return new_w, new_mean, new_var


def _adamw_step(weight, grad, mean, var, rs, lr, beta1, beta2, epsilon, wd,
                eta, clip_gradient):
    g = grad * (rs if isinstance(rs, torch.Tensor) else _weak(rs, grad))
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-_weak(clip_gradient, g), _weak(clip_gradient, g))
    new_mean, new_var = _moments(g, mean, var, beta1, beta2)
    step = _weak(lr, new_mean) * new_mean / (
        new_var.sqrt() + _weak(epsilon, new_var))
    new_w = weight - _weak(eta, step) * (step + _weak(wd, weight) * weight)
    return new_w, new_mean, new_var


@register("adamw_update", aliases=["_adamw_update"])
def adamw_update(weight, grad, mean, var, rescale_grad_t=None, *, lr,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0, rescale_grad=1.0):
    """AdamW, decoupled weight decay (ref: contrib/adamw.cc); an optional
    tensor rescale_grad_t takes rescale_grad's place. Returns (w',
    mean', var')."""
    rs = rescale_grad_t if rescale_grad_t is not None else rescale_grad
    return _adamw_step(weight, grad, mean, var, rs, lr, beta1, beta2,
                       epsilon, wd, eta, clip_gradient)


@register("_mp_adamw_update", aliases=["mp_adamw_update"])
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad_t=None,
                    *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    eta=1.0, clip_gradient=-1.0, rescale_grad=1.0):
    """AdamW on the f32 master; returns (w', mean', var', w32')."""
    rs = rescale_grad_t if rescale_grad_t is not None else rescale_grad
    new_w32, new_mean, new_var = _adamw_step(
        weight32, grad.float(), mean, var, rs, lr, beta1, beta2, epsilon,
        wd, eta, clip_gradient)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


def _adamish_one(w, g, m, v, lr, wd, eta, beta1, beta2, epsilon,
                 rescale_grad, clip_gradient, decoupled):
    """One tensor of the reference's ``_adamish_one``; lr, wd and
    rescale_grad are f32 there, the rest weak floats."""
    g = g.float() * _f32(rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if not decoupled:
        g = g + _f32(wd) * w.float()
    nm, nv = _moments(g, m, v, beta1, beta2)
    step = _f32(lr) * nm / (nv.sqrt() + epsilon)
    if decoupled:
        step = eta * (step + _f32(wd) * w.float())
    return w.float() - step, nm, nv


def _multi_adamish(arrays, stride, learning_rates, wds, etas, beta1, beta2,
                   epsilon, rescale_grad, clip_gradient, num_tensors,
                   decoupled):
    n = int(num_tensors)
    lrs = _per_tensor(learning_rates, n)
    wds_t = _per_tensor(wds, n)
    eta_t = _per_tensor(etas, n)
    ws, ms, vs, w32s = [], [], [], []
    for i in range(n):
        grp = arrays[stride * i:stride * i + stride]
        w, g, m, v = grp[:4]
        master = grp[4] if stride == 5 else w
        nw, nm, nv = _adamish_one(master, g, m, v, lrs[i], wds_t[i],
                                  eta_t[i], beta1, beta2, epsilon,
                                  rescale_grad, clip_gradient, decoupled)
        ws.append(nw.to(w.dtype))
        ms.append(nm.to(m.dtype))
        vs.append(nv.to(v.dtype))
        if stride == 5:
            w32s.append(nw)
    return tuple(ws + ms + vs + w32s)


@register("multi_adam_update")
def multi_adam_update(*arrays, learning_rates, wds, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
                      num_tensors=1):
    """Multi-tensor Adam, bias correction pre-folded into the lrs;
    arrays = [w0, g0, m0, v0, ...]; returns (w'..., m'..., v'...)."""
    return _multi_adamish(arrays, 4, learning_rates, wds, 1.0, beta1, beta2,
                          epsilon, rescale_grad, clip_gradient, num_tensors,
                          decoupled=False)


@register("multi_mp_adam_update")
def multi_mp_adam_update(*arrays, learning_rates, wds, beta1=0.9,
                         beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                         clip_gradient=-1.0, num_tensors=1):
    """arrays = [w0, g0, m0, v0, w32_0, ...]; returns (w'..., m'...,
    v'..., w32'...)."""
    return _multi_adamish(arrays, 5, learning_rates, wds, 1.0, beta1, beta2,
                          epsilon, rescale_grad, clip_gradient, num_tensors,
                          decoupled=False)


@register("_multi_adamw_update", aliases=["multi_adamw_update"])
def multi_adamw_update(*arrays, learning_rates, wds, etas=1.0, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                       clip_gradient=-1.0, num_tensors=1):
    """Multi-tensor AdamW; arrays = [w0, g0, m0, v0, ...]."""
    return _multi_adamish(arrays, 4, learning_rates, wds, etas, beta1, beta2,
                          epsilon, rescale_grad, clip_gradient, num_tensors,
                          decoupled=True)


@register("_multi_mp_adamw_update", aliases=["multi_mp_adamw_update"])
def multi_mp_adamw_update(*arrays, learning_rates, wds, etas=1.0, beta1=0.9,
                          beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                          clip_gradient=-1.0, num_tensors=1):
    """Multi-tensor AdamW on f32 masters; arrays = [w0, g0, m0, v0,
    w32_0, ...]."""
    return _multi_adamish(arrays, 5, learning_rates, wds, etas, beta1, beta2,
                          epsilon, rescale_grad, clip_gradient, num_tensors,
                          decoupled=True)


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """(1,) f32: 1 iff every element of every input is finite (ref:
    contrib multi_all_finite, the AMP loss scaler's check)."""
    flags = torch.stack([torch.isfinite(a).all() for a in arrays])
    return flags.all().to(torch.float32).reshape(1)


# ---------------------------------------------------------------------------
# NAG, RMSProp, Ftrl, SignSGD, FTML and grouped AdaGrad (one tensor each)
# ---------------------------------------------------------------------------
@register("nag_mom_update")
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom' = momentum * mom + g; w' = w - lr * (g + momentum * mom')."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = _weak(momentum, mom) * mom + g
    step = g + _weak(momentum, new_mom) * new_mom
    return weight - _weak(lr, step) * step, new_mom


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        c = _weak(clip_weights, w)
        w = w.clamp(-c, c)
    return w


@register("rmsprop_update")
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """n' = gamma1 * n + (1 - gamma1) * g^2; w' = w - lr * g /
    sqrt(n' + epsilon), clipped to clip_weights (> 0)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = _weak(gamma1, n) * n + _weak(1 - gamma1, g) * g.square()
    step = _weak(lr, g) * g / (new_n + _weak(epsilon, new_n)).sqrt()
    return _clip_weights(weight - step, clip_weights), new_n


@register("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013) with states (n, g, delta); returns
    (w', n', g', delta')."""
    gr = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = _weak(gamma1, n) * n + _weak(1 - gamma1, gr) * gr.square()
    new_g = _weak(gamma1, g) * g + _weak(1 - gamma1, gr) * gr
    den = (new_n - new_g.square() + _weak(epsilon, new_n)).sqrt()
    new_delta = _weak(gamma2, delta) * delta - _weak(lr, gr) * gr / den
    return (_clip_weights(weight + new_delta, clip_weights), new_n, new_g,
            new_delta)


@register("ftrl_update")
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """FTRL-proximal; returns (w', z', n'): w' is 0 where |z'| <=
    lamda1."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    new_n = n + g.square()
    sigma = (new_n.sqrt() - n.sqrt()) / _weak(lr, n)
    new_z = z + g - sigma * weight
    den = (_weak(beta, new_n) + new_n.sqrt()) / _weak(lr, new_n) + \
        _weak(wd, new_n)
    shrunk = -(new_z - new_z.sign() * _weak(lamda1, new_z)) / den
    new_w = torch.where(new_z.abs() <= _weak(lamda1, new_z),
                        torch.zeros_like(weight), shrunk)
    return new_w, new_z, new_n


@register("signsgd_update")
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """w - lr * sign(rescale * g + wd * w)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    return weight - _weak(lr, weight) * g.sign()


@register("ftml_update")
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML (ref: optimizer_op.cc :: ftml_update); returns (w', d', v',
    z'). The gradient is clipped after the weight decay is added."""
    g = grad * _weak(rescale_grad, grad) + _weak(wd, weight) * weight
    if clip_grad is not None and clip_grad >= 0:
        g = g.clamp(-_weak(clip_grad, g), _weak(clip_grad, g))
    new_v = _weak(beta2, v) * v + _weak(1 - beta2, g) * g.square()
    d_t = _weak((1 - beta1 ** t) / lr, new_v) * (
        (new_v / _weak(1 - beta2 ** t, new_v)).sqrt()
        + _weak(epsilon, new_v))
    sigma = d_t - _weak(beta1, d) * d
    new_z = _weak(beta1, z) * z + _weak(1 - beta1, g) * g - sigma * weight
    return -new_z / d_t, d_t, new_v, new_z


@register("_contrib_group_adagrad_update")
def group_adagrad_update(weight, grad, history, *, lr, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """Row-wise AdaGrad: the history (one value a row) grows by the mean
    of the row's squared gradient; returns (w', history')."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    if g.dim() > 1:
        new_h = history + g.square().mean(dim=tuple(range(1, g.dim())),
                                          keepdim=True)
    else:
        new_h = history + g.square()
    step = _weak(lr, g) * g / (new_h.sqrt() + _weak(epsilon, new_h))
    return weight - step, new_h


# ---------------------------------------------------------------------------
# multi-tensor SGD with lrs/wds given as attributes, the norms, LARS
# ---------------------------------------------------------------------------
@register("multi_sgd_update")
def multi_sgd_update(*arrays, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """arrays = [w0, g0, w1, g1, ...]; lrs and wds Python floats (one
    or one a tensor); returns the new weights."""
    n = int(num_weights)
    lrs, wds = _per_tensor(lrs, n), _per_tensor(wds, n)
    outs = [sgd_update(arrays[2 * i], arrays[2 * i + 1], lr=lrs[i],
                       wd=wds[i], rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient) for i in range(n)]
    return tuple(outs) if n > 1 else outs[0]


@register("multi_sgd_mom_update")
def multi_sgd_mom_update(*arrays, lrs, wds, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    """arrays = [w0, g0, m0, w1, ...]; returns (w0', ..., m0', ...)."""
    n = int(num_weights)
    lrs, wds = _per_tensor(lrs, n), _per_tensor(wds, n)
    ws, ms = [], []
    for i in range(n):
        w, m = sgd_mom_update(*arrays[3 * i:3 * i + 3], lr=lrs[i],
                              momentum=momentum, wd=wds[i],
                              rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)
        ws.append(w)
        ms.append(m)
    return tuple(ws + ms)


def _l2s(arrays):
    """Each array's L2 norm as f32: on the card one multi-tensor
    reduction (a few launches for any number of arrays); on the CPU each
    accumulated in f64 and rounded (the CPU's f32 norm adds along each
    row in f32 and drifts on tens of millions of elements, where a
    replica's gradient noise needs its norms to a few ulps)."""
    ts = [float_in(a) for a in arrays]
    if ts and ts[0].device.type == "cpu":
        return [torch.linalg.vector_norm(t, dtype=torch.float64).float()
                for t in ts]
    return torch._foreach_norm(ts, 2, dtype=torch.float32)


@register("multi_l2_norm")
def multi_l2_norm(*arrays, num_arrays=1):
    """(num_arrays,) f32: each array's L2 norm."""
    return torch.stack(_l2s(arrays))


@register("multi_finite_norm")
def multi_finite_norm(*arrays, num_arrays=1, num_weights=0):
    """f32 [finite_0, ..., norm_0, ...] over the gradients (the inputs
    but the last ``num_weights``), then the weights' L2 norms. A
    gradient is finite when the norm of 0 * it is 0: the product is 0
    for every finite element and NaN for an inf or a NaN, and cannot
    overflow."""
    grads = list(arrays[:len(arrays) - num_weights])
    weights = list(arrays[len(arrays) - num_weights:])
    grads = [float_in(g) for g in grads]
    zeros = torch.stack(_l2s(torch._foreach_mul(grads, 0.0)))
    return torch.cat([(zeros == 0).float(), torch.stack(_l2s(grads + weights))])


@register("multi_update_norm")
def multi_update_norm(*arrays, num_arrays=1):
    """arrays = [old0, new0, old1, new1, ...]; (pairs,) f32: the L2 norm
    of each new - old."""
    arrays = [float_in(a) for a in arrays]
    return torch.stack(_l2s(torch._foreach_sub(arrays[1::2], arrays[0::2])))


@register("_contrib_multi_lars")
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, *, eta, eps,
               rescale_grad=1.0):
    """LARS: each lr scaled by eta * ||w|| / (||g|| + wd * ||w|| + eps)
    from the squared norms, unscaled where either norm is 0."""
    w_norm = weights_sum_sq.sqrt()
    g_norm = grads_sum_sq.sqrt() * _weak(rescale_grad, grads_sum_sq)
    ratio = _weak(eta, w_norm) * w_norm / (g_norm + wds * w_norm
                                           + _weak(eps, w_norm))
    one = torch.ones_like(ratio)
    return lrs * torch.where(w_norm > 0, torch.where(g_norm > 0, ratio, one),
                             one)
