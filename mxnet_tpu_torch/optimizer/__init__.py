"""Optimizers, the subset the training slices run: SGD with momentum and
LAMB (counterpart of ``mxnet_tpu/optimizer/__init__.py``; ref:
python/mxnet/optimizer/optimizer.py).

Each update computes the new weight and states with the operators of
:mod:`mxnet_tpu_torch.ops.optimizer_ops` and writes them into the
existing weight and state tensors in place, under ``torch.no_grad``, so
a parameter's autograd leaf stays the same object. A write casts to the
destination's dtype. The Trainer updates several parameters through one
``update_multi`` call, as the reference does at its default aggregation
size (4096 tensors per call). Multi-precision master weights,
Adam/AdamW, the other optimizers and learning-rate schedules wait
(ROADMAP.md queue 1, item 6).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..base import MXNetError
from ..ndarray import NDArray, zeros
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "LAMB", "create", "register", "Updater",
           "get_updater"]

_REG: Dict[str, type] = {}

MULTI_PRECISION = ("multi-precision master weights are not ported yet "
                   "(ROADMAP.md queue 1, item 6)")


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REG[klass.__name__.lower()] = klass
    return klass


def _write(arr: NDArray, value: torch.Tensor):
    with torch.no_grad():
        arr.tensor().copy_(value)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        if lr_scheduler is not None:
            raise NotImplementedError(
                "lr_scheduler is not ported yet (ROADMAP.md queue 1, "
                "item 6)")
        if multi_precision:
            raise NotImplementedError(MULTI_PRECISION)
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.idx2name = dict(self.param_idx2name)

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    def set_learning_rate(self, lr):
        self.lr = lr

    def _get_lr(self, index):
        lr = self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _clip(self):
        return -1.0 if self.clip_gradient is None else self.clip_gradient


@register
class SGD(Optimizer):
    """SGD with momentum (ref: optimizer.py :: SGD -> sgd_update /
    sgd_mom_update; update_multi -> preloaded_multi_sgd_*)."""

    def __init__(self, momentum=0.0, lazy_update=True, learning_rate=0.01,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self._clip())
        with torch.no_grad():
            if state is not None:
                w, m = _ops.sgd_mom_update(
                    weight.tensor(), grad.tensor(), state.tensor(),
                    momentum=self.momentum, **kwargs)
                _write(state, m)
            else:
                w = _ops.sgd_update(weight.tensor(), grad.tensor(), **kwargs)
            _write(weight, w)

    def update_multi(self, indices, weights, grads, states):
        """One preloaded_multi_sgd_* call for the tensors with momentum
        state and one for those without, the per-tensor lrs/wds as f32
        tensors on the weights' device."""
        groups = {True: [], False: []}
        for item in zip(indices, weights, grads, states):
            groups[item[3] is not None].append(item)
        for mom, group in groups.items():
            if group:
                self._sgd_multi(group, mom)

    def _sgd_multi(self, items, mom):
        for i, _, _, _ in items:
            self._update_count(i)
        dev = items[0][1].tensor().device
        lrs = torch.tensor([self._get_lr(i) for i, _, _, _ in items],
                           dtype=torch.float32, device=dev)
        wds = torch.tensor([self._get_wd(i) for i, _, _, _ in items],
                           dtype=torch.float32, device=dev)
        n = len(items)
        arrays = []
        for _, w, g, s in items:
            arrays += [w.tensor(), g.tensor()] + ([s.tensor()] if mom else [])
        kw = dict(rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip(), num_weights=n)
        with torch.no_grad():
            if mom:
                outs = _ops.preloaded_multi_sgd_mom_update(
                    *arrays, lrs, wds, momentum=self.momentum, **kw)
                for k, (_, w, _, s) in enumerate(items):
                    _write(w, outs[k])
                    _write(s, outs[n + k])
            else:
                outs = _ops.preloaded_multi_sgd_update(*arrays, lrs, wds,
                                                       **kw)
                outs = outs if isinstance(outs, tuple) else (outs,)
                for (_, w, _, _), o in zip(items, outs):
                    _write(w, o)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT (ref:
    optimizer.py :: LAMB; update_multi -> _multi_lamb_update). A
    one-tensor ``update`` runs the multi-tensor arithmetic on that
    tensor; the reference's lamb_update_phase1/2 ops wait."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self.update_multi([index], [weight], [grad], [state])

    def update_multi(self, indices, weights, grads, states):
        items = list(zip(indices, weights, grads, states))
        lrs, wds, ts, arrays = [], [], [], []
        for i, w, g, (m, v) in items:
            self._update_count(i)
            ts.append(self._index_update_count[i])
            lrs.append(self._get_lr(i))
            wds.append(self._get_wd(i))
            arrays += [w.tensor(), g.tensor(), m.tensor(), v.tensor()]
        n = len(items)
        with torch.no_grad():
            outs = _ops.multi_lamb_update(
                *arrays, learning_rates=lrs, wds=wds, beta1=self.beta1,
                beta2=self.beta2, epsilon=self.epsilon, step_count=ts,
                bias_correction=self.bias_correction,
                rescale_grad=self.rescale_grad, clip_gradient=self._clip(),
                lower_bound=-1.0 if self.lower_bound is None
                else self.lower_bound,
                upper_bound=-1.0 if self.upper_bound is None
                else self.upper_bound, num_tensors=n)
            for k, (_, w, _, (m, v)) in enumerate(items):
                _write(w, outs[k])
                _write(m, outs[n + k])
                _write(v, outs[2 * n + k])


def create(name, **kwargs) -> Optimizer:
    """An optimizer by registered name (or the optimizer itself)."""
    if isinstance(name, Optimizer):
        return name
    klass = _REG.get(str(name).lower())
    if klass is None:
        raise MXNetError("optimizer %r is not ported (ported: %s; the rest "
                         "is ROADMAP.md queue 1, item 6)"
                         % (name, ", ".join(sorted(_REG))))
    return klass(**kwargs)


class Updater:
    """Per-key state updater (ref: optimizer.py :: Updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
