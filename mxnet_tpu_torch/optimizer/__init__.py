"""Optimizers: SGD with momentum, LAMB, Adam and AdamW, with
multi-precision master weights and learning-rate schedulers
(counterpart of ``mxnet_tpu/optimizer/__init__.py``; ref:
python/mxnet/optimizer/optimizer.py).

Each update computes the new weight and states with the operators of
:mod:`mxnet_tpu_torch.ops.optimizer_ops` and writes them into the
existing weight and state tensors in place, under ``torch.no_grad``, so
a parameter's autograd leaf stays the same object. A write casts to the
destination's dtype. The Trainer updates several parameters through one
``update_multi`` call, as the reference does at its default aggregation
size (4096 tensors per call).

With ``multi_precision=True`` a float16 weight gets an f32 master copy
in its state, ``(state, weight32)``: the update runs on the master and
the weight takes its value. As in the reference, only float16 weights
get one; a bfloat16 weight updates in its own dtype. The other
optimizers (RMSProp, NAG, ...) wait (ROADMAP.md queue 1, item 6), and
so do the reference's sparse (row-sparse gradient) branches (item 16).

SGD's multi-tensor update keeps each group's learning rates, weight
decays and ``rescale_grad`` in tensors on the weights' device that live
as long as the optimizer, refreshed before every update by one copy
from a pinned host buffer (:class:`_Staged`): a captured graph that
runs the update reads the step's values there instead of the values of
the step it was captured in. Such a graph (a backward with this update
appended) is kept in the optimizer's ``step_runners`` and dies with it:
it never serves another optimizer. The update counters advance on the
host every step.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..base import MXNetError
from ..ndarray import NDArray, zeros
from ..ops import optimizer_ops as _ops
from ..ops import reduce_ops as _reduce

__all__ = ["Optimizer", "SGD", "LAMB", "Adam", "AdamW", "create",
           "register", "Updater", "get_updater"]

_REG: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REG[klass.__name__.lower()] = klass
    return klass


def _write(arr: NDArray, value: torch.Tensor):
    with torch.no_grad():
        arr.tensor().copy_(value)


def _is_mp_state(state) -> bool:
    """A multi-precision state, ``(state, weight32)``, of an optimizer
    whose own state is a tuple (LAMB, Adam, AdamW)."""
    return isinstance(state, tuple) and len(state) == 2 and \
        isinstance(state[0], tuple)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = 0.01 if learning_rate is None else learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            lr_scheduler.base_lr = learning_rate
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
        """``(state of the f32 master, master)`` for a float16 weight
        under ``multi_precision``, else the plain state."""
        if self.multi_precision and weight._tdtype == torch.float16:
            w32 = weight.astype("float32")
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler present; cannot set learning rate")
        self.lr = lr

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
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

    def _multi_adaptive(self, indices, weights, grads, states, kernel,
                        mp_kernel, hp, needs_step, fold_lr=None):
        """One multi-tensor op for the parameters with plain states and
        one for those with f32 masters (the reference's
        ``_multi_adaptive_update``): per-tensor lr (bias correction
        folded in by ``fold_lr``), wd and, with ``needs_step``, step
        count; each op's outputs are the new weights, then each state
        tensor's."""
        groups = {False: [], True: []}
        for item in zip(indices, weights, grads, states):
            groups[_is_mp_state(item[3])].append(item)
        for is_mp, items in groups.items():
            if not items:
                continue
            lrs, wds, ts, arrays, dsts = [], [], [], [], []
            for i, w, g, s in items:
                self._update_count(i)
                t = self._index_update_count[i]
                lr = self._get_lr(i)
                lrs.append(fold_lr(lr, t) if fold_lr else lr)
                wds.append(self._get_wd(i))
                ts.append(t)
                st = list(s[0]) + [s[1]] if is_mp else list(s)
                arrays += [w.tensor(), g.tensor()] + [x.tensor() for x in st]
                dsts.append([w] + st)
            kw = dict(hp, learning_rates=lrs, wds=wds, num_tensors=len(items),
                      rescale_grad=self.rescale_grad)
            if needs_step:
                kw["step_count"] = ts
            with torch.no_grad():
                outs = (mp_kernel if is_mp else kernel)(*arrays, **kw)
                n = len(items)
                for k, dst in enumerate(dsts):
                    for j, arr in enumerate(dst):
                        _write(arr, outs[j * n + k])


@register
class SGD(Optimizer):
    """SGD with momentum (ref: optimizer.py :: SGD -> sgd_update /
    sgd_mom_update, mp_sgd_* with a master; update_multi ->
    preloaded_multi_(mp_)sgd_*)."""

    def __init__(self, momentum=0.0, lazy_update=True, learning_rate=0.01,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self._staged: Dict[tuple, "_Staged"] = {}
        # captured steps that append this optimizer's update to a backward
        # (cached_op._Plan.run): they read its staged hyperparameters
        self.step_runners: Dict[tuple, Any] = {}

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self._clip())
        w, g = weight.tensor(), grad.tensor()
        with torch.no_grad():
            if isinstance(state, tuple):        # (momentum or None, w32)
                mom, w32 = state
                if mom is not None:
                    nw, nm, n32 = _ops.mp_sgd_mom_update(
                        w, g, mom.tensor(), w32.tensor(),
                        momentum=self.momentum, **kwargs)
                    _write(mom, nm)
                else:
                    nw, n32 = _ops.mp_sgd_update(w, g, w32.tensor(),
                                                 **kwargs)
                _write(w32, n32)
            elif state is not None:
                nw, nm = _ops.sgd_mom_update(w, g, state.tensor(),
                                             momentum=self.momentum,
                                             **kwargs)
                _write(state, nm)
            else:
                nw = _ops.sgd_update(w, g, **kwargs)
            _write(weight, nw)

    def update_multi(self, indices, weights, grads, states):
        """One preloaded_multi_(mp_)sgd_* call for each group of
        parameters — with momentum, without, and both with f32 masters,
        by gradient dtype — the per-tensor lrs/wds as f32 tensors on the
        weights' device."""
        self.multi_plan(indices, weights, grads, states)[1]()

    def multi_plan(self, indices, weights, grads, states):
        """The host part of :meth:`update_multi`: advance the counters and
        stage each group's lrs, wds and rescale_grad on the device.
        Returns ``(key, apply)``: ``apply()`` is the device part, and
        ``key`` names its math and the addresses of the tensors it reads
        and writes (a captured ``apply``, which keeps those tensors
        alive, replays as long as the key holds)."""
        groups: Dict[tuple, list] = {}
        for item in zip(indices, weights, grads, states):
            s = item[3]
            mp = isinstance(s, tuple)
            mom = (s[0] if mp else s) is not None
            groups.setdefault((mom, mp, item[2]._tdtype), []).append(item)
        calls, key = [], []
        for (mom, mp, gdt), items in groups.items():
            for i, _, _, _ in items:
                self._update_count(i)
            n = len(items)
            arrays, dsts = [], []
            for _, w, g, s in items:
                st = ([s[0]] if mom else []) + [s[1]] if mp else \
                    ([s] if mom else [])
                arrays += [w.tensor(), g.tensor()] + [x.tensor() for x in st]
                dsts.append([w] + st)
            gkey = (mom, mp, gdt, tuple(i for i, _, _, _ in items))
            staged = self._staged.get(gkey)
            if staged is None:
                # the multi-precision ops rescale the widened gradient
                staged = self._staged[gkey] = _Staged(
                    n, torch.float32 if mp else gdt, arrays[0].device)
            staged.stage([self._get_lr(i) for i, _, _, _ in items],
                         [self._get_wd(i) for i, _, _, _ in items],
                         self.rescale_grad)
            kw = dict(clip_gradient=self._clip(), num_weights=n)
            if mom:
                kw["momentum"] = self.momentum
            op = {(True, False): _ops.preloaded_multi_sgd_mom_update,
                  (False, False): _ops.preloaded_multi_sgd_update,
                  (True, True): _ops.preloaded_multi_mp_sgd_mom_update,
                  (False, True): _ops.preloaded_multi_mp_sgd_update}[
                      (mom, mp)]
            calls.append((op, arrays, dsts, kw, staged))
            key.append((gkey, tuple(sorted(kw.items())),
                        tuple((a.data_ptr(), a.shape) for a in arrays)))

        def apply():
            with torch.no_grad():
                for op, arrays, dsts, kw, staged in calls:
                    n = kw["num_weights"]
                    outs = op(*arrays, staged.lrs, staged.wds,
                              rescale_grad=staged.rescale, **kw)
                    outs = outs if isinstance(outs, tuple) else (outs,)
                    for k, dst in enumerate(dsts):
                        for j, arr in enumerate(dst):
                            _write(arr, outs[j * n + k])
        return ("sgd",) + tuple(key), apply


class _Staged:
    """One SGD group's per-step hyperparameters on the device: ``lrs``
    and ``wds`` (f32, one a tensor) and ``rescale`` (0-d, in the dtype the
    update rescales the gradient in, rounded to it as the Python scalar
    is), refreshed by :meth:`stage` from pinned host memory. The host
    buffer is rewritten only after the previous copy out of it ran."""

    def __init__(self, n, rdtype, device):
        pin = device.type == "cuda"
        self.host = torch.empty(2 * n, dtype=torch.float32, pin_memory=pin)
        self.host_r = torch.empty((), dtype=rdtype, pin_memory=pin)
        self.dev = torch.empty(2 * n, dtype=torch.float32, device=device)
        self.rescale = torch.empty((), dtype=rdtype, device=device)
        self.lrs, self.wds = self.dev[:n], self.dev[n:]
        self.n = n
        self._done = None

    def stage(self, lrs, wds, rescale):
        if self._done is not None:
            self._done.synchronize()
        self.host[:self.n] = torch.tensor(lrs, dtype=torch.float32)
        self.host[self.n:] = torch.tensor(wds, dtype=torch.float32)
        self.host_r.fill_(rescale)
        blocking = not self.dev.is_cuda
        self.dev.copy_(self.host, non_blocking=not blocking)
        self.rescale.copy_(self.host_r, non_blocking=not blocking)
        if not blocking:
            self._done = torch.cuda.Event()
            self._done.record()


def _bias_fold(beta1, beta2):
    """lr * sqrt(1 - beta2^t) / (1 - beta1^t): Adam's bias correction
    folded into the learning rate."""
    return lambda lr, t: lr * (math.sqrt(1.0 - beta2 ** t)
                               / (1.0 - beta1 ** t))


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py :: Adam -> adam_update; update_multi ->
    multi_(mp_)adam_update), bias correction folded into lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        if _is_mp_state(state):
            # MXNet 1.x's form: the master updated by the widened
            # gradient, the weight taking its value
            inner, w32 = state
            self.update(index, w32, grad.astype("float32"), inner)
            _write(weight, w32.tensor())
            return
        self._update_count(index)
        t = self._index_update_count[index]
        lr = _bias_fold(self.beta1, self.beta2)(self._get_lr(index), t)
        mean, var = state
        with torch.no_grad():
            nw, nm, nv = _ops.adam_update(
                weight.tensor(), grad.tensor(), mean.tensor(), var.tensor(),
                lr=lr, wd=self._get_wd(index), beta1=self.beta1,
                beta2=self.beta2, epsilon=self.epsilon,
                rescale_grad=self.rescale_grad, clip_gradient=self._clip())
            _write(mean, nm)
            _write(var, nv)
            _write(weight, nw)

    def update_multi(self, indices, weights, grads, states):
        hp = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                  clip_gradient=self._clip())
        self._multi_adaptive(indices, weights, grads, states,
                             _ops.multi_adam_update,
                             _ops.multi_mp_adam_update, hp, False,
                             _bias_fold(self.beta1, self.beta2))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (ref: contrib/adamw.cc ->
    adamw_update, _mp_adamw_update with a master; update_multi ->
    _multi_(mp_)adamw_update), bias correction folded into lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype),
                zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = dict(lr=_bias_fold(self.beta1, self.beta2)(self._get_lr(index),
                                                        t),
                  wd=self._get_wd(index), eta=1.0, beta1=self.beta1,
                  beta2=self.beta2, epsilon=self.epsilon,
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        w, g = weight.tensor(), grad.tensor()
        with torch.no_grad():
            if _is_mp_state(state):
                (mean, var), w32 = state
                nw, nm, nv, n32 = _ops.mp_adamw_update(
                    w, g, mean.tensor(), var.tensor(), w32.tensor(), **kw)
                _write(w32, n32)
            else:
                mean, var = state
                nw, nm, nv = _ops.adamw_update(w, g, mean.tensor(),
                                               var.tensor(), **kw)
            _write(mean, nm)
            _write(var, nv)
            _write(weight, nw)

    def update_multi(self, indices, weights, grads, states):
        hp = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                  etas=1.0, clip_gradient=self._clip())
        self._multi_adaptive(indices, weights, grads, states,
                             _ops.multi_adamw_update,
                             _ops.multi_mp_adamw_update, hp, False,
                             _bias_fold(self.beta1, self.beta2))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT (ref:
    optimizer.py :: LAMB -> lamb_update_phase1/2, with ``norm`` of the
    weight and of the update between them, mp_lamb_update_phase1/2 with
    a master; update_multi -> _multi_(mp_)lamb_update)."""

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

    def _bounds(self):
        return dict(lower_bound=-1.0 if self.lower_bound is None
                    else self.lower_bound,
                    upper_bound=-1.0 if self.upper_bound is None
                    else self.upper_bound)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                  t=t, bias_correction=self.bias_correction, wd=wd,
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        w, g = weight.tensor(), grad.tensor()
        mp = _is_mp_state(state)
        (mean, var), w32 = state if mp else (state, None)
        with torch.no_grad():
            if mp:
                upd, nm, nv = _ops.mp_lamb_update_phase1(
                    w, g, mean.tensor(), var.tensor(), w32.tensor(), **kw)
            else:
                upd, nm, nv = _ops.lamb_update_phase1(
                    w, g, mean.tensor(), var.tensor(), **kw)
            _write(mean, nm)
            _write(var, nv)
            r1 = _reduce.norm((w32 if mp else weight).tensor())
            r2 = _reduce.norm(upd)
            if mp:
                nw, n32 = _ops.mp_lamb_update_phase2(
                    w, upd, r1, r2, w32.tensor(), lr=lr, **self._bounds())
                _write(w32, n32)
            else:
                nw = _ops.lamb_update_phase2(w, upd, r1, r2, lr=lr,
                                             **self._bounds())
            _write(weight, nw)

    def update_multi(self, indices, weights, grads, states):
        hp = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                  bias_correction=self.bias_correction,
                  clip_gradient=self._clip(), **self._bounds())
        self._multi_adaptive(indices, weights, grads, states,
                             _ops.multi_lamb_update,
                             _ops.multi_mp_lamb_update, hp, True)


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
