"""Optimizers: SGD with momentum, NAG, LAMB, Adam, AdamW, RMSProp
(plain and centered), Ftrl, SignSGD and AdaGrad, with multi-precision
master weights and learning-rate schedulers, and the Updater's states
blob (counterpart of ``mxnet_tpu/optimizer/__init__.py``; ref:
python/mxnet/optimizer/optimizer.py).

Each update computes the new weight and states with the operators of
:mod:`mxnet_tpu_torch.ops.optimizer_ops` and writes them into the
existing weight and state tensors in place, under ``torch.no_grad``, so
a parameter's autograd leaf stays the same object. A write casts to the
destination's dtype. ``update_multi`` takes its parameters in chunks of
``aggregate_num`` (``MXNET_OPTIMIZER_AGGREGATION_SIZE``, 4096 by
default; 0 or less, one chunk), one multi-tensor op a chunk where the
optimizer has one (SGD, Adam, AdamW, LAMB), as the reference does; the
others update each tensor alone.

With ``multi_precision=True`` a float16 weight gets an f32 master copy
in its state, ``(state, weight32)``: the update runs on the master and
the weight takes its value. As in the reference, only float16 weights
get one; a bfloat16 weight updates in its own dtype. The reference's
sparse (row-sparse gradient) branches wait (ROADMAP.md queue 1, item
16).

SGD's multi-tensor update keeps each group's learning rates, weight
decays and ``rescale_grad`` in tensors on the weights' device that live
as long as the optimizer, refreshed before every update by one copy
from a pinned host buffer (:class:`_Staged`): a captured graph that
runs the update reads the step's values there instead of the values of
the step it was captured in. Such a graph (a backward with this update
appended) is kept in the optimizer's ``step_runners`` and dies with it:
it never serves another optimizer. The update counters advance on the
host every step, in :meth:`SGD.multi_prep`, whose :class:`SGDPrep` is
the step's host part; a K-step chunk (``scan.py``) stages K of them as
K rows and step k of its graph reads row k.

``Updater.get_states`` pickles ``{index: state}`` as the reference does,
each array through ``ndarray._unpickle`` (all of them copied to the
host first, with one wait for the card). ``set_states`` reads such a
blob, the reference's too, with an unpickler that admits only the
array globals; a loaded state is written into the existing state
tensors where their shapes and dtypes match (a captured step that reads
them replays the loaded values), else it moves to its weight's context
the first time that index is updated and the optimizer's captured steps
are closed.
"""
from __future__ import annotations

import io
import math
import pickle
from typing import Any, Dict

import torch

from ..base import MXNetError
from ..config import get as _cfg
from ..ndarray import NDArray, zeros
from ..ndarray import ndarray as _nd
from ..ops import optimizer_ops as _ops
from ..ops import reduce_ops as _reduce

__all__ = ["Optimizer", "SGD", "NAG", "LAMB", "Adam", "AdamW", "RMSProp",
           "Ftrl", "SignSGD", "AdaGrad", "create", "register", "Updater",
           "get_updater", "ZeroHyper"]

_REG: Dict[str, type] = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REG[klass.__name__.lower()] = klass
    return klass


def _write(arr: NDArray, value: torch.Tensor):
    with torch.no_grad():
        arr.tensor().copy_(value)


def _chunks(items, agg):
    """``items`` in chunks of ``agg`` (all in one when ``agg`` <= 0)."""
    agg = len(items) if agg <= 0 else agg
    return [items[k:k + agg] for k in range(0, len(items), max(agg, 1))]


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
        # the multi-tensor width (ref: aggregate_num)
        self.aggregate_num = _cfg("MXNET_OPTIMIZER_AGGREGATION_SIZE")

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
        """MXNet 1.x's ``update_multi_precision``: a float16 weight under
        ``multi_precision`` updates its f32 master with the widened
        gradient and takes the master's value."""
        if self.multi_precision and weight._tdtype == torch.float16:
            inner, w32 = state
            self.update(index, w32, grad.astype("float32"), inner)
            _write(weight, w32.tensor())
        else:
            self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    # ------------------------------------------------------------------
    # ZeRO weight-update sharding (gluon/zero.py)
    # ------------------------------------------------------------------
    def zero_fragment_update(self, aggregate=False):
        """The fragment form of this optimizer for ZeRO, or None when its
        update is not elementwise (LAMB's layer norms, AdamW, master
        weights): the Trainer then stays replicated.

        Returns ``(num_states, hyper_key, fn)``: ``num_states`` state
        tensors a parameter (allocated sharded by the engine),
        ``hyper_key`` the static hyperparameters ``fn`` holds, and
        ``fn(w, g, states, hp) -> (new_w, new_states)`` the update of
        one 1-D fragment, ``hp`` a :class:`ZeroHyper`. ``aggregate``
        picks the multi-tensor ops the replicated Trainer's
        ``update_multi`` runs (so the two paths take the same steps bit
        for bit), else the one-tensor ops of :meth:`update`."""
        return None

    def zero_hyperparams(self, index):
        """Per-parameter (lr, wd) of one ZeRO step, taken after
        :meth:`_update_count` advanced the counter; Adam folds its bias
        correction into lr."""
        return self._get_lr(index), self._get_wd(index)

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
        for is_mp, group in groups.items():
            for items in _chunks(group, int(self.aggregate_num)):
                self._adaptive_chunk(items, is_mp, kernel, mp_kernel, hp,
                                     needs_step, fold_lr)

    def _adaptive_chunk(self, items, is_mp, kernel, mp_kernel, hp,
                        needs_step, fold_lr):
        """One multi-tensor op over ``items``, all with plain states or
        all with masters."""
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

    def zero_fragment_update(self, aggregate=False):
        """SGD's fragment form: sgd_update or sgd_mom_update (with
        ``aggregate``, the preloaded multi-tensor ops, lr and wd f32
        device scalars and the rescale in the gradient's dtype) on the
        owned slice."""
        if self.multi_precision:
            return None
        clip = self._clip()
        momentum = float(self.momentum)
        mom = momentum != 0.0
        if aggregate:
            op = _ops.preloaded_multi_sgd_mom_update if mom else \
                _ops.preloaded_multi_sgd_update
            kw = dict(clip_gradient=clip, num_weights=1)
            if mom:
                kw["momentum"] = momentum

            def fn(w, g, states, hp):
                outs = op(w, g, *states, hp.lr_t[None], hp.wd_t[None],
                          rescale_grad=hp.rescale_t, **kw)
                if not mom:
                    return outs, ()
                return outs[0], (outs[1],)
            return int(mom), ("sgd_multi", momentum, clip), fn

        def fn(w, g, states, hp):
            kwargs = dict(lr=hp.lr, wd=hp.wd, rescale_grad=hp.rescale,
                          clip_gradient=clip)
            if mom:
                nw, nm = _ops.sgd_mom_update(w, g, states[0],
                                             momentum=momentum, **kwargs)
                return nw, (nm,)
            return _ops.sgd_update(w, g, **kwargs), ()
        return int(mom), ("sgd", momentum, clip), fn

    def update_multi(self, indices, weights, grads, states):
        """One preloaded_multi_(mp_)sgd_* call for each group of
        parameters — with momentum, without, and both with f32 masters,
        by gradient dtype — the per-tensor lrs/wds as f32 tensors on the
        weights' device."""
        self.multi_plan(indices, weights, grads, states)[1]()

    def multi_prep(self, indices, weights, grads, states, skips=0):
        """The host part of a multi-tensor step (:class:`SGDPrep`):
        advance the counters, then take each chunk's lrs and wds and the
        rescale (a group's chunks are ``aggregate_num`` wide; the math of
        each tensor is the same at any width). With ``skips`` the lrs
        are also taken as if that many earlier steps had not advanced
        the counters (0 to ``skips``, from the most): a K-step chunk
        whose guard may skip a step selects the row of its skips in the
        graph (scan.py)."""
        groups: Dict[tuple, list] = {}
        for item in zip(indices, weights, grads, states):
            s = item[3]
            mp = isinstance(s, tuple)
            mom = (s[0] if mp else s) is not None
            groups.setdefault((mom, mp, item[2]._tdtype), []).append(item)
        # the reference's SGD takes chunks of one at a width of 0 or less
        agg = max(int(self.aggregate_num), 1)
        chunks = [(gk, items) for gk, group in groups.items()
                  for items in _chunks(group, agg)]
        base_counts = dict(self._index_update_count)
        base_num = self.num_update
        calls, vals, key = [], [], []
        for (mom, mp, gdt), items in chunks:
            for i, _, _, _ in items:
                self._update_count(i)
            num = self.num_update
            n = len(items)
            arrays, dsts = [], []
            for _, w, g, s in items:
                st = ([s[0]] if mom else []) + [s[1]] if mp else \
                    ([s] if mom else [])
                arrays += [w.tensor(), g.tensor()] + [x.tensor() for x in st]
                dsts.append([w] + st)
            gkey = (mom, mp, gdt, tuple(i for i, _, _, _ in items))
            lr_rows = []
            for back in range(skips, -1, -1):
                # in rising count order: a scheduler may keep state
                self.num_update = num - back
                lr_rows.insert(0, [self._get_lr(i) for i, _, _, _ in items])
            self.num_update = num
            kw = dict(clip_gradient=self._clip(), num_weights=n)
            if mom:
                kw["momentum"] = self.momentum
            op = {(True, False): _ops.preloaded_multi_sgd_mom_update,
                  (False, False): _ops.preloaded_multi_sgd_update,
                  (True, True): _ops.preloaded_multi_mp_sgd_mom_update,
                  (False, True): _ops.preloaded_multi_mp_sgd_update}[
                      (mom, mp)]
            # the multi-precision ops rescale the widened gradient
            calls.append((gkey, op, arrays, dsts, kw,
                          torch.float32 if mp else gdt))
            vals.append((lr_rows, [self._get_wd(i) for i, _, _, _ in items]))
            key.append((gkey, tuple(sorted(kw.items())),
                        tuple((a.data_ptr(), a.shape) for a in arrays)))
        return SGDPrep(calls, vals, self.rescale_grad, ("sgd",) + tuple(key),
                       base_counts, base_num)

    def staged_for(self, prep, rows=1):
        """The staged tensors of each of ``prep``'s chunks, ``rows``
        steps deep, on the chunk's device (the updaters of several
        contexts share the optimizer); they live as long as the
        optimizer."""
        out = []
        for gkey, _, arrays, _, kw, rdtype in prep.calls:
            sk = (gkey, rows, arrays[0].device)
            staged = self._staged.get(sk)
            if staged is None:
                staged = self._staged[sk] = _Staged(
                    kw["num_weights"], rdtype, arrays[0].device, rows)
            out.append(staged)
        return out

    def multi_plan(self, indices, weights, grads, states, prep=None):
        """:meth:`multi_prep` (or the ``prep`` made earlier) staged on the
        device. Returns ``(key, apply)``: ``apply()`` is the device part,
        and ``key`` names its math and the addresses of the tensors it
        reads and writes (a captured ``apply``, which keeps those
        tensors alive, replays as long as the key holds)."""
        if prep is None:
            prep = self.multi_prep(indices, weights, grads, states)
        staged = self.staged_for(prep)
        for st, (lr_rows, wds) in zip(staged, prep.vals):
            st.stage([(lr_rows[:1], wds, prep.rescale)])
        return prep.key, lambda: prep.apply(staged)


class SGDPrep:
    """One SGD multi-tensor step's host part: ``calls`` (per chunk: its
    group key, op, input tensors, destination arrays, attributes and the
    rescale dtype), ``vals`` (per chunk: lrs by skipped steps, then wds),
    ``rescale``, the ``key`` of its math and tensors, and the counters
    before it advanced them (``base_counts``, ``base_num``), which a
    step that falls back to the classic path rewinds to."""

    __slots__ = ("calls", "vals", "rescale", "key", "base_counts",
                 "base_num")

    def __init__(self, calls, vals, rescale, key, base_counts, base_num):
        self.calls, self.vals, self.rescale = calls, vals, rescale
        self.key, self.base_counts, self.base_num = key, base_counts, \
            base_num

    def rewind(self, opt):
        opt._index_update_count = dict(self.base_counts)
        opt.num_update = self.base_num

    def apply(self, staged, row=0, ok=None, skipped=None):
        """The device part: each chunk's op on row ``row`` of its staged
        tensors, the lrs of row ``skipped`` (a device index) of the step
        when given. With ``ok`` (a device bool) each weight and state
        keeps its value where ``ok`` is false."""
        with torch.no_grad():
            for (_, op, arrays, dsts, kw, _), st in zip(self.calls, staged):
                n = kw["num_weights"]
                lrs = st.lr_tab[row, 0] if skipped is None else \
                    st.lr_tab[row].index_select(0, skipped)[0]
                outs = op(*arrays, lrs, st.wd_tab[row],
                          rescale_grad=st.rescale[row], **kw)
                outs = outs if isinstance(outs, tuple) else (outs,)
                for k, dst in enumerate(dsts):
                    for j, arr in enumerate(dst):
                        new = outs[j * n + k]
                        if ok is not None:
                            new = torch.where(ok, new, arr.tensor())
                        _write(arr, new)


class _Staged:
    """One SGD chunk's hyperparameters on the device for ``rows`` steps:
    ``lr_tab`` (rows, rows, n) f32, step k's lrs by the number of steps
    of its chunk skipped before it; ``wd_tab`` (rows, n) f32; ``rescale``
    (rows,) in the dtype the update rescales the gradient in, rounded to
    it as the Python scalar is. Refreshed by :meth:`stage` from pinned
    host memory, whose buffer is rewritten only after the previous copy
    out of it ran."""

    def __init__(self, n, rdtype, device, rows=1):
        pin = device.type == "cuda"
        size = rows * rows * n + rows * n
        self.host = torch.zeros(size, dtype=torch.float32, pin_memory=pin)
        self.host_r = torch.empty(rows, dtype=rdtype, pin_memory=pin)
        self.dev = torch.empty(size, dtype=torch.float32, device=device)
        self.rescale = torch.empty(rows, dtype=rdtype, device=device)
        self.lr_tab = self.dev[:rows * rows * n].view(rows, rows, n)
        self.wd_tab = self.dev[rows * rows * n:].view(rows, n)
        self._host_lr = self.host[:rows * rows * n].view(rows, rows, n)
        self._host_wd = self.host[rows * rows * n:].view(rows, n)
        self.n, self.rows = n, rows
        self._done = None

    def stage(self, steps):
        """``steps``: per row, (lrs by skips, wds, rescale)."""
        if self._done is not None:
            self._done.synchronize()
        for k, (lr_rows, wds, rescale) in enumerate(steps):
            for s, lrs in enumerate(lr_rows):
                self._host_lr[k, s] = torch.tensor(lrs, dtype=torch.float32)
            self._host_wd[k] = torch.tensor(wds, dtype=torch.float32)
            self.host_r[k].fill_(rescale)
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

    def zero_fragment_update(self, aggregate=False):
        """Adam's fragment form: adam_update (with ``aggregate``,
        multi_adam_update) on the owned slice, the bias correction folded
        into lr by :meth:`zero_hyperparams`."""
        if self.multi_precision:
            return None
        hp = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                  clip_gradient=self._clip())
        key = ("adam_multi" if aggregate else "adam", self.beta1,
               self.beta2, self.epsilon, self._clip())
        if aggregate:
            def fn(w, g, states, h):
                outs = _ops.multi_adam_update(
                    w, g, states[0], states[1], learning_rates=[h.lr],
                    wds=[h.wd], rescale_grad=h.rescale, num_tensors=1, **hp)
                return outs[0], (outs[1], outs[2])
            return 2, key, fn

        def fn(w, g, states, h):
            nw, nm, nv = _ops.adam_update(w, g, states[0], states[1],
                                          lr=h.lr, wd=h.wd,
                                          rescale_grad=h.rescale, **hp)
            return nw, (nm, nv)
        return 2, key, fn

    def zero_hyperparams(self, index):
        t = self._index_update_count[index]
        return (_bias_fold(self.beta1, self.beta2)(self._get_lr(index), t),
                self._get_wd(index))

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


def _zeros_like(weight):
    return zeros(weight.shape, ctx=weight.ctx, dtype=weight.dtype)


def _hp(opt, index):
    """The one-tensor ops' common attributes."""
    return dict(lr=opt._get_lr(index), wd=opt._get_wd(index),
                rescale_grad=opt.rescale_grad, clip_gradient=opt._clip())


@register
class NAG(Optimizer):
    """Nesterov momentum (ref: optimizer.py :: NAG -> nag_mom_update,
    sgd_update without momentum)."""

    def __init__(self, momentum=0.0, learning_rate=0.1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        w, g = weight.tensor(), grad.tensor()
        with torch.no_grad():
            if state is not None:
                nw, nm = _ops.nag_mom_update(w, g, state.tensor(),
                                             momentum=self.momentum,
                                             **_hp(self, index))
                _write(state, nm)
            else:
                nw = _ops.sgd_update(w, g, **_hp(self, index))
            _write(weight, nw)


@register
class RMSProp(Optimizer):
    """RMSProp (ref: optimizer.py :: RMSProp -> rmsprop_update; centered
    -> rmspropalex_update with states (n, g, delta))."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(_hp(self, index), gamma1=self.gamma1, epsilon=self.epsilon,
                  clip_weights=-1.0 if self.clip_weights is None
                  else self.clip_weights)
        w, g = weight.tensor(), grad.tensor()
        with torch.no_grad():
            if self.centered:
                outs = _ops.rmspropalex_update(
                    w, g, *[x.tensor() for x in state], gamma2=self.gamma2,
                    **kw)
                for arr, new in zip(state, outs[1:]):
                    _write(arr, new)
                nw = outs[0]
            else:
                nw, nn = _ops.rmsprop_update(w, g, state.tensor(), **kw)
                _write(state, nn)
            _write(weight, nw)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (ref: optimizer.py :: Ftrl -> ftrl_update, states
    (z, n))."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        with torch.no_grad():
            nw, nz, nn = _ops.ftrl_update(
                weight.tensor(), grad.tensor(), z.tensor(), n.tensor(),
                lamda1=self.lamda1, beta=self.beta, **_hp(self, index))
            _write(z, nz)
            _write(n, nn)
            _write(weight, nw)


@register
class SignSGD(Optimizer):
    """SignSGD (ref: optimizer.py :: SignSGD -> signsgd_update)."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            _write(weight, _ops.signsgd_update(
                weight.tensor(), grad.tensor(), **_hp(self, index)))


@register
class AdaGrad(Optimizer):
    """AdaGrad (ref: optimizer.py :: AdaGrad), composed of elementwise
    operations as the reference composes it: the rescaled, clipped
    gradient plus wd * w, its square added to the history, w - lr * g /
    (sqrt(history) + eps)."""

    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w, h = weight.tensor(), state.tensor()
        with torch.no_grad():
            g = grad.tensor() * _ops._weak(self.rescale_grad, grad.tensor())
            if self.clip_gradient is not None:
                c = _ops._weak(self.clip_gradient, g)
                g = g.clamp(-c, c)
            if wd:
                g = g + _ops._weak(wd, w) * w
            h.add_(g.square())
            w.sub_(_ops._weak(lr, g) * g
                   / (h.sqrt() + _ops._weak(self.float_stable_eps, h)))


def create(name, **kwargs) -> Optimizer:
    """An optimizer by registered name (or the optimizer itself)."""
    if isinstance(name, Optimizer):
        return name
    klass = _REG.get(str(name).lower())
    if klass is None:
        raise MXNetError("Cannot find '%s' in registry 'optimizer'. "
                         "Registered: %s" % (name, sorted(_REG)))
    return klass(**kwargs)


# ---------------------------------------------------------------------------
# the states blob: a pickle of {index: state}, each array through
# ndarray._unpickle as the reference writes it
# ---------------------------------------------------------------------------
def _arrays_of(state, out):
    if isinstance(state, NDArray):
        out.append(state)
    elif isinstance(state, (tuple, list)):
        for s in state:
            _arrays_of(s, out)
    elif isinstance(state, dict):
        for s in state.values():
            _arrays_of(s, out)
    return out


class _StatesPickler(pickle.Pickler):
    """Pickles each NDArray as the reference does, ``(_unpickle, (host
    array, device type, device id))``, from host copies made
    beforehand."""

    def __init__(self, f, hosts):
        super().__init__(f, protocol=pickle.DEFAULT_PROTOCOL)
        self._hosts = hosts

    def reducer_override(self, obj):
        if isinstance(obj, NDArray):
            return (_nd._unpickle, (self._hosts[id(obj)],
                                    obj.ctx.device_type, obj.ctx.device_id))
        return NotImplemented


def _host_unpickle(arr, devtype, devid):
    """Both packages' ``_unpickle`` as the states unpickler maps them: the
    array on the host, whatever context the blob names (the update places
    it)."""
    return _nd._unpickle(arr, "cpu", 0)


# the globals a states blob may name: the two packages' array
# constructors (by name: the reference is never imported), numpy's array
# reconstruction under numpy 1 and 2, and ml_dtypes' bfloat16
_BLOB_GLOBALS = {
    ("mxnet_tpu.ndarray.ndarray", "_unpickle"): _host_unpickle,
    ("mxnet_tpu_torch.ndarray.ndarray", "_unpickle"): _host_unpickle,
}


def _blob_global(module, name):
    if (module, name) in _BLOB_GLOBALS:
        return _BLOB_GLOBALS[(module, name)]
    allowed = {("numpy", "ndarray"), ("numpy", "dtype"),
               ("ml_dtypes", "bfloat16"), ("_codecs", "encode")}
    for core in ("numpy.core", "numpy._core"):
        allowed |= {(core + ".multiarray", "_reconstruct"),
                    (core + ".multiarray", "scalar"),
                    (core + ".numeric", "_frombuffer")}
    if (module, name) not in allowed:
        raise MXNetError("optimizer states blob names the global %s.%s, "
                         "which a states blob may not hold" % (module, name))
    import importlib
    return getattr(importlib.import_module(module), name)


class _StatesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        return _blob_global(module, name)


def loads_states(blob: bytes):
    """The object a states blob holds, read by the restricted
    unpickler."""
    return _StatesUnpickler(io.BytesIO(blob)).load()


def _fits(cur, new) -> bool:
    """``new`` has ``cur``'s structure, shapes and dtypes."""
    if isinstance(cur, NDArray) and isinstance(new, NDArray):
        return cur.shape == new.shape and cur._tdtype == new._tdtype
    if isinstance(cur, tuple) and isinstance(new, tuple):
        return len(cur) == len(new) and all(map(_fits, cur, new))
    return cur is None and new is None


def _copy_into(cur, new):
    if isinstance(cur, NDArray):
        _write(cur, new.tensor())
    elif isinstance(cur, tuple):
        for c, n in zip(cur, new):
            _copy_into(c, n)


def _place(state, ctx):
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, (tuple, list)):
        return tuple(_place(s, ctx) for s in state)
    return state


class ZeroHyper:
    """One fragment's hyperparameters in a ZeRO step: ``lr``, ``wd`` and
    ``rescale`` as host floats, and ``lr_t``, ``wd_t`` (f32) and
    ``rescale_t`` (the gradient's dtype) as 0-d tensors on the
    fragment's device, for the ops that read them there."""

    __slots__ = ("lr", "wd", "rescale", "lr_t", "wd_t", "rescale_t")

    def __init__(self, lr, wd, rescale, lr_t=None, wd_t=None,
                 rescale_t=None):
        self.lr, self.wd, self.rescale = lr, wd, rescale
        self.lr_t, self.wd_t, self.rescale_t = lr_t, wd_t, rescale_t


class Updater:
    """Per-key state updater (ref: optimizer.py :: Updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        # indices whose loaded state has not met its weight yet
        self._unplaced: set = set()

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        elif index in self._unplaced:
            self._unplaced.discard(index)
            self.states[index] = _place(self.states[index], weight.ctx)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)

    def get_states(self, dump_optimizer=False):
        """The states blob: a pickle of ``{index: state}`` (the
        reference's form), every array copied to the host first with one
        wait for the card. The port does not pickle the optimizer (its
        captured steps and staged tensors live on the card)."""
        if dump_optimizer:
            raise MXNetError("get_states(dump_optimizer=True) is not "
                             "supported: the optimizer holds captured "
                             "steps and device buffers; save its settings "
                             "with the code that builds it")
        arrays = _arrays_of(self.states, [])
        hosts = {id(a): _nd.host_numpy(h) for a, h in
                 zip(arrays, _nd.host_copies([a.tensor() for a in arrays]))}
        buf = io.BytesIO()
        _StatesPickler(buf, hosts).dump(self.states)
        return buf.getvalue()

    def set_states(self, states: bytes):
        """Load a states blob (either package's): see
        :meth:`load_state_dict`."""
        self.load_state_dict(loads_states(states))

    def load_state_dict(self, loaded):
        """Take ``{index: state}``: where the index has a state of the
        same structure, shapes and dtypes, the values are written into
        it (its tensors, which a captured step may read, stay); other
        states move to their weight's context when the index is next
        updated. When a state is not kept, the optimizer's captured
        steps (which read the old tensors and keep them alive) are
        closed, so the next step captures anew."""
        if not isinstance(loaded, dict):
            raise MXNetError("an optimizer states blob holds a dict, not "
                             "%s" % type(loaded).__name__)
        old, self.states, self._unplaced = self.states, {}, set()
        for index, state in loaded.items():
            cur = old.get(index)
            if cur is not None and _fits(cur, state):
                _copy_into(cur, state)
                self.states[index] = cur
            else:
                self.states[index] = state
                self._unplaced.add(index)
        if any(self.states.get(i) is not cur for i, cur in old.items()):
            runners = getattr(self.optimizer, "step_runners", {})
            for runner in runners.values():
                runner.close()
            runners.clear()


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
