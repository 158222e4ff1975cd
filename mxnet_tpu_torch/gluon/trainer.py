"""Gluon Trainer, the single-device path (counterpart of
``mxnet_tpu/gluon/trainer.py``; ref: python/mxnet/gluon/trainer.py).

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``scale / batch_size`` and applies one update to every parameter whose
``grad_req`` is not ``'null'``: through one ``update_multi`` call when
there is more than one parameter (the reference's default aggregation),
else through the one-tensor ``update``. With one context there is nothing to reduce, as in the reference,
which then runs no kvstore either.

With ``MXNET_TRAINER_FUSED_UPDATE`` (on by default) a Trainer whose
optimizer is exactly ``SGD``, without ``multi_precision``, with every
``grad_req`` ``write`` or ``null`` and more than one parameter arms
:mod:`mxnet_tpu_torch.autograd` after its first step: the next backward
over a tape of hybridized calls is stashed, and ``step`` runs it with the
SGD update appended, as one captured graph on the card (ref:
trainer.py :: _consume_fused_plan). The result equals the separate
update bit for bit. A gradient read or another backward before the step
runs the stashed backward alone, and the step then updates as usual.
What this slice does not port raises ``NotImplementedError`` naming its
ROADMAP.md item: a kvstore, several contexts, gradient compression,
``update_on_kvstore``, ZeRO, the grad guard, modelwatch, K-step scan
when asked for. Under AMP (``contrib.amp.init_trainer``) the Trainer carries
the loss scaler, and ``amp.scale_loss`` folds ``1 / loss_scale`` into
the scale that ``step`` applies.
"""
from __future__ import annotations

from typing import List

from .. import autograd
from .. import optimizer as opt_mod
from ..config import get as _cfg
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _not_ported(what, item):
    return NotImplementedError("Trainer: %s is not ported yet (ROADMAP.md "
                               "queue 1, item %d)" % (what, item))


def _check_features():
    """Raise for the reference's Trainer features this slice leaves out,
    where the environment turns them on."""
    if _cfg("MXNET_SCAN_STEPS") > 1:
        raise _not_ported("K-step scan (MXNET_SCAN_STEPS)", 7)
    if _cfg("MXNET_ZERO"):
        raise _not_ported("ZeRO (MXNET_ZERO)", 11)
    if _cfg("MXNET_GUARD_NONFINITE") != "off" or \
            _cfg("MXNET_GUARD_CLIP_NORM") > 0:
        raise _not_ported("the grad guard (MXNET_GUARD_*)", 13)
    if _cfg("MXNET_MODELWATCH"):
        raise _not_ported("modelwatch (MXNET_MODELWATCH)", 13)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(list(params.keys()))]
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a list/tuple/ParameterDict")
        if not (kvstore is None or kvstore in ("device", "local")):
            raise _not_ported("kvstore %r" % (kvstore,), 11)
        if compression_params:
            raise _not_ported("gradient compression", 11)
        if update_on_kvstore:
            raise _not_ported("update_on_kvstore", 11)
        self._params: List[Parameter] = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("invalid parameter %r" % param)
            self._params.append(param)
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        # set by contrib.amp.init_trainer; amp.scale_loss folds
        # 1 / loss_scale into _scale
        self._amp_loss_scaler = None
        self._amp_original_scale = self._scale
        self._updater = opt_mod.get_updater(self._optimizer)
        self._fused_armed = False      # MXNET_TRAINER_FUSED_UPDATE state

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be empty for a "
                                 "pre-built Optimizer")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)

    @property
    def learning_rate(self):
        if self._optimizer.lr_scheduler:
            return self._optimizer._get_lr(0)
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Nothing to reduce on one context."""
        self._check_contexts()

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every parameter, gradients scaled by
        1 / batch_size inside the update (ref: trainer.py :: step)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        _check_features()
        self._check_contexts()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._fused_armed:
            plan = autograd.take_pending_step(self)
            if plan is not None and self._fused_update_eligible():
                # checked again now: the flag or optimizer may have
                # changed since the backward was stashed
                items = self._items()
                key, apply = self._optimizer.multi_plan(
                    [i for i, _, _ in items],
                    [w for _, _, w in items], [g for _, g, _ in items],
                    [self._updater._state(i, w) for i, _, w in items])
                plan.execute_with_update(self._optimizer.step_runners,
                                         key, apply)
                self._rearm_fused_update()
                return
            if plan is not None:
                plan.execute()
            self._fused_armed = False
            autograd.disarm_fused_update(self)
        self._update()
        self._rearm_fused_update()

    def _fused_update_eligible(self):
        """The reference's ladder on the port's terms: the flag (and the
        fused backward it rides on), exactly SGD, no masters, every
        grad_req write or null, and the update_multi path (more than one
        parameter); one context and no kvstore hold by construction."""
        if not (_cfg("MXNET_TRAINER_FUSED_UPDATE") and
                _cfg("MXNET_FUSED_BACKWARD")):
            return False
        opt = self._optimizer
        if type(opt) is not opt_mod.SGD or opt.multi_precision:
            return False
        if any(p.grad_req not in ("null", "write") for p in self._params):
            return False
        return sum(1 for p in self._params
                   if p.grad_req != "null" and p._data is not None) > 1

    def _rearm_fused_update(self):
        if self._fused_update_eligible():
            autograd.arm_fused_update(
                self, [id(p.data()) for p in self._params
                       if p.grad_req != "null" and p._data is not None])
            self._fused_armed = True
            return
        if self._fused_armed:
            autograd.disarm_fused_update(self)
        self._fused_armed = False

    def _check_contexts(self):
        ctxs = {tuple(p.list_ctx()) for p in self._params
                if p._data is not None}
        if any(len(c) > 1 for c in ctxs) or len(ctxs) > 1:
            raise _not_ported("training on several contexts", 11)

    def _items(self):
        return [(i, p.grad(), p.data()) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None]

    def _update(self):
        items = self._items()
        if len(items) > 1:
            self._updater.update_multi([i for i, _, _ in items],
                                       [g for _, g, _ in items],
                                       [w for _, _, w in items])
        else:
            for i, grad, arr in items:
                self._updater(i, grad, arr)
