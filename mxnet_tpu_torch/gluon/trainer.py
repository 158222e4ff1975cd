"""Gluon Trainer, the single-device path (counterpart of
``mxnet_tpu/gluon/trainer.py``; ref: python/mxnet/gluon/trainer.py).

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``scale / batch_size`` and applies one update to every parameter whose
``grad_req`` is not ``'null'``: through one ``update_multi`` call when
the optimizer's ``aggregate_num`` (``MXNET_OPTIMIZER_AGGREGATION_SIZE``)
is above 1 and there is more than one parameter, else through the
one-tensor ``update`` of each, as in the reference. With one context
there is nothing to reduce, as in the reference, which then runs no
kvstore either.

``save_states``/``states_blob`` write the updater's states blob (a
pickle of ``{index: state}``, the reference's format) and
``load_states``/``load_states_blob`` read one, either package's; the
optimizer is not in the blob, so its update counters stay this
Trainer's (a fresh Trainer restarts them, as the reference's does).

With ``MXNET_TRAINER_FUSED_UPDATE`` (on by default) a Trainer whose
optimizer is exactly ``SGD``, without ``multi_precision``, with every
``grad_req`` ``write`` or ``null`` and ``aggregate_num`` above 1 arms
:mod:`mxnet_tpu_torch.autograd` after its first step: the next backward
over a tape of hybridized calls is stashed, and ``step`` runs it with the
SGD update appended, as one captured graph on the card (ref:
trainer.py :: _consume_fused_plan). The result equals the separate
update bit for bit. A gradient read or another backward before the step
runs the stashed backward alone, and the step then updates as usual.
With a grad guard (``grad_guard``, from ``MXNET_GUARD_*`` by default;
:mod:`mxnet_tpu_torch.guardrails`) ``step`` checks the gradients in one
reduction and one host read before the update and may skip the step,
zero the bad gradients, raise or clip, as the reference's classic guard
pass does; an enabled guard disarms the fused update, except a
``skip_step`` guard under ``MXNET_SCAN_STEPS`` above 1, which the K-step
chunk carries (:mod:`mxnet_tpu_torch.scan`). Under K-step scan the
armed Trainer pushes each stashed step to its chunk runner, which
retires K of them at once. What this slice does not port raises
``NotImplementedError`` naming its ROADMAP.md item: a kvstore, several
contexts, gradient compression, ``update_on_kvstore``, ZeRO, the kv
finite vote.

With telemetry on (:mod:`mxnet_tpu_torch.telemetry`) ``step`` times its
phases as the reference's does (``fused_step``; or ``allreduce``,
``guard`` or ``modelwatch``, and ``optimizer``) and marks each step,
``useful=False`` for a step the guard skipped. With ``MXNET_MODELWATCH``
(``modelwatch``, from the environment on first use) a sampled step's
per-layer statistics come from the guard's reduction extended, in the
one host read the guard makes: on the classic path before the update
(its update norms ride the next sampled read), on the fused step and at
a K-step chunk's boundary after it. Under AMP (``contrib.amp.init_trainer``) the
Trainer carries the loss scaler, and ``amp.scale_loss`` folds
``1 / loss_scale`` into the scale that ``step`` applies.
"""
from __future__ import annotations

import logging
from typing import List

from .. import autograd
from .. import optimizer as opt_mod
from .. import scan as scan_mod
from .. import telemetry
from ..config import get as _cfg
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _not_ported(what, item):
    return NotImplementedError("Trainer: %s is not ported yet (ROADMAP.md "
                               "queue 1, item %d)" % (what, item))


def _check_features():
    """Raise for the reference's Trainer features this slice leaves out,
    where the environment turns them on."""
    if _cfg("MXNET_ZERO"):
        raise _not_ported("ZeRO (MXNET_ZERO)", 11)
    if _cfg("MXNET_GUARD_COMM_VOTE"):
        raise _not_ported("the kv finite vote (MXNET_GUARD_COMM_VOTE)", 11)


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
        self._fused_structural_bail = False
        self._grad_guard = None        # guardrails.GradGuard (lazy)
        self._guard_resolved = False
        self._modelwatch = None        # modelwatch.ModelWatch (lazy)
        self._mw_resolved = False
        self._scan = None              # MXNET_SCAN_STEPS chunk runner
        self._scan_warned = False

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

    @property
    def grad_guard(self):
        """The guard applied each step (guardrails.GradGuard), made from
        the MXNET_GUARD_* variables on first use; None when every guard
        feature is off. Assign to install one. An AMP loss scaler given
        by ``amp.init_trainer`` is handed to it."""
        if self._grad_guard is None and not self._guard_resolved:
            from .. import guardrails
            self._grad_guard = guardrails.from_env(
                scaler=self._amp_loss_scaler)
            self._guard_resolved = True
        return self._grad_guard

    @grad_guard.setter
    def grad_guard(self, guard):
        self._grad_guard = guard
        self._guard_resolved = True

    @property
    def modelwatch(self):
        """The training-dynamics collector applied each step
        (modelwatch.ModelWatch), made from MXNET_MODELWATCH_* on first
        use; None when the layer is off. Assign to install one."""
        if self._modelwatch is None and not self._mw_resolved:
            from .. import modelwatch as mw_mod
            self._modelwatch = mw_mod.from_env()
            self._mw_resolved = True
        return self._modelwatch

    @modelwatch.setter
    def modelwatch(self, watch):
        self._modelwatch = watch
        self._mw_resolved = True

    def _trainable_named(self):
        """(name, weight) of each parameter with a gradient, in the
        guard's order: the weights of modelwatch's reduction."""
        return [(p.name, p.list_data()[0]) for p in self._params
                if p.grad_req != "null" and p._data is not None]

    def _mw_pre_update(self):
        """The weights before an update that a graph writes (the fused
        step, a chunk), copied on a sampled step; None otherwise."""
        mw = self._modelwatch
        if mw is None or not mw.sampling:
            return None
        return mw.note_pre_update(self._trainable_named())

    def _mw_boundary(self, caps, rescale):
        """modelwatch after an update a graph made: the gradients it
        wrote, the weights before it and the update norms, in one read
        (gradients read without draining anything)."""
        if caps is None:
            return
        mw = self._modelwatch
        with telemetry.phase("modelwatch"):
            unorm = mw.note_post_update(caps, defer=False)
            named = [(p.name, next(iter(p._grad.values())))
                     for p in self._params
                     if p.grad_req != "null" and p._data is not None]
            from ..ndarray import NDArray
            mw.step_report(named, [(n, NDArray(old, arr.context))
                                   for n, old, arr in caps],
                           rescale=rescale, update_now=unorm)

    def _guard_grads(self):
        """(name, gradient) of each parameter with a gradient, in the
        Trainer's order (one context: the arrays the guard writes)."""
        return [(p.name, p.grad()) for p in self._params
                if p.grad_req != "null" and p._data is not None]

    def _guard_arrays(self):
        """The names and gradient tensors of :meth:`_guard_grads`, read
        without draining (a K-step chunk's verdict covers them)."""
        live = [p for p in self._params
                if p.grad_req != "null" and p._data is not None]
        return ([p.name for p in live],
                [next(iter(p._grad.values())).tensor() for p in live])

    def step(self, batch_size, ignore_stale_grad=False):
        """One update of every parameter, gradients scaled by
        1 / batch_size inside the update, after the guard's pass (ref:
        trainer.py :: step). An armed Trainer runs the stashed backward
        with the update appended, or pushes it to its K-step runner."""
        _check_features()
        self._check_contexts()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._scan is None and not self._scan_warned and \
                scan_mod.steps() > 1 and not self._fused_update_eligible():
            # once a Trainer: K-step scan asked for, this loop cannot
            # take it (not SGD, masters, a guard beyond skip_step, ...)
            self._scan_warned = True
            logging.getLogger("mxnet_tpu_torch.scan").warning(
                "MXNET_SCAN_STEPS=%d requested but this Trainer is not "
                "scan-eligible (not fused-update eligible) — running per "
                "step", scan_mod.steps())
        mw = self.modelwatch
        if mw is not None:
            mw.begin_step(batch_size, 1)
        if self._fused_armed:
            pending = autograd.take_pending_step(self)
            done = self._consume_pending(pending) if pending is not None \
                else False
            if done:
                self._rearm_fused_update()
                if done == "fused":
                    telemetry.mark_step()   # a chunk marks its own steps
                return
            self._fused_armed = False
            autograd.disarm_fused_update(self)
        with telemetry.phase("allreduce"):
            self.allreduce_grads()
        guard = self.grad_guard
        guard_on = guard is not None and guard.enabled
        mw_on = mw is not None and mw.sampling
        if guard_on or mw_on:
            with telemetry.phase("guard" if guard_on else "modelwatch"):
                named = self._guard_grads()
                # rescale_grad carries 1 / batch_size: the guard clips
                # the norm the update sees
                rescale = self._optimizer.rescale_grad
                proceed = True
                if mw_on:
                    # one extended reduction and one read serve the
                    # layer statistics and the guard's verdict
                    report = mw.step_report(named, self._trainable_named(),
                                            rescale=rescale)
                    if guard_on:
                        proceed = guard.check(named, rescale=rescale,
                                              report=report)
                else:
                    proceed = guard.check(named, rescale=rescale)
            if not proceed:
                telemetry.mark_step(useful=False)
                return          # a skipped step (counted by the guard)
        with telemetry.phase("optimizer"):
            caps = mw.note_pre_update(self._trainable_named()) \
                if mw_on else None
            self._update()
            if caps:
                mw.note_post_update(caps)
        self._rearm_fused_update()
        telemetry.mark_step()

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone, without the guard (ref: trainer.py ::
        update); a stashed backward runs first, without the update."""
        _check_features()
        self._check_contexts()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _consume_pending(self, pending):
        """Run a stashed step with its update: ``"fused"`` when it ran,
        ``"scan"`` when the chunk runner took it (the chunk marks its
        steps). Checked again now: the flag, the optimizer or the guard
        may have changed since the backward was stashed. False leaves
        the gradients written for the classic path."""
        eligible = self._fused_update_eligible()
        guard = self.grad_guard
        guard_on = guard is not None and guard.enabled
        runner = self._scan_runner() if eligible else None
        if eligible:
            skips = len(runner.steps) if runner is not None and guard_on \
                else 0
            prep = self._prep_fused_plan(pending.leaf_ids, skips)
            if prep is None:
                # recurs every step: stop deferring for nothing
                self._fused_structural_bail = True
            elif runner is not None and runner.push(pending, prep):
                return "scan"
            elif not guard_on:
                caps = self._mw_pre_update()
                with telemetry.phase("fused_step"):
                    self._consume_plan(pending, prep)
                self._mw_boundary(caps, self._optimizer.rescale_grad)
                return "fused"
            else:
                # the guard must see this step: its counters advance
                # again in the classic update
                prep.rewind(self._optimizer)
        pending.execute()
        return False

    def _prep_fused_plan(self, leaf_ids, skips=0):
        """The SGD update's host part for a stashed step whose backward
        writes ``leaf_ids``: the counters advanced now, when the
        per-step path advances them, so a schedule's lr reaches a chunk
        retired later (``skips``: lrs also for that many earlier steps
        of the chunk skipped). None when a parameter is not on the tape
        or has a master weight (the counters untouched)."""
        items = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            w = p.list_data()[0]
            if id(w) not in leaf_ids:
                return None
            items.append((i, next(iter(p._grad.values())), w))
        if not items:
            return None
        states = [self._updater._state(i, w) for i, _, w in items]
        if any(isinstance(s, tuple) for s in states):
            return None
        return self._optimizer.multi_prep(
            [i for i, _, _ in items], [w for _, _, w in items],
            [g for _, g, _ in items], states, skips=skips)

    def _consume_plan(self, pending, prep):
        """The stashed backward with the SGD update appended: one
        captured graph on the card (the optimizer keeps its runner)."""
        key, apply = self._optimizer.multi_plan(None, None, None, None,
                                                prep=prep)
        pending.execute_with_update(self._optimizer.step_runners, key,
                                    apply)

    def _fused_update_eligible(self):
        """The reference's ladder on the port's terms: the flag (and the
        fused backward it rides on), no structural bail, no guard but a
        chunk-compatible one, exactly SGD, no masters, an aggregation
        width above 1, every grad_req write or null; one context and no
        kvstore hold by construction."""
        if not (_cfg("MXNET_TRAINER_FUSED_UPDATE") and
                _cfg("MXNET_FUSED_BACKWARD")):
            return False
        if self._fused_structural_bail:
            return False
        guard = self.grad_guard
        if guard is not None and guard.enabled and \
                not scan_mod.guard_compatible(self, guard):
            return False
        opt = self._optimizer
        if type(opt) is not opt_mod.SGD or opt.multi_precision:
            return False
        if opt.aggregate_num <= 1:
            return False
        return all(p.grad_req in ("null", "write") for p in self._params)

    def _rearm_fused_update(self):
        if self._fused_update_eligible():
            leaf_ids = [id(p.data()) for p in self._params
                        if p.grad_req != "null" and p._data is not None]
            if leaf_ids:
                autograd.arm_fused_update(self, leaf_ids)
                self._fused_armed = True
                runner = self._scan_runner()
                if runner is not None and runner.template is None:
                    # the arming step's backward is the first template
                    runner.adopt(autograd.last_plan())
                return
        if self._fused_armed:
            autograd.disarm_fused_update(self)
        self._fused_armed = False

    def _scan_runner(self):
        """This Trainer's chunk runner, made on first use; None when
        MXNET_SCAN_STEPS is 1 or the runner bailed. A changed K drains
        the old runner and starts one at the new length."""
        k = scan_mod.steps()
        if k <= 1:
            self._scan_flush()
            return None
        r = self._scan
        if r is None or (r.k != k and not r.bailed):
            if r is not None:
                r.flush()
            r = self._scan = scan_mod.ChunkRunner(self, k)
        return None if r.bailed else r

    def _scan_flush(self):
        """Drain a buffered partial chunk (checkpoints)."""
        if self._scan is not None:
            self._scan.flush()

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
        if self._optimizer.aggregate_num > 1 and len(items) > 1:
            self._updater.update_multi([i for i, _, _ in items],
                                       [g for _, g, _ in items],
                                       [w for _, _, w in items])
        else:
            for i, grad, arr in items:
                self._updater(i, grad, arr)

    # ------------------------------------------------------------------
    # the optimizer's states (ref: trainer.py :: save_states ...)
    # ------------------------------------------------------------------
    def save_states(self, fname):
        """Write :meth:`states_blob` to ``fname``."""
        with open(fname, "wb") as f:
            f.write(self.states_blob())

    def states_blob(self) -> bytes:
        """The updater's states, pickled as ``{index: state}`` without the
        optimizer (``get_states(dump_optimizer=False)``); a buffered
        chunk drains first, so the checkpoint lands between chunks."""
        self._scan_flush()
        return self._updater.get_states(dump_optimizer=False)

    def load_states(self, fname):
        """Read a states file written by either package."""
        with open(fname, "rb") as f:
            self.load_states_blob(f.read())

    def load_states_blob(self, states: bytes):
        """Load a states blob. A blob the reference wrapped with its
        quantized-sync residuals (``__mx_quant__``, ``__mx_zero_quant__``)
        loads as its plain states and the residuals are dropped, as the
        reference does on a path without quantization. The optimizer
        stays this Trainer's. A buffered chunk drains first (its steps
        must not replay over the loaded states)."""
        self._scan_flush()
        obj = opt_mod.loads_states(states)
        if isinstance(obj, dict) and obj.get("__mx_quant__"):
            obj = opt_mod.loads_states(obj["updater"])
        elif isinstance(obj, dict) and obj.get("__mx_zero_quant__"):
            obj = obj["states"]
        self._updater.load_state_dict(obj)
        self._updater.optimizer = self._optimizer
