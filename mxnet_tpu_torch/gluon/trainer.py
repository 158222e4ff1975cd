"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``; ref:
python/mxnet/gluon/trainer.py).

``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``scale / batch_size``, sums the gradients through the kvstore, and
applies one update to every parameter whose ``grad_req`` is not
``'null'``: through one ``update_multi`` call a context when the
optimizer's ``aggregate_num`` (``MXNET_OPTIMIZER_AGGREGATION_SIZE``) is
above 1 and there is more than one parameter, else through the
one-tensor ``update`` of each, as in the reference.

The kvstore (``kvstore``: a name or a ``KVStore``) is made at the first
step. With one context and ``local``, ``device`` or ``nccl`` there is
nothing to reduce and no store, as in the reference. Otherwise every
gradient of the step goes through one ``pushpull_list`` (the grouped
reduce; across processes for ``dist_*`` and ``p3store_dist``) inside the
``allreduce`` phase, and each context's replica is updated by its own
updater, the optimizer's counters rewound between contexts so every
replica takes the same step. With ``update_on_kvstore=True`` the
optimizer runs on the store instead, as in MXNet 1.x: the gradients are
pushed, the store updates its weights, and every replica pulls them. A
kvstore or several contexts turn the fused SGD step and K-step scan
off, so no backward is deferred past the reduce. Under
``MXNET_GUARD_COMM_VOTE`` a dist store votes on the gradients'
finiteness before it sums them (:mod:`mxnet_tpu_torch.kvstore.dist`).

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
retires K of them at once. A Trainer over several contexts never
arms the fused update, so ``MXNET_SCAN_STEPS`` leaves its per-step path
unchanged (K = 8 is K = 1 bit for bit).

With ``MXNET_ZERO=1`` an eligible Trainer over two or more contexts
shards its update (:mod:`.zero`): the gradients are reduce-scattered,
each replica updates its 1/N fragment against sharded optimizer state
and the new weights are all-gathered; a Trainer that is not eligible
warns once with the reason and stays replicated. ``compression_params``
(MXNet 1.x's gradient compression) hands the kvstore
``set_gradient_compression``, which puts the gradients on the int8
quantized wire with error feedback (:mod:`..parallel.quantize`);
``MXNET_KVSTORE_QUANTIZE`` does so for the kvstore and ZeRO.
``reshard_to(contexts)`` moves a live Trainer onto another set of
contexts (``elastic.py``).

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


# the in-process stores that one context does not need
_LOCAL_STORES = (None, "local", "device", "nccl")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(list(params.keys()))]
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a list/tuple/ParameterDict")
        self._compression_params = compression_params
        self._params: List[Parameter] = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("invalid parameter %r" % param)
            self._params.append(param)
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        # set by contrib.amp.init_trainer; amp.scale_loss folds
        # 1 / loss_scale into _scale
        self._amp_loss_scaler = None
        self._amp_original_scale = self._scale
        # one updater a context, sharing the optimizer (more are added
        # when the contexts are known: _init_kvstore)
        self._updaters = [opt_mod.get_updater(self._optimizer)]
        self._kvstore_type = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._fused_armed = False      # MXNET_TRAINER_FUSED_UPDATE state
        self._fused_structural_bail = False
        self._grad_guard = None        # guardrails.GradGuard (lazy)
        self._guard_resolved = False
        self._modelwatch = None        # modelwatch.ModelWatch (lazy)
        self._mw_resolved = False
        self._scan = None              # MXNET_SCAN_STEPS chunk runner
        self._scan_warned = False
        # the ZeRO engine: None unresolved, False off, else a ZeroEngine
        self._zero = None
        self._zero_bailed = False

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
    def _updater(self):
        """The first context's updater (the one a single context uses)."""
        return self._updaters[0]

    def _check_contexts(self):
        """The contexts every parameter shares (initialized or waiting
        for deferred initialization); ValueError when two differ (ref:
        trainer.py :: _check_contexts)."""
        contexts = None
        for param in self._params:
            if param._data is not None:
                ctx = param.list_ctx()
            else:
                deferred = getattr(param, "_deferred_init", None)
                ctx = list(deferred[1]) if deferred else []
            if contexts is not None and ctx and contexts != ctx:
                raise ValueError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is on %s while previous "
                    "params are on %s" % (param.name, str(ctx),
                                          str(contexts)))
            if ctx:
                contexts = ctx
        return contexts or []

    def _init_kvstore(self):
        """The store, made at the first step (ref: trainer.py ::
        _init_kvstore): none for one context and an in-process name;
        else the named store (or the given one), every parameter's first
        replica its initial value, and with ``update_on_kvstore`` the
        optimizer on it."""
        from .. import kvstore as kvs_mod
        self._contexts = self._check_contexts()
        while len(self._updaters) < max(1, len(self._contexts)):
            self._updaters.append(opt_mod.get_updater(self._optimizer))
        kv = self._kvstore_type
        if kv is None or (len(self._contexts) <= 1 and
                          isinstance(kv, str) and kv in _LOCAL_STORES):
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            kv = kvs_mod.create(kv) if isinstance(kv, str) else kv
            self._kvstore = kv
            if self._compression_params and \
                    hasattr(kv, "set_gradient_compression"):
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = False
            if self._update_on_kvstore and not kv.is_capable("optimizer"):
                raise ValueError("update_on_kvstore=True needs a kvstore "
                                 "that runs the optimizer (%s does not)"
                                 % getattr(kv, "type", kv))
            for i, param in enumerate(self._params):
                if param._data is not None:
                    kv.init(i, param.data(self._contexts[0]))
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def _ensure_kvstore(self):
        if not self._kv_initialized:
            self._init_kvstore()

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
        """Sum every gradient across the contexts (and processes) through
        the kvstore; nothing to do without one."""
        self._ensure_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One ``pushpull_list`` of every gradient (ref: trainer.py ::
        _allreduce_grads); with ``update_on_kvstore``, each gradient
        pushed (the store updates its weight) and the weights pulled into
        every replica. With a store the ``nan_grad``/``scaled_grad``
        fault sites fire here, before the sum, on this process's first
        replica (a dist store's vote must see them)."""
        kv = self._kvstore
        if kv is None:
            return
        from .. import guardrails
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None]
        guardrails.inject_grad_faults([(p.name, p.list_grad()[0])
                                       for _, p in live])
        if not self._update_on_kvstore and hasattr(kv, "pushpull_list"):
            if live:
                kv.pushpull_list([i for i, _ in live],
                                 [p.list_grad() for _, p in live])
            return
        for i, param in live:
            grads = param.list_grad()
            kv.push(i, grads, priority=-i)
            if self._update_on_kvstore:
                kv.pull(i, param.list_data(), priority=-i)
            else:
                kv.pull(i, grads, priority=-i)

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
        """(name, first replica's gradient) of each parameter with a
        gradient, in the Trainer's order: after the reduce the replicas
        are equal, so one is checked."""
        return [(p.name, p.grad()) for p in self._params
                if p.grad_req != "null" and p._data is not None]

    def _guard_action(self):
        """Every replica's gradient, parameter by parameter, for the
        guard's zero and clip to reach them all; None for one context
        (the checked arrays are the written ones)."""
        if len(self._contexts) <= 1:
            return None
        return [g for p in self._params
                if p.grad_req != "null" and p._data is not None
                for g in p.list_grad()]

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
        with the update appended, or pushes it to its K-step runner; a
        ZeRO Trainer runs its sharded step."""
        self._ensure_kvstore()
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
        if self._zero_step():
            return
        with telemetry.phase("allreduce"):
            from .. import commwatch
            # the gradient sync blocks the step's thread: its collective
            # time is exposed
            with commwatch.exposed_region():
                self._allreduce_grads()
        if self._update_on_kvstore:
            # the store updated the weights and every replica pulled them
            self._rearm_fused_update()
            telemetry.mark_step()
            return
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
                        proceed = guard.check(named, self._guard_action(),
                                              rescale=rescale,
                                              report=report)
                else:
                    proceed = guard.check(named, self._guard_action(),
                                          rescale=rescale)
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
        self._ensure_kvstore()
        if self._update_on_kvstore:
            raise ValueError("update() when update_on_kvstore=True: the "
                             "store updates the weights in step()")
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
        width above 1, every grad_req write or null, one context and no
        kvstore (a deferred backward must not reach a reduce)."""
        if not (_cfg("MXNET_TRAINER_FUSED_UPDATE") and
                _cfg("MXNET_FUSED_BACKWARD")):
            return False
        if self._fused_structural_bail:
            return False
        if self._kvstore is not None or self._update_on_kvstore or \
                len(self._contexts) > 1 or not self._kv_initialized:
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

    # ------------------------------------------------------------------
    # ZeRO weight-update sharding (MXNET_ZERO; gluon/zero.py)
    # ------------------------------------------------------------------
    def _zero_engine(self):
        """This Trainer's ZeRO engine, or None. Resolved at the first
        step with the kvstore up: MXNET_ZERO off is a cheap no that is
        asked again; on but not eligible warns once with the ladder's
        reason and stays replicated for good."""
        if self._zero_bailed:
            return None
        if not self._zero:
            if not _cfg("MXNET_ZERO"):
                self._zero = False
                return None
            from ..base import MXNetError
            from . import zero as zero_mod
            ok, reason = zero_mod.eligibility(self)
            if not ok:
                logging.getLogger("mxnet_tpu_torch.zero").warning(
                    "MXNET_ZERO=1 but the Trainer is not eligible for "
                    "weight-update sharding: %s — using the replicated "
                    "update path", reason)
                telemetry.counter("mx_zero_fallbacks_total",
                                  kind="ineligible").inc()
                self._zero = False
                self._zero_bailed = True
                return None
            try:
                self._zero = zero_mod.ZeroEngine(self)
            except MXNetError:
                self._zero = False
                self._zero_bailed = True
                raise
        return self._zero or None

    def _zero_step(self) -> bool:
        """The sharded step when this Trainer is sharded: True when it
        ran (or the guard skipped it). A structural change (BAIL) hands
        the state to the replicated updaters, warns once and returns
        False: the replicated path takes this step and the later ones."""
        engine = self._zero_engine()
        if engine is None:
            return False
        from . import zero as zero_mod
        status = engine.run_step()
        if status == zero_mod.DONE:
            telemetry.mark_step()
            return True
        if status == zero_mod.SKIPPED:
            telemetry.mark_step(useful=False)
            return True
        engine.dissolve_into(self._updaters, self._contexts)
        self._zero = False
        self._zero_bailed = True
        telemetry.counter("mx_zero_fallbacks_total", kind="bail").inc()
        logging.getLogger("mxnet_tpu_torch.zero").warning(
            "MXNET_ZERO: structural change mid-training — sharded "
            "optimizer state handed back to the replicated path")
        return False

    def optimizer_state_bytes(self) -> int:
        """The optimizer-state bytes across every replica: the fragments'
        total under ZeRO (about 1/N of the replicated), else every
        updater's whole states."""
        from . import zero as zero_mod
        if isinstance(self._zero, zero_mod.ZeroEngine):
            return self._zero.state_bytes_total()
        total = 0
        for upd in self._state_updaters():
            for state in upd.states.values():
                for arr in opt_mod._arrays_of(state, []):
                    t = arr.tensor()
                    total += t.numel() * t.element_size()
        return total

    def _update(self):
        """Each context's replicas through its own updater. The updaters
        share the optimizer, so its counters are rewound between
        contexts: every replica updates from the same step count, and the
        step advances it once (ref: trainer.py :: _update)."""
        per_dev = [[] for _ in self._updaters]
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            for d, (arr, grad) in enumerate(zip(p.list_data(),
                                                p.list_grad())):
                per_dev[d].append((i, grad, arr))
        opt = self._optimizer
        multi = len(self._updaters) > 1
        if multi:
            base_counts = dict(opt._index_update_count)
            base_num = opt.num_update
        for d, (upd, items) in enumerate(zip(self._updaters, per_dev)):
            if multi and d > 0:
                opt._index_update_count = dict(base_counts)
                opt.num_update = base_num
            if opt.aggregate_num > 1 and len(items) > 1:
                upd.update_multi([i for i, _, _ in items],
                                 [g for _, g, _ in items],
                                 [w for _, _, w in items])
            else:
                for i, grad, arr in items:
                    upd(i, grad, arr)

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
        chunk drains first, so the checkpoint lands between chunks.
        Under ZeRO the fragments are gathered to the same replicated
        layout (:meth:`.zero.ZeroEngine.serialized_states`). With the
        kvstore's quantized wire the residuals are carried state: the
        blob becomes the reference's wrapper
        ``{"__mx_quant__": 1, "updater": blob, "kv_residual": {...}}``."""
        self._ensure_kvstore()
        self._scan_flush()
        from . import zero as zero_mod
        if isinstance(self._zero, zero_mod.ZeroEngine):
            return self._zero.serialized_states()
        blob = self._state_updaters()[0].get_states(dump_optimizer=False)
        kv = self._kvstore
        if kv is not None and getattr(kv, "_quant_state", None):
            res = kv.quant_residuals_export()
            if res:
                import pickle
                blob = pickle.dumps({"__mx_quant__": 1, "updater": blob,
                                     "kv_residual": res})
        return blob

    def load_states(self, fname):
        """Read a states file written by either package."""
        with open(fname, "rb") as f:
            self.load_states_blob(f.read())

    def load_states_blob(self, states: bytes):
        """Load a states blob of any topology. Under ZeRO it is
        re-sliced onto this Trainer's fragments. A blob wrapped with the
        quantized wire's residuals (``__mx_quant__``,
        ``__mx_zero_quant__``) hands them to a kvstore that quantizes
        too (the ZeRO weight residual has no replicated counterpart and
        is dropped); the optimizer stays this Trainer's. A buffered chunk
        drains first (its steps must not replay over the loaded
        states)."""
        self._ensure_kvstore()
        self._scan_flush()
        engine = self._zero_engine()
        if engine is not None:
            engine.load_serialized_states(states)
            return
        residual = _states_residual(states)
        kv = self._kvstore
        if residual is not None and kv is not None and \
                hasattr(kv, "quant_residuals_restore"):
            kv.quant_residuals_restore(residual)
        for updater in self._state_updaters():
            # each its own copy of the states: the update places it
            updater.load_state_dict(_states_dict(states))
            updater.optimizer = self._optimizer

    # ------------------------------------------------------------------
    def reshard_to(self, contexts, blk_bytes=None):
        """Move this live Trainer onto another set of contexts, in place
        (ref: trainer.py :: reshard_to):

        1. drain the engine's work and the pending checkpoint writes,
           and a buffered K-step chunk;
        2. rebind every parameter onto ``contexts`` (``reset_ctx``: the
           replicas are equal after a step);
        3. rebuild the replicated updaters' states from replica 0's;
        4. drop the kvstore, which the next step makes anew;
        5. under ZeRO, build the engine for the new contexts and move
           the state fragments (and the quantized wire's residuals)
           device to device through :mod:`..parallel.reshard` in staged
           blocks; a set that cannot shard (one survivor) takes the
           state into the replicated updaters.

        Raises on failure (the ``reshard_fail`` site, a plan mismatch):
        ``elastic.run_transition`` then restores the newest
        checkpoint."""
        from .. import engine as engine_mod
        from .. import faultinject
        from .. import model as model_mod
        from ..parallel.reshard import ReshardError
        from . import zero as zero_mod
        contexts = list(contexts)
        if not contexts:
            raise ValueError("reshard_to: empty context list")
        # the live transition's entry: a replicated move reaches no
        # reshard primitive, so the site fires here too
        faultinject.maybe_fail("reshard_fail", ReshardError)
        engine_mod.native_wait_all()
        model_mod.wait_checkpoints()
        self._scan_flush()
        if self._fused_armed:
            autograd.disarm_fused_update(self)
            self._fused_armed = False
        old_zero = self._zero \
            if isinstance(self._zero, zero_mod.ZeroEngine) else None
        for param in self._params:
            if param._data is not None:
                param.reset_ctx(contexts)
        self._contexts = contexts
        src = self._updaters[0] if self._updaters else None
        self._updaters = [opt_mod.get_updater(self._optimizer)
                          for _ in contexts]
        if src is not None and src.states:
            for upd, ctx in zip(self._updaters, contexts):
                for i, st in src.states.items():
                    upd.states[i] = opt_mod._place(st, ctx)
        self._kvstore = None
        self._kv_initialized = False
        if old_zero is not None:
            self._zero = None
            self._zero_bailed = False
            self._init_kvstore()
            from .. import config as _config
            ok, _why = zero_mod.eligibility(self) \
                if _config.get("MXNET_ZERO") else (False, None)
            if ok:
                engine = zero_mod.ZeroEngine(self)
                engine.reshard_from(old_zero, blk_bytes=blk_bytes)
                self._zero = engine
            else:
                # a set that cannot shard: the moments carry over into
                # the replicated updaters
                old_zero.dissolve_into(self._updaters, contexts)
                self._zero = False
                self._zero_bailed = True

    def _state_updaters(self):
        """The updaters that hold the optimizer's states: the store's
        with ``update_on_kvstore``, else one a context."""
        if self._update_on_kvstore:
            return [self._kvstore._updater]
        return self._updaters


def _states_dict(states: bytes):
    """A states blob's ``{index: state}``, unwrapped from the quantized
    wire's wrappers."""
    obj = opt_mod.loads_states(states)
    if isinstance(obj, dict) and obj.get("__mx_quant__"):
        obj = opt_mod.loads_states(obj["updater"])
    elif isinstance(obj, dict) and obj.get("__mx_zero_quant__"):
        obj = obj["states"]
    if isinstance(obj, tuple) and len(obj) == 2:
        obj = obj[0]            # the dump_optimizer=True form
    return obj


def _states_residual(states: bytes):
    """The kvstore-path residuals a wrapped blob carries, by store key
    (the ZeRO blob's parameter-space gradient residual has the same
    meaning), or None."""
    obj = opt_mod.loads_states(states)
    if isinstance(obj, dict) and obj.get("__mx_quant__"):
        return obj.get("kv_residual") or {}
    if isinstance(obj, dict) and obj.get("__mx_zero_quant__"):
        return {str(k): v for k, v in
                (obj.get("grad_residual") or {}).items()}
    return None
