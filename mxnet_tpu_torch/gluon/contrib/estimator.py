"""Estimator-style fit helper (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``; ref: gluon/contrib/estimator).

``fit`` runs the epochs: each batch's production and upload is the
``data`` phase, the recorded forward and loss the ``forward`` phase, the
backward the ``backward`` phase, and ``Trainer.step`` adds its own. With
``ckpt_prefix`` it writes a crash-safe checkpoint every ``ckpt_period``
epochs (``model.save_checkpoint``, with the Trainer's states as the
sidecar, ``max_keep`` or ``MXNET_CKPT_KEEP`` retention) and surfaces a
failed asynchronous write before it returns; ``resume`` restarts from
the newest valid checkpoint, the epochs it holds skipped. Guard events
fired during ``fit`` are kept in ``guard_events`` and passed to
``on_guard_event``.

With ``MXNET_ELASTIC`` (and a trainer) the step loop polls for a
preemption notice every ``MXNET_ELASTIC_POLL`` steps (:mod:`...elastic`)
and moves the live run onto the surviving contexts
(``Trainer.reshard_to``), or, when that fails or too few survive,
restores the newest checkpoint under ``ckpt_prefix`` onto them
(:meth:`Estimator._elastic_restore`). Survivor specs index into the
fit's full context list, so a later notice can grow back. A checkpoint
carries the logical-sharding section of ``reshard.sharding_manifest``
beside the optimizer-state sidecar.
"""
from __future__ import annotations

from ... import autograd
from ... import metric as metric_mod
from ... import telemetry
from ...base import MXNetError
from ..utils import split_and_load

__all__ = ["Estimator"]


class Estimator:
    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None, on_guard_event=None):
        self.net = net
        self.loss = loss
        self.train_metrics = train_metrics or [metric_mod.Accuracy()]
        self.trainer = trainer
        self.context = context if isinstance(context, list) else \
            ([context] if context else None)
        self.on_guard_event = on_guard_event
        self.guard_events = []

    # ------------------------------------------------------------------
    def _net_params(self):
        # structural names (save_parameters' format): a fresh process
        # restores them whatever its prefixes
        if hasattr(self.net, "_structural_params"):
            return self.net._structural_params()
        return self.net.collect_params()

    def _collect_arg_params(self):
        return {name: p.data() for name, p in self._net_params().items()}

    def _restore_arg_params(self, arg_params):
        params = self._net_params()
        missing = [n for n in params if n not in arg_params]
        if missing:
            raise MXNetError(
                "checkpoint is missing parameter(s) %s — wrong prefix or "
                "a different network" % missing)
        for name, p in params.items():
            p.set_data(arg_params[name])

    def resume_from(self, prefix):
        """Load the newest valid checkpoint under ``prefix`` into the net,
        and its optimizer-state sidecar into the trainer; the epoch to
        continue from (0 without a checkpoint)."""
        from ... import model as model_mod
        found = model_mod.load_latest_checkpoint(prefix)
        if found is None:
            return 0
        arg_params, _aux, epoch = found
        self._restore_arg_params(arg_params)
        if self.trainer is not None:
            blob = model_mod.load_checkpoint_states(prefix, epoch)
            if blob is not None:
                self.trainer.load_states_blob(blob)
        return epoch

    def _ckpt_extras(self):
        """The manifest extras of one checkpoint: the logical-sharding
        section and the optimizer-state sidecar (none without a
        trainer)."""
        if self.trainer is None:
            return {}
        from ...parallel import reshard as reshard_mod
        return {"sharding": reshard_mod.sharding_manifest(self.trainer),
                "states_blob": self.trainer.states_blob()}

    def _elastic_restore(self, survivors, prefix):
        """The degradation of a failed (or too small) live transition:
        the trainer reset onto the survivors and the newest valid
        checkpoint restored into it (the parameters and the state
        sidecar, which loads onto any topology). Raises when there is no
        valid checkpoint: nothing is left to continue from."""
        from ... import model as model_mod
        from ... import optimizer as opt_mod
        found = model_mod.load_latest_checkpoint(prefix)
        if found is None:
            raise MXNetError(
                "elastic degradation: no valid checkpoint under %r to "
                "restore from" % prefix)
        arg_params, _aux, epoch = found
        tr = self.trainer
        if tr is not None:
            for p in tr._params:
                if p._data is not None:
                    p.reset_ctx(list(survivors))
            tr._contexts = list(survivors)
            tr._updaters = [opt_mod.get_updater(tr._optimizer)
                            for _ in survivors]
            tr._kvstore = None
            tr._kv_initialized = False
            tr._zero = None
            tr._zero_bailed = False
        self._restore_arg_params(arg_params)
        if tr is not None:
            blob = model_mod.load_checkpoint_states(prefix, epoch)
            if blob is not None:
                tr.load_states_blob(blob)
        return epoch

    # ------------------------------------------------------------------
    def fit(self, train_data, epochs=1, batch_fn=None, ckpt_prefix=None,
            ckpt_period=1, max_keep=None, resume=None):
        """Train until ``epochs`` epochs in all are done (see the module
        docstring)."""
        from ...context import current_context
        from ... import config as config_mod
        from ... import guardrails
        from ... import model as model_mod
        ctxs = self.context or [current_context()]
        full_ctxs = list(ctxs)          # elastic specs index into this
        elastic_on = bool(config_mod.get("MXNET_ELASTIC")) \
            and self.trainer is not None
        if elastic_on:
            from ... import elastic as elastic_mod
            poll_every = max(1, int(config_mod.get("MXNET_ELASTIC_POLL")))
            if config_mod.get("MXNET_ELASTIC_SIGTERM"):
                elastic_mod.install_sigterm_handler()
            if getattr(self.trainer, "_contexts", None):
                # an earlier fit (or restore) may have left the trainer
                # on a survivor set: step on that one
                ctxs = list(self.trainer._contexts)
        start_epoch = 0
        if resume:
            resume_prefix = resume if isinstance(resume, str) \
                else ckpt_prefix
            if not resume_prefix:
                raise ValueError("resume needs ckpt_prefix (or resume="
                                 "'<prefix>')")
            start_epoch = self.resume_from(resume_prefix)

        def _collect(event):
            self.guard_events.append(event)
            if self.on_guard_event is not None:
                self.on_guard_event(event)
        unsub = guardrails.on_event(_collect)
        guard = getattr(self.trainer, "grad_guard", None)
        _end = object()
        step_i = 0
        try:
            for epoch in range(start_epoch, epochs):
                for m in self.train_metrics:
                    m.reset()
                batches = iter(train_data)
                while True:
                    with telemetry.phase("data") as data_span:
                        batch = next(batches, _end)
                        if batch is _end:
                            # the exhausted probe is not a batch
                            data_span.cancel()
                        else:
                            data, label = batch \
                                if isinstance(batch, (list, tuple)) \
                                else (batch.data[0], batch.label[0])
                            xs = split_and_load(data, ctxs)
                            ys = split_and_load(label, ctxs)
                    if batch is _end:
                        break
                    losses = []
                    preds = []
                    with telemetry.phase("forward"):
                        with autograd.record():
                            for x, y in zip(xs, ys):
                                p = self.net(x)
                                losses.append(self.loss(p, y))
                                preds.append(p)
                    with telemetry.phase("backward"):
                        for l in losses:
                            l.backward()
                    self.trainer.step(data.shape[0])
                    if elastic_on:
                        step_i += 1
                        if step_i % poll_every == 0:
                            survivors = elastic_mod.poll_survivors(
                                full_ctxs)
                            if survivors is not None and \
                                    list(survivors) != \
                                    list(self.trainer._contexts):
                                restore = (
                                    lambda s: self._elastic_restore(
                                        s, ckpt_prefix)) \
                                    if ckpt_prefix else None
                                elastic_mod.run_transition(
                                    self.trainer, survivors, restore)
                                ctxs = list(self.trainer._contexts)
                    if guard is not None and guard.spike_enabled:
                        # opt-in (MXNET_GUARD_LOSS_SPIKE): one host read
                        # of the replicas' mean loss a batch
                        dev_mean = losses[0].mean()
                        for l in losses[1:]:
                            dev_mean = dev_mean + l.mean()
                        guard.observe_loss(float(dev_mean.asnumpy())
                                           / max(1, len(losses)))
                    for m in self.train_metrics:
                        m.update(ys, preds)
                if ckpt_prefix and (epoch + 1) % max(1, ckpt_period) == 0:
                    model_mod.save_checkpoint(
                        ckpt_prefix, epoch + 1, None,
                        self._collect_arg_params(), {},
                        max_keep=max_keep, **self._ckpt_extras())
            if ckpt_prefix:
                # a failed asynchronous write surfaces here, not at exit
                model_mod.wait_checkpoints()
        finally:
            unsub()
        return self
