"""Monitor: per-op output statistics for numeric debugging (counterpart
of ``mxnet_tpu/monitor.py``; ref: python/mxnet/monitor.py :: Monitor,
tic/toc batch windows).

Every eager op dispatches through ``ndarray.invoke``, so ``install()``
patches it to record ``(step, <op>_output<i>, stat(output))`` for the
ops whose name matches the pattern, and with telemetry on sets
``mx_monitor_stat{name}``. Eager code and non-hybridized Gluon are
seen; a hybridized block's captured graph has no per-op boundary on the
card, as the reference's fused programs have none (on the CPU a
CachedOp runs its ops eagerly, and they are seen)."""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import numpy as np

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Numeric-debugging monitor with two observation modes.

    ``modelwatch=False`` (default, the reference semantics): install()
    patches ``ndarray.invoke`` with a spy that host-syncs on EVERY op
    output matching `pattern` — total per-op visibility (activations
    included), at one blocking device->host read per op. That cost is
    unusable in real runs: a BERT step dispatches hundreds of ops, so
    the spy turns an async pipelined step into hundreds of serial
    round-trips (and hybridized blocks expose no per-op boundary at
    all).

    ``modelwatch=True``: install() subscribes to the on-device
    modelwatch stats stream instead (modelwatch.py — requires
    MXNET_MODELWATCH=1 and a running Trainer): per-layer grad-norm /
    param-norm / update-ratio readings land in the same ``(step, name,
    stat)`` queue at ONE host sync per optimizer step, shared with the
    gradient guard. Tradeoff: parameter-level training dynamics only —
    no activations, no per-op outputs — but cheap enough to leave on
    for an entire production run. Guard events flow into the queue in
    both modes."""

    def __init__(self, interval: int = 1, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False,
                 modelwatch: bool = False):
        self.interval = interval
        self.stat_func = stat_func or (
            lambda x: np.abs(x).mean())
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.modelwatch = bool(modelwatch)
        self.queue: List[Tuple[int, str, object]] = []
        self.step = 0
        self.activated = False
        self._orig_invoke = None
        self._unsub_guard = None
        self._unsub_stats = None

    # ------------------------------------------------------------------
    def install(self):
        """Start observing (ref: Monitor.install on an executor).
        Spy mode patches the eager dispatch path; modelwatch mode
        subscribes to the on-device stats stream (see the class
        docstring for the tradeoff). Exception-safe: a stat_func that
        raises mid-batch uninstalls the spy (restoring the original
        ``ndarray.invoke``) before the error propagates — a broken
        stat must not leave every later op call patched."""
        if self.modelwatch:
            self._install_modelwatch()
            self._install_guard_tap()
            return
        from .ndarray import ndarray as nd_impl
        if self._orig_invoke is not None:
            return
        orig_invoke = self._orig_invoke = nd_impl.invoke
        monitor = self

        def spy_invoke(op, inputs, attrs):
            # the captured orig_invoke (not monitor._orig_invoke, which
            # uninstall() clears) keeps the op path alive even if the
            # monitor is torn down while this frame is live
            result = orig_invoke(op, inputs, attrs)
            if monitor.activated:
                try:
                    monitor._observe(op, result)
                except Exception:
                    monitor.uninstall()
                    raise
            return result

        nd_impl.invoke = spy_invoke
        # the nd namespace and NDArray's methods look invoke up in the
        # module at each call, so the patch is live immediately
        self._install_guard_tap()

    def _install_guard_tap(self):
        """Guardrail events (skip/zero/clip/nonfinite/loss_spike/
        layer_anomaly, engine errors, watchdog fires) land in the same
        stat queue so one monitor window shows numerics AND guard
        decisions."""
        if self._unsub_guard is None:
            from . import guardrails

            def _on_guard(event, monitor=self):
                if monitor.activated:
                    monitor.queue.append(
                        (monitor.step, "guard_%s" % event.get("kind"),
                         event))
            self._unsub_guard = guardrails.on_event(_on_guard)

    def _install_modelwatch(self):
        """Subscribe to the modelwatch stats stream: each sampled step
        delivers per-layer grad/param/update-ratio readings matching
        `pattern` as ``mw_<param>_{grad_norm,param_norm,update_ratio}``
        queue rows — no invoke patch, no per-op syncs."""
        if self._unsub_stats is not None:
            return
        from . import modelwatch as mw_mod

        def _on_stats(entry, monitor=self):
            if not monitor.activated:
                return
            names = entry.get("names", ())
            for i, name in enumerate(names):
                if not monitor.re_pattern.match(name):
                    continue
                monitor.queue.append(
                    (monitor.step, "mw_%s_grad_norm" % name,
                     entry["grad_norms"][i]))
                monitor.queue.append(
                    (monitor.step, "mw_%s_param_norm" % name,
                     entry["param_norms"][i]))
                ratio = entry["update_ratios"][i]
                if ratio is not None:
                    monitor.queue.append(
                        (monitor.step, "mw_%s_update_ratio" % name,
                         ratio))
            noise = entry.get("noise_scale")
            if noise is not None:
                monitor.queue.append(
                    (monitor.step, "mw_grad_noise_scale", noise))
        self._unsub_stats = mw_mod.on_stats(_on_stats)

    def _observe(self, op, result):
        """Record stats for one op invocation. Numeric stats also land
        in the telemetry registry (``mx_monitor_stat{name=}`` gauges)
        so a monitor window shows up in snapshot()/Prometheus output."""
        from . import telemetry
        opname = op if isinstance(op, str) else op.name
        if not self.re_pattern.match(opname):
            return
        outs = result if isinstance(result, tuple) else (result,)
        for i, o in enumerate(outs):
            if isinstance(o, NDArray):
                name = "%s_output%d" % (opname, i)
                stat = self.stat_func(o.asnumpy())
                self.queue.append((self.step, name, stat))
                if telemetry.enabled():
                    try:
                        telemetry.gauge("mx_monitor_stat",
                                        name=name).set(float(stat))
                    except (TypeError, ValueError):
                        pass    # non-scalar stats stay queue-only

    def uninstall(self):
        from .ndarray import ndarray as nd_impl
        if self._orig_invoke is not None:
            nd_impl.invoke = self._orig_invoke
            self._orig_invoke = None
        if self._unsub_guard is not None:
            self._unsub_guard()
            self._unsub_guard = None
        if self._unsub_stats is not None:
            self._unsub_stats()
            self._unsub_stats = None

    # ------------------------------------------------------------------
    def tic(self):
        """Begin collecting for this batch window."""
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []

    def toc(self) -> List[Tuple[int, str, object]]:
        """Stop collecting and return the (step, name, stat) list."""
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        res = list(self.queue)
        if self.sort:
            res.sort(key=lambda e: e[1])
        self.queue = []
        self.step += 1
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            print("Batch: %7d %30s %s" % (step, name, stat))

    def __enter__(self):
        self.install()
        self.tic()
        return self

    def __exit__(self, *exc):
        try:
            self.toc()
        finally:
            self.uninstall()
        return False
