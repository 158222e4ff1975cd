"""Training guardrails: the non-finite gradient guard (counterpart of
``mxnet_tpu/guardrails.py``).

* :func:`finite_report` reduces every gradient's finiteness and L2 norm
  in one ``multi_finite_norm`` and one host read; the global norm is
  combined from the per-array norms in float64 on the host, so a large
  but finite gradient set cannot overflow it.
* :class:`GradGuard` applies a policy to a non-finite step
  (``MXNET_GUARD_NONFINITE``): ``raise`` (:class:`NonFiniteGradientError`
  naming the parameters), ``skip_step`` (no update, counted), ``zero``
  (the bad gradients zeroed, the rest applied) or ``off``; it clips the
  global norm after ``rescale_grad`` (``MXNET_GUARD_CLIP_NORM``) from the
  same reduction, watches the loss for spikes
  (``MXNET_GUARD_LOSS_SPIKE``, ``MXNET_GUARD_LOSS_WINDOW``), and drives an
  attached AMP loss scaler's backoff and growth.
* Every decision is an event (``nonfinite``, ``skip``, ``zero``,
  ``clip``, ``loss_spike``) sent to the :func:`on_event` subscribers and
  counted in the telemetry registry (``mx_guard_events_total{kind}``),
  so a decision survives with no subscriber listening.

``inject_grad_faults`` is where the ``nan_grad`` and ``scaled_grad``
fault sites fire (:mod:`mxnet_tpu_torch.faultinject`).
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from .base import MXNetError

__all__ = ["GradGuard", "NonFiniteGradientError", "all_finite",
           "finite_report", "from_env", "on_event", "emit",
           "inject_grad_faults"]


class NonFiniteGradientError(MXNetError):
    """Raised under MXNET_GUARD_NONFINITE=raise, naming the offending
    parameters."""


_LISTENERS: List[Callable] = []
_LISTENER_LOCK = threading.Lock()


def on_event(callback: Callable) -> Callable[[], None]:
    """Subscribe ``callback(event_dict)`` to guard events; returns the
    unsubscribe function. Events carry at least ``kind`` and ``time``."""
    with _LISTENER_LOCK:
        _LISTENERS.append(callback)

    def _unsub():
        with _LISTENER_LOCK:
            try:
                _LISTENERS.remove(callback)
            except ValueError:
                pass
    return _unsub


def emit(kind: str, **info) -> dict:
    """Send a guard event to every subscriber (a subscriber's error is
    swallowed: observing must not stop the step loop) and count it in
    ``mx_guard_events_total{kind}``."""
    event = dict(info)
    event["kind"] = kind
    event["time"] = time.time()
    try:
        from . import telemetry
        telemetry.guard_event(kind)
    except Exception:  # noqa: BLE001 - observers never stop the loop
        pass
    with _LISTENER_LOCK:
        listeners = list(_LISTENERS)
    for cb in listeners:
        try:
            cb(event)
        except Exception:  # noqa: BLE001 - observers never stop the loop
            pass
    return event


def _active_quantize() -> Optional[str]:
    """The quantized wire's mode ('int8'/'fp8') a nonfinite event names,
    or None: the guard checks the dequantized sum, and a block whose
    scale is not finite dequantizes to NaN, so an event under the wire
    tells a bad scale from a model's own blow-up
    (:func:`~.parallel.quantize.active_mode`)."""
    try:
        from .parallel import quantize as qz
        return qz.active_mode()
    except Exception:
        return None


def inject_grad_faults(named_grads) -> None:
    """The ``nan_grad`` site poisons the FIRST gradient with NaN, the
    ``scaled_grad`` site multiplies the LAST by 1e4 (a finite layer out
    of distribution)."""
    from . import faultinject
    if not faultinject.active() or not named_grads:
        return
    if faultinject.should_fail("nan_grad"):
        named_grads[0][1][:] = float("nan")
    if faultinject.should_fail("scaled_grad"):
        g = named_grads[-1][1]
        g *= 1e4


def finite_report(arrays: Sequence) -> Tuple[List[bool], float]:
    """(per-array finite flags, global L2 norm) of ``arrays``: one
    ``multi_finite_norm`` and one host read, the norm combined in
    float64 on the host."""
    if not arrays:
        return [], 0.0
    from .ndarray import invoke
    n = len(arrays)
    vec = invoke("multi_finite_norm", list(arrays),
                 {"num_arrays": n}).asnumpy()
    return _read_report(vec, n)


def _read_report(vec, n) -> Tuple[List[bool], float]:
    """Flags and global norm from a ``multi_finite_norm`` vector read to
    the host (a K-step chunk reads K of them at once)."""
    import numpy as np
    flags = [bool(v > 0) for v in vec[:n]]
    norm = float(np.sqrt(np.sum(np.square(vec[n:].astype(np.float64)))))
    return flags, norm


def all_finite(arrays: Sequence) -> bool:
    """True iff every element of every array is finite: one reduction,
    one host read."""
    flags, _ = finite_report(arrays)
    return all(flags)


class GradGuard:
    """The per-step gradient guard of ``Trainer.step``.

    ``check(named_grads)`` runs the reduction and applies the policy; it
    returns True when the update should proceed. ``named_grads`` is a
    list of ``(param_name, NDArray)``; ``action_grads`` names the arrays
    that zeroing and clipping write (the same by default)."""

    POLICIES = ("off", "raise", "skip_step", "zero")

    def __init__(self, nonfinite: str = "off", clip_norm: float = 0.0,
                 spike_factor: float = 0.0, spike_window: int = 50,
                 scaler=None):
        if nonfinite not in self.POLICIES:
            raise ValueError(
                "MXNET_GUARD_NONFINITE=%r: expected one of %s"
                % (nonfinite, "|".join(self.POLICIES)))
        self.nonfinite = nonfinite
        self.clip_norm = float(clip_norm or 0.0)
        self.spike_factor = float(spike_factor or 0.0)
        self.spike_window = max(2, int(spike_window))
        self.scaler = scaler          # an amp LossScaler, or None
        self.steps = 0
        self.skipped_steps = 0
        self.zeroed_steps = 0
        self.clipped_steps = 0
        self.nonfinite_steps = 0
        self.spikes = 0
        self.sync_count = 0           # host reads the guard itself made
        self.last_norm: Optional[float] = None
        self._losses = collections.deque(maxlen=self.spike_window)

    @classmethod
    def from_env(cls, scaler=None) -> "GradGuard":
        from .config import get as _cfg
        return cls(nonfinite=_cfg("MXNET_GUARD_NONFINITE") or "off",
                   clip_norm=_cfg("MXNET_GUARD_CLIP_NORM"),
                   spike_factor=_cfg("MXNET_GUARD_LOSS_SPIKE"),
                   spike_window=_cfg("MXNET_GUARD_LOSS_WINDOW"),
                   scaler=scaler)

    @property
    def enabled(self) -> bool:
        return self.nonfinite != "off" or self.clip_norm > 0

    @property
    def spike_enabled(self) -> bool:
        return self.spike_factor > 0

    def check(self, named_grads, action_grads=None,
              rescale: float = 1.0, report=None) -> bool:
        """The guard pass over one step's gradients: True if the update
        should proceed, False for a skipped step; one host read.
        ``rescale`` is the factor the optimizer folds into the gradients
        (the Trainer's ``rescale_grad``): the clip threshold applies to
        the norm after it. ``report``, an already read ``(flags,
        norm)``, skips the reduction and the fault injection."""
        if not self.enabled or not named_grads:
            return True
        names = [n for n, _ in named_grads]
        grads = [g for _, g in named_grads]
        action = action_grads if action_grads is not None else grads
        if report is None:
            inject_grad_faults(named_grads)
            flags, norm = finite_report(grads)
        else:
            flags, norm = report
        self.sync_count += 1
        proceed, bad_to_zero, clip_scale = self.evaluate(
            names, flags, norm, rescale=rescale)
        if not proceed:
            return False
        if bad_to_zero:
            bad_set = set(bad_to_zero)
            for (n, _), g in zip(_pair_action(named_grads, action),
                                 action):
                if n in bad_set:
                    g[:] = 0.0
        if clip_scale is not None:
            for g in action:
                g *= clip_scale
        return True

    def evaluate(self, names, flags, norm, rescale: float = 1.0):
        """The policy on a report already read: the counters, events and
        scaler bookkeeping of :meth:`check` without the reduction or the
        writes. Returns ``(proceed, names_to_zero, clip_scale)``."""
        self.steps += 1
        norm = norm * abs(float(rescale))
        self.last_norm = norm
        if not all(flags):
            bad = [n for n, ok in zip(names, flags) if not ok]
            self.nonfinite_steps += 1
            emit("nonfinite", params=bad, policy=self.nonfinite,
                 step=self.steps, quantize=_active_quantize())
            if self.nonfinite == "off":
                # a clip-only guard observes and counts, and touches
                # nothing (the clip below skips a non-finite norm too)
                return True, [], None
            if self.scaler is not None:
                self.scaler.backoff()
            if self.nonfinite == "raise":
                raise NonFiniteGradientError(
                    "non-finite gradient(s) in parameter(s) %s at guard "
                    "step %d (MXNET_GUARD_NONFINITE=raise; use skip_step "
                    "or zero to continue past bad steps)"
                    % (bad, self.steps))
            if self.nonfinite == "skip_step":
                self.skipped_steps += 1
                emit("skip", params=bad, step=self.steps,
                     skipped=self.skipped_steps)
                return False, [], None
            self.zeroed_steps += 1
            emit("zero", params=bad, step=self.steps)
            return True, bad, None
        if self.scaler is not None and self.nonfinite != "off":
            # the guard keeps the scale only where it owns the overflow
            # policy; under 'off' the scaler's unscale_and_check does
            self.scaler.good_step()
        if self.clip_norm > 0 and norm > self.clip_norm \
                and math.isfinite(norm):
            self.clipped_steps += 1
            emit("clip", norm=norm, clip_norm=self.clip_norm,
                 step=self.steps)
            return True, [], self.clip_norm / (norm + 1e-12)
        return True, [], None

    def observe_loss(self, loss_value: float) -> bool:
        """Feed one loss read on the host to the spike detector; True
        when it is a spike (above ``spike_factor`` times the rolling
        mean of the window)."""
        if not self.spike_enabled:
            return False
        v = float(loss_value)
        spiked = False
        if len(self._losses) >= 2 and math.isfinite(v):
            mean = sum(self._losses) / len(self._losses)
            if math.isfinite(mean) and mean > 0 \
                    and v > self.spike_factor * mean:
                spiked = True
                self.spikes += 1
                emit("loss_spike", loss=v, rolling_mean=mean,
                     factor=self.spike_factor, step=self.steps)
        if math.isfinite(v):
            self._losses.append(v)
        return spiked

    def stats(self) -> dict:
        return {"steps": self.steps, "skipped": self.skipped_steps,
                "zeroed": self.zeroed_steps, "clipped": self.clipped_steps,
                "nonfinite": self.nonfinite_steps, "spikes": self.spikes,
                "last_norm": self.last_norm,
                "device_syncs": self.sync_count}


def _pair_action(named_grads, action):
    """The action arrays named: one to one with ``named_grads``, or
    grouped by parameter when there are several per parameter."""
    if len(action) == len(named_grads):
        return named_grads
    per = len(action) // max(1, len(named_grads))
    out = []
    for n, g in named_grads:
        out.extend([(n, g)] * per)
    return out


def from_env(scaler=None) -> Optional[GradGuard]:
    """A GradGuard from the MXNET_GUARD_* variables, or None when every
    guard feature is off."""
    guard = GradGuard.from_env(scaler=scaler)
    return guard if (guard.enabled or guard.spike_enabled) else None
