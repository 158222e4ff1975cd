"""modelwatch: training-dynamics observability, per layer (counterpart of
``mxnet_tpu/modelwatch.py``).

When a run diverges the guard can say "non-finite, step 812"; modelwatch
says which layer, shows the update-to-weight ratio that drifted before,
and keeps the last sampled steps for the crash bundle.

The budget is the guard's: one host read a step.

- The per-layer statistics come from the guard's one reduction extended
  (``multi_finite_norm(num_weights=)``): the finiteness flags, every
  gradient's norm and every weight's norm in one vector.
- The update norms come from ``multi_update_norm`` over the weights
  before and after the update. The port's optimizers write the weights
  in place (the reference's rebind them), so the pre-update weights are
  copied on the card first (one multi-tensor copy), ordered on the
  stream before the update (device work only, on sampled steps only).
  The norms are multi-tensor reductions: a sampled step adds a few
  launches, not a few for each parameter.
- The pieces are concatenated on the card and read with ONE ``asnumpy``,
  the read the guard would make; with a guard on, it evaluates its
  policy on this read instead of making its own.

Coverage (``Trainer.step``): the classic update (the update norms of a
sampled step ride the next sampled step's read), the fused SGD step (the
update is in the step's graph; the norms are read in the same step,
after it) and the K-step chunk (sampled at the chunk's boundary, the
update norms over the whole chunk).

Detection: a rolling per-layer z-score names an *exploding* layer
(gradient norm above ``MXNET_MODELWATCH_ZWARN`` deviations) and a *dead*
one (update ratio near 0 for ``DEAD_PATIENCE`` samples), as a
``layer_anomaly`` guard event, counted in
``mx_modelwatch_anomalies_total{kind,param}``. The gradient noise scale
(B_simple, arxiv 1812.06162) needs two data-parallel replicas or more:
before the all-reduce the Trainer stages each replica's per-layer
gradient norms on the first replica's device
(:meth:`ModelWatch.collect_replica_norms`, no host read), the step's one
read carries them, and :meth:`ModelWatch._noise` folds them with the
reduced gradient's norms into ``mx_grad_noise_scale`` and
:meth:`ModelWatch.suggested_batch` (the heartbeat's ``noise_scale=`` and
``suggest_batch=``). On one device it stays absent, as in the reference.

Gauges: ``mx_layer_grad_norm{param}``, ``mx_layer_param_norm{param}``,
``mx_layer_update_ratio{param}``, ``mx_block_grad_norm{block}``,
``mx_block_update_ratio{block}``.
"""
from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import telemetry

__all__ = ["ModelWatch", "enabled", "from_env", "on_stats", "ring",
           "recent_anomalies", "suspects", "block_of", "reset",
           "RING_STEPS"]

_LOG = logging.getLogger("mxnet_tpu_torch.modelwatch")

# the crash bundle's flight recorder: the last K sampled steps, shared
# by every ModelWatch (a process has one postmortem)
RING_STEPS = 120
_RING: "collections.deque[dict]" = collections.deque(maxlen=RING_STEPS)
_ANOMALIES: "collections.deque[dict]" = collections.deque(maxlen=64)
_RING_LOCK = threading.Lock()

_LISTENERS: List[Callable] = []
_LISTENER_LOCK = threading.Lock()

# update ratios below this (with a nonzero weight) count as dead
DEAD_RATIO = 1e-11
# consecutive dead samples before the anomaly fires
DEAD_PATIENCE = 3
# history a layer needs before the z-score judges it
MIN_HISTORY = 8
# one ring entry in N carries a heartbeat line
HEARTBEAT_EVERY = 10

_PARAM_SUFFIXES = ("weight", "bias", "gamma", "beta", "alpha",
                   "moving_mean", "moving_var", "running_mean",
                   "running_var", "mean", "var")


def enabled() -> bool:
    """MXNET_MODELWATCH and MXNET_TELEMETRY both on."""
    from .config import get as _cfg
    return bool(_cfg("MXNET_MODELWATCH")) and telemetry.enabled()


def from_env() -> Optional["ModelWatch"]:
    """A ModelWatch from the MXNET_MODELWATCH_* variables, or None when
    the layer is off."""
    if not enabled():
        return None
    from .config import get as _cfg
    return ModelWatch(every=_cfg("MXNET_MODELWATCH_EVERY"),
                      zwarn=_cfg("MXNET_MODELWATCH_ZWARN"),
                      noise=bool(_cfg("MXNET_NOISE_SCALE")))


def on_stats(callback: Callable) -> Callable[[], None]:
    """Subscribe ``callback(entry)`` to every sample (the ring entry:
    step, names, grad_norms, param_norms, update_ratios, noise_scale,
    anomalies); returns the unsubscribe function."""
    with _LISTENER_LOCK:
        _LISTENERS.append(callback)

    def _unsub():
        with _LISTENER_LOCK:
            try:
                _LISTENERS.remove(callback)
            except ValueError:
                pass
    return _unsub


def ring() -> List[dict]:
    """The last RING_STEPS samples, oldest first."""
    with _RING_LOCK:
        return list(_RING)


def recent_anomalies() -> List[dict]:
    """The recent layer-anomaly records, oldest first."""
    with _RING_LOCK:
        return list(_ANOMALIES)


def suspects() -> List[dict]:
    """Every layer the recent record can blame, most recent first: the
    anomalies, then each layer whose last sampled gradient norm was not
    finite."""
    out = []
    with _RING_LOCK:
        for a in reversed(_ANOMALIES):
            out.append(dict(a))
        for entry in reversed(_RING):
            for name, g in zip(entry.get("names", ()),
                               entry.get("grad_norms", ())):
                if g is not None and not math.isfinite(g):
                    out.append({"param": name, "kind": "nonfinite",
                                "step": entry.get("step"),
                                "grad_norm": g})
            if out:
                break
    seen = set()
    uniq = []
    for s in out:
        key = (s.get("param"), s.get("kind"))
        if key not in seen:
            seen.add(key)
            uniq.append(s)
    return uniq


def reset():
    """Drop the ring and the anomaly records (test isolation)."""
    with _RING_LOCK:
        _RING.clear()
        _ANOMALIES.clear()


def block_of(param_name: str) -> str:
    """The block a parameter rolls up to: 'bertencoder0_ffn1_weight' ->
    'bertencoder0_ffn1' (a known suffix stripped)."""
    if "_" in param_name:
        head, tail = param_name.rsplit("_", 1)
        if tail in _PARAM_SUFFIXES:
            return head
    return param_name


def _f32(v) -> float:
    """A host float rounded through float32: every path's raw norm is a
    float32, so the gauges of different paths compare bit for bit."""
    import numpy as np
    return float(np.float32(v))


def _tensor(a):
    return a.tensor() if hasattr(a, "tensor") else a


class ModelWatch:
    """A Trainer's training-dynamics collector (made lazily, as the
    guard is); the ring, the anomaly log and the listeners are the
    process's."""

    def __init__(self, every: int = 1, zwarn: float = 6.0,
                 noise: bool = True, window: int = 50):
        self.every = max(1, int(every or 1))
        self.zwarn = float(zwarn or 0.0)
        self.noise = bool(noise)
        self.window = max(MIN_HISTORY, int(window))
        self.steps = 0             # begin_step calls
        self.samples = 0           # published samples
        self.anomalies = 0
        self.sync_count = 0        # host reads this instance made
        self.sampling = False      # this step publishes
        self.last: Optional[dict] = None
        self._batch = 0
        self._nrep = 1
        self._hist: Dict[str, collections.deque] = {}
        self._dead_run: Dict[str, int] = {}
        self._streak: set = set()
        self._pending_update = None       # (names, (n,) norm tensor)
        self._last_pnorms: Dict[str, float] = {}
        self._small = []                  # per-replica (p,) norm tensors
        self._noise_ema = {"s": 0.0, "g2": 0.0, "n": 0}
        self.noise_scale: Optional[float] = None

    # ------------------------------------------------------------------
    # the step protocol (Trainer.step)
    # ------------------------------------------------------------------
    def begin_step(self, batch_size: int, nreplicas: int = 1) -> bool:
        """Start one optimizer step; whether it is sampled
        (MXNET_MODELWATCH_EVERY)."""
        self.sampling = (self.steps % self.every) == 0
        self.steps += 1
        self._batch = int(batch_size)
        self._nrep = max(1, int(nreplicas))
        self._small = []
        return self.sampling

    def want_noise(self) -> bool:
        """Replicas give a small-batch estimate only when there are two
        or more; one device has none."""
        return self.noise and self.sampling and self._nrep >= 2

    def collect_replica_norms(self, per_replica_grads) -> None:
        """Before the all-reduce: ``per_replica_grads`` is one list of
        gradient NDArrays a replica, each on its replica's device. One
        ``multi_l2_norm`` a replica, the ``(p,)`` vectors staged on the
        first replica's device for the step's read; nothing is read
        here."""
        if not self.want_noise():
            return
        from .ndarray import invoke
        pieces = []
        for grads_r in per_replica_grads:
            if not grads_r:
                continue
            vec = invoke("multi_l2_norm", list(grads_r),
                         {"num_arrays": len(grads_r)}).tensor()
            dev = pieces[0].device if pieces else vec.device
            pieces.append(vec if vec.device == dev
                          else vec.to(dev, non_blocking=True))
        self._small = pieces

    def step_report(self, named_grads, named_params,
                    rescale: float = 1.0,
                    update_now=None) -> Tuple[List[bool], float]:
        """The step's one reduction and ONE host read: the guard's
        reduction extended with every weight's norm, packed on the card
        with the update-norm vector (the previous sampled step's, or
        ``update_now``, the fused step's own), read once; publishes the
        gauges and events and returns ``(flags, global_norm)``, what
        ``GradGuard.check`` takes as its report."""
        import numpy as np
        import torch
        from . import guardrails
        from .ndarray import invoke
        if not named_grads:
            return [], 0.0
        if update_now is None:
            # before the update: the fault sites poison here, as the
            # guard's own entry point does
            guardrails.inject_grad_faults(named_grads)
        names = [n for n, _ in named_grads]
        grads = [g for _, g in named_grads]
        weights = [w for _, w in named_params]
        n = len(grads)
        k = len(weights)
        stats = invoke("multi_finite_norm", grads + weights,
                       {"num_arrays": n, "num_weights": k}).tensor()
        pieces = [stats]
        same_step = update_now is not None
        if same_step:
            pend, self._pending_update = update_now, None
        else:
            pend, self._pending_update = self._pending_update, None
        if pend is not None:
            pieces.append(pend[1])
        small, self._small = self._small, []
        pieces.extend(small)
        with torch.no_grad():
            packed = torch.cat([p.detach().float().reshape(-1)
                                for p in pieces]) \
                if len(pieces) > 1 else stats
            vec = packed.cpu().numpy().astype(np.float64)
        self.sync_count += 1

        flags = [bool(v > 0) for v in vec[:n]]
        gnorms = [_f32(v) for v in vec[n:2 * n]]
        pnorms = [_f32(v) for v in vec[2 * n:2 * n + k]]
        unames, unorms = None, None
        off = 2 * n + k
        if pend is not None:
            unames = pend[0]
            unorms = [_f32(v) for v in vec[off:off + len(unames)]]
            off += len(unames)
        # the replicas' squared gradient norms, summed
        small_sq = float(np.sum(np.square(vec[off:]))) if small else None
        norm = float(np.sqrt(np.sum(np.square(vec[n:2 * n]))))
        self.publish(names, gnorms, pnorms, unorms, unames, small_sq,
                     rescale=rescale, flags=flags,
                     same_step_update=same_step)
        return flags, norm

    # ------------------------------------------------------------------
    # the update capture, around each path's weight write
    # ------------------------------------------------------------------
    def note_pre_update(self, named_params) -> List[tuple]:
        """Copies of the weights before the update (the optimizers write
        in place), on the card, ordered before the update on the
        stream. Returns the capture for :meth:`note_post_update`."""
        import torch
        if not named_params:
            return []
        with torch.no_grad():
            # x * 1 is x exactly: one multi-tensor copy of every weight
            olds = torch._foreach_mul([_tensor(a).detach()
                                       for _, a in named_params], 1.0)
        return [(name, old, arr)
                for (name, arr), old in zip(named_params, olds)]

    def note_post_update(self, captures, defer: bool = True):
        """Launch ``multi_update_norm`` over (old, new) pairs. ``defer``
        (the classic path, whose read came before the update): the
        vector waits for the next sampled :meth:`step_report`.
        ``defer=False`` (the fused path and the chunk, read after the
        update): ``(names, vector)`` is returned for the same step's
        read."""
        if not captures:
            return None
        from .ndarray import NDArray, invoke
        interleaved = []
        for _name, old, arr in captures:
            interleaved.extend([NDArray(old, arr.context), arr])
        vec = invoke("multi_update_norm", interleaved,
                     {"num_arrays": len(captures)}).tensor()
        pair = ([c[0] for c in captures], vec)
        if defer:
            self._pending_update = pair
            return None
        return pair

    # ------------------------------------------------------------------
    # publication
    # ------------------------------------------------------------------
    def publish(self, names, gnorms, pnorms, unorms=None, unames=None,
                small_sq=None, rescale: float = 1.0, flags=None,
                same_step_update: bool = False):
        """One sample into gauges, anomaly events, the noise scale, the
        ring entry and the listeners. ``gnorms``/``pnorms`` are the raw
        float32 norms (before the rescale); ``unorms`` with ``unames`` the
        update norms, paired with the previous sample's weight norms
        unless ``same_step_update``; ``small_sq`` the replicas' squared
        gradient norms, summed."""
        self.samples += 1
        scale = abs(float(rescale))
        eff = [g * scale for g in gnorms]
        tele_on = telemetry.enabled()
        anomalies = self._detect(names, eff, flags)
        u_pnorms = dict(zip(names, pnorms)) if same_step_update \
            else self._last_pnorms
        ratios = self._update_ratios(unames, unorms, u_pnorms)
        if unames:
            anomalies = anomalies + self.observe_ratio_health(
                unames, ratios, u_pnorms)
        self.noise_scale = self._noise(small_sq, gnorms)
        if tele_on:
            self._gauges(names, eff, pnorms, unames, unorms, ratios,
                         u_pnorms)
        for name, p in zip(names, pnorms):
            self._last_pnorms[name] = p
        entry = {
            "step": self.steps, "t": time.time(), "names": list(names),
            "grad_norms": eff, "param_norms": pnorms,
            "update_ratios": [ratios.get(nm) for nm in names],
            "noise_scale": self.noise_scale,
            "anomalies": anomalies,
            "heartbeat": (self._heartbeat_line()
                          if anomalies
                          or self.samples % HEARTBEAT_EVERY == 1
                          else ""),
        }
        with _RING_LOCK:
            _RING.append(entry)
        self.last = entry
        self._trace_event(entry)
        with _LISTENER_LOCK:
            listeners = list(_LISTENERS)
        for cb in listeners:
            try:
                cb(entry)
            except Exception:
                pass

    def _heartbeat_line(self) -> str:
        try:
            return telemetry.heartbeat_line()
        except Exception:
            return ""

    def _trace_event(self, entry):
        """One chrome-trace event a sample (category ``modelwatch``)."""
        try:
            from . import profiler
            layers = {}
            for i, nm in enumerate(entry["names"]):
                layers[nm] = {"g": entry["grad_norms"][i],
                              "p": entry["param_norms"][i],
                              "r": entry["update_ratios"][i]}
            profiler.record_event(
                "modelwatch::sample", "modelwatch",
                time.perf_counter() * 1e6, 0.0,
                {"step": entry["step"], "layers": layers,
                 "noise_scale": entry["noise_scale"],
                 "anomalies": [a["param"] for a in entry["anomalies"]]})
        except Exception:
            pass

    def _gauges(self, names, eff, pnorms, unames, unorms, ratios,
                u_pnorms):
        by_block: Dict[str, List[float]] = {}
        for name, g, p in zip(names, eff, pnorms):
            telemetry.gauge("mx_layer_grad_norm", param=name).set(g)
            telemetry.gauge("mx_layer_param_norm", param=name).set(p)
            by_block.setdefault(block_of(name), []).append(g * g)
        for blk, sqs in by_block.items():
            telemetry.gauge("mx_block_grad_norm", block=blk).set(
                math.sqrt(sum(sqs)))
        if unorms is not None:
            ub: Dict[str, List[tuple]] = {}
            for name, u in zip(unames, unorms):
                r = ratios.get(name)
                if r is not None:
                    telemetry.gauge("mx_layer_update_ratio",
                                    param=name).set(r)
                p = u_pnorms.get(name, 0.0)
                ub.setdefault(block_of(name), []).append((u * u, p * p))
            for blk, pairs in ub.items():
                usq = sum(u for u, _ in pairs)
                psq = sum(p for _, p in pairs)
                if psq > 0:
                    telemetry.gauge("mx_block_update_ratio",
                                    block=blk).set(
                        math.sqrt(usq) / math.sqrt(psq))
        if self.noise_scale is not None:
            telemetry.gauge("mx_grad_noise_scale").set(self.noise_scale)

    def _update_ratios(self, unames, unorms, u_pnorms) -> Dict[str, float]:
        """Update-to-weight ratios, each update norm over the same step's
        weight norm before the update."""
        out: Dict[str, float] = {}
        if unorms is None:
            return out
        for name, u in zip(unames, unorms):
            p = u_pnorms.get(name)
            if p is not None and p > 0 and math.isfinite(u):
                out[name] = u / p
        return out

    # ------------------------------------------------------------------
    # detection
    # ------------------------------------------------------------------
    def _detect(self, names, eff, flags) -> List[dict]:
        found = []
        if self.zwarn > 0:
            for i, (name, g) in enumerate(zip(names, eff)):
                ok = flags[i] if flags is not None else math.isfinite(g)
                hist = self._hist.get(name)
                if hist is None:
                    hist = self._hist[name] = collections.deque(
                        maxlen=self.window)
                spiked = False
                if ok and math.isfinite(g) and len(hist) >= MIN_HISTORY:
                    mean = sum(hist) / len(hist)
                    var = sum((x - mean) ** 2 for x in hist) / len(hist)
                    # a flat history must not make every wiggle
                    # infinitely anomalous
                    std = max(math.sqrt(var), 1e-3 * abs(mean), 1e-12)
                    z = (g - mean) / std
                    if z > self.zwarn:
                        spiked = True
                        found.append(self._anomaly(
                            "exploding", name, z=z, grad_norm=g,
                            rolling_mean=mean))
                    else:
                        self._streak.discard((name, "exploding"))
                if ok and math.isfinite(g) and not spiked:
                    # a spike stays out of the baseline
                    hist.append(g)
        return found

    def observe_ratio_health(self, names, ratios: Dict[str, float],
                             u_pnorms=None):
        """Dead-layer detection on the update ratios."""
        found = []
        if u_pnorms is None:
            u_pnorms = self._last_pnorms
        for name in names:
            r = ratios.get(name)
            if r is None:
                continue
            p = u_pnorms.get(name, 0.0)
            if r < DEAD_RATIO and p > 0:
                run = self._dead_run.get(name, 0) + 1
                self._dead_run[name] = run
                if run == DEAD_PATIENCE:
                    found.append(self._anomaly(
                        "dead", name, ratio=r, consecutive=run))
            else:
                self._dead_run[name] = 0
                self._streak.discard((name, "dead"))
        return found

    def _anomaly(self, kind: str, name: str, **info) -> dict:
        from . import guardrails
        self.anomalies += 1
        rec = {"kind": kind, "param": name, "block": block_of(name),
               "step": self.steps}
        rec.update(info)
        with _RING_LOCK:
            _ANOMALIES.append(dict(rec))
        telemetry.count_event("mx_modelwatch_anomalies_total",
                              kind=kind, param=name)
        guardrails.emit("layer_anomaly", anomaly=kind, param=name,
                        block=rec["block"], **info)
        if (name, kind) not in self._streak:
            self._streak.add((name, kind))
            _LOG.warning(
                "modelwatch: %s layer %r at step %d (%s)", kind, name,
                self.steps,
                ", ".join("%s=%.3g" % (k, v)
                          for k, v in info.items()
                          if isinstance(v, (int, float))))
        return rec

    # ------------------------------------------------------------------
    # the gradient noise scale (B_simple, arxiv 1812.06162)
    # ------------------------------------------------------------------
    def _noise(self, small_sq, gnorms) -> Optional[float]:
        """B_simple from the small- and large-batch squared norms:
        |G_small|^2 the replicas' average at batch b, |G_big|^2 the
        reduced gradient's at B = nrep * b. The gradients are sums over
        the samples (the rescale carries 1 / batch), so both are brought
        to the per-sample mean before the unbiased estimates, each
        smoothed by its own EMA (the paper's recipe)."""
        if small_sq is None or self._nrep < 2 or self._batch <= 0:
            return self.noise_scale
        b = self._batch / self._nrep
        B = float(self._batch)
        if b <= 0 or B <= b:
            return self.noise_scale
        big_sq = sum(float(g) * float(g) for g in gnorms)
        if not (math.isfinite(small_sq) and math.isfinite(big_sq)):
            return self.noise_scale
        g_small = (small_sq / self._nrep) / (b * b)
        g_big = big_sq / (B * B)
        g2_est = (B * g_big - b * g_small) / (B - b)
        s_est = (g_small - g_big) / (1.0 / b - 1.0 / B)
        ema = self._noise_ema
        alpha = 0.9
        if ema["n"] == 0:
            ema["s"], ema["g2"] = s_est, g2_est
        else:
            ema["s"] = alpha * ema["s"] + (1 - alpha) * s_est
            ema["g2"] = alpha * ema["g2"] + (1 - alpha) * g2_est
        ema["n"] += 1
        if ema["g2"] > 0 and ema["s"] > 0:
            return ema["s"] / ema["g2"]
        return self.noise_scale

    def suggested_batch(self) -> Optional[int]:
        if self.noise_scale is None or not math.isfinite(self.noise_scale):
            return None
        return max(1, int(round(self.noise_scale)))

    def stats(self) -> dict:
        return {"steps": self.steps, "samples": self.samples,
                "anomalies": self.anomalies,
                "noise_scale": self.noise_scale,
                "suggested_batch": self.suggested_batch(),
                "host_reads": self.sync_count}
