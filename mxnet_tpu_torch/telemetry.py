"""Runtime telemetry: the process-wide metrics registry and span timing
(counterpart of ``mxnet_tpu/telemetry.py``).

Three instrument kinds in one flat registry, with the reference's names,
labels and log-scale buckets, so one dashboard reads both packages:

- :class:`Counter`: monotonic totals (``counter(name, **labels).inc()``);
- :class:`Gauge`: point-in-time values;
- :class:`Histogram`: 4 buckets a decade from 1e-6 to 1e3 (seconds),
  with count, sum, min and max, percentiles from the bucket counts.

:class:`span` times a region into the chrome-trace profiler (whenever
it runs) and into a latency histogram (when telemetry is on);
:func:`phase` is the per-step breakdown (``mx_step_phase_seconds``).
Spans time the host's dispatch, as the reference's do over its
asynchronous programs: nothing here synchronises the card or reads a
device tensor, so a span or a counter inside a CUDA graph capture adds
no work to the graph.

Everything is gated on ``MXNET_TELEMETRY``, read once and cached (call
:func:`refresh` after changing the environment).

Exposure: :func:`snapshot` (a plain dict), :func:`render_prometheus`
(text exposition) and a heartbeat line every
``MXNET_TELEMETRY_HEARTBEAT`` seconds on the ``mxnet_tpu_torch.telemetry``
logger. :func:`crash_bundle` writes every surface into one directory when
a run dies for a reason the guard or the engine can name.

The MFU gauge divides the FLOPs the card executed (compilewatch counts
each captured graph's replays, ``mx_executed_flops_total``) by the wall
time and :func:`peak_flops`: ``MXNET_PEAK_FLOPS``, else the card's
published bf16 dense rate by ``torch.cuda.get_device_name()``. On a
device that table does not know (the CPU included) ``mx_mfu`` is not
exported: the reference falls back to a TPU's rate there.

The fleet view is one rank's: the port has no process group yet, and a
gather across ranks raises (ROADMAP.md queue 1, item 11). :func:`refresh`
and :func:`reset` reach the distributed tracing of :mod:`.tracing` too;
the reference's communication and performance-record modules, which
they also reach there, come with items 11 and 15. The heartbeat gains a
``serve=`` section once the process serves and a ``trace=`` section
once it traces.
"""
from __future__ import annotations

import bisect
import collections
import json as _json
import logging
import os as _os
import threading
import time
from typing import Dict, Optional, Tuple

from . import profiler

__all__ = ["Counter", "Gauge", "Histogram", "span", "phase", "counter",
           "gauge", "histogram", "enabled", "enable", "refresh",
           "snapshot", "render_prometheus", "mark_step",
           "heartbeat_line", "count_event", "guard_event",
           "fault_event", "checkpoint_event", "reset",
           "memory_snapshot", "memory_diff", "ndarray_live",
           "parse_metric_key", "debit_stall", "peak_flops",
           "local_fleet_stats", "fleet_snapshot", "fleet_last",
           "FLEET_FIELDS", "crash_bundle", "install_crash_bundler"]

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry")


# ---------------------------------------------------------------------------
# the gate: one cached attribute read on every hot-path check
# ---------------------------------------------------------------------------
class _State:
    __slots__ = ("on",)

    def __init__(self):
        self.on: Optional[bool] = None     # None: not resolved yet


_STATE = _State()


def _resolve() -> bool:
    from .config import get as _cfg
    _STATE.on = bool(_cfg("MXNET_TELEMETRY"))
    if _STATE.on:
        _maybe_start_heartbeat()
    return _STATE.on


def enabled() -> bool:
    """Whether telemetry collection is on (``MXNET_TELEMETRY``, read once
    and cached; :func:`refresh` drops the cache)."""
    on = _STATE.on
    if on is None:
        on = _resolve()
    return on


def enable(on: bool = True):
    """Override the gate; turning it off stops the heartbeat."""
    _STATE.on = bool(on)
    if on:
        _maybe_start_heartbeat()
    else:
        _stop_heartbeat()


def refresh():
    """Drop the cached gate, the heartbeat and the cached peak rate so
    the next check reads the environment again."""
    _STATE.on = None
    _stop_heartbeat()
    _PEAK[0] = None
    try:
        from . import tracing
        tracing.refresh()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------
# log-scale bucket bounds: 4 a decade, 1e-6 .. 1e3 (seconds)
BUCKETS: Tuple[float, ...] = tuple(10.0 ** (e / 4.0)
                                   for e in range(-24, 13))


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "labels", "_lock", "value")

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, delta: float = 1.0):
        with self._lock:
            self.value += delta

    def get(self) -> float:
        return self.value


class Gauge:
    """Point-in-time value (thread-safe)."""

    __slots__ = ("name", "labels", "_lock", "value")

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float):
        with self._lock:
            self.value = float(value)

    def inc(self, delta: float = 1.0):
        with self._lock:
            self.value += delta

    def dec(self, delta: float = 1.0):
        with self._lock:
            self.value -= delta

    def get(self) -> float:
        return self.value


class Histogram:
    """Fixed log-scale-bucket histogram (thread-safe); every instance
    shares :data:`BUCKETS`, so histograms aggregate across processes."""

    __slots__ = ("name", "labels", "_lock", "counts", "count", "sum",
                 "min", "max")

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.counts = [0] * (len(BUCKETS) + 1)   # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float):
        v = float(value)
        i = bisect.bisect_left(BUCKETS, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, p: float) -> float:
        """The p-th percentile (0..100) from the bucket counts: the upper
        bound of the bucket holding the rank, capped at the maximum."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            rank = p / 100.0 * total
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank and c:
                    if i < len(BUCKETS):
                        return min(BUCKETS[i], self.max)
                    return self.max
            return self.max

    def summary(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
            mn = self.min if self.count else 0.0
            mx = self.max if self.count else 0.0
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
_REG_LOCK = threading.Lock()
_METRICS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}


def _instrument(cls, name: str, labels: dict):
    key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    m = _METRICS.get(key)
    if m is None:
        with _REG_LOCK:
            m = _METRICS.get(key)
            if m is None:
                m = cls(name, key[1])
                _METRICS[key] = m
    if type(m) is not cls:
        raise TypeError("metric %r already registered as %s"
                        % (name, type(m).__name__))
    return m


def counter(name: str, /, **labels) -> Counter:
    return _instrument(Counter, name, labels)


def gauge(name: str, /, **labels) -> Gauge:
    return _instrument(Gauge, name, labels)


def histogram(name: str, /, **labels) -> Histogram:
    return _instrument(Histogram, name, labels)


def reset():
    """Drop every instrument, the step clock and the meter window, the
    fleet view and the crash-bundle budget (test isolation)."""
    with _REG_LOCK:
        _METRICS.clear()
    with _STEP_LOCK:
        _STEP["count"] = 0
        _STEP["last"] = None
        _STEP["t0"] = None
        _STEP["useful_s"] = 0.0
        _STEP["stall_s"] = 0.0
        _STEP["flops0"] = 0.0
        _STEP["compile_at_last"] = 0.0
    with _FLEET_LOCK:
        _FLEET["last"] = None
    with _BUNDLE_LOCK:
        _BUNDLE["written"] = 0
        if _BUNDLE["recent"] is not None:
            _BUNDLE["recent"].clear()
    try:
        from . import tracing
        tracing.reset()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# spans: chrome trace and latency histogram in one context manager
# ---------------------------------------------------------------------------
class span:
    """Time a region into the chrome-trace profiler (category ``cat``)
    and, with telemetry on, into histogram ``hist`` with ``labels``.
    Instrumentation failures are swallowed; ``cancel()`` drops the
    record. Host time only: no synchronisation, no device read."""

    __slots__ = ("name", "cat", "hist", "labels", "args", "_t0", "_live")

    def __init__(self, name: str, cat: str = "telemetry",
                 hist: Optional[str] = None, args: Optional[dict] = None,
                 **labels):
        self.name = name
        self.cat = cat
        self.hist = hist
        self.labels = labels
        self.args = args

    def cancel(self):
        self._live = False

    def __enter__(self):
        try:
            self._live = enabled() or profiler.state() == "run"
            if self._live:
                self._t0 = time.perf_counter()
        except Exception:
            self._live = False
        return self

    def __exit__(self, *exc):
        if not self._live:
            return False
        try:
            t1 = time.perf_counter()
            dt = t1 - self._t0
            profiler.record_event(self.name, self.cat, self._t0 * 1e6,
                                  dt * 1e6, self.args)
            if self.hist is not None and enabled():
                histogram(self.hist, **self.labels).observe(dt)
        except Exception:
            pass
        return False


def phase(name: str) -> span:
    """A step-phase span: chrome-trace event ``step::<name>`` (category
    ``step``) and ``mx_step_phase_seconds{phase=<name>}``. Phases: data,
    forward, backward, allreduce, optimizer, guard, fused_step,
    modelwatch."""
    return span("step::%s" % name, "step", hist="mx_step_phase_seconds",
                phase=name)


# ---------------------------------------------------------------------------
# the step clock: per-step time, the MFU and goodput meters
# ---------------------------------------------------------------------------
_STEP_LOCK = threading.Lock()
_STEP = {"count": 0, "last": None, "t0": None, "useful_s": 0.0,
         "stall_s": 0.0, "flops0": 0.0, "compile_at_last": 0.0}

# published bf16 dense tensor rates by card name (NVIDIA data sheets);
# the first fragment found in the name wins
_PEAK_BY_NAME = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
                 ("H100", 989e12), ("H200", 989e12), ("A100", 312e12))
_PEAK = [None]          # cached; refresh() drops it


def peak_flops() -> float:
    """Peak FLOP/s the MFU gauge divides by: ``MXNET_PEAK_FLOPS`` when
    set, else the card's entry in the table of published rates; 0 when
    neither knows the device (then ``mx_mfu`` is not exported)."""
    v = _PEAK[0]
    if v is not None:
        return v
    try:
        from .config import get as _cfg
        v = float(_cfg("MXNET_PEAK_FLOPS"))
    except Exception:
        v = 0.0
    if v <= 0:
        v = 0.0
        try:
            import torch
            if torch.cuda.is_available():
                name = torch.cuda.get_device_name(0)
                for fragment, flops in _PEAK_BY_NAME:
                    if fragment in name:
                        v = flops
                        break
        except Exception:
            pass
    _PEAK[0] = v
    return v


def _executed_flops() -> float:
    m = _METRICS.get(("mx_executed_flops_total", ()))
    return m.get() if m is not None else 0.0


def _compile_seconds() -> float:
    try:
        from . import compilewatch
        return compilewatch.compile_seconds_total()
    except Exception:
        return 0.0


def debit_stall(seconds: float, kind: str = "checkpoint"):
    """Charge a loop stall (a checkpoint wait, an eval pause) against
    goodput, counted into ``mx_stall_seconds_total{kind}``."""
    try:
        if not enabled() or seconds <= 0:
            return
        with _STEP_LOCK:
            _STEP["stall_s"] += float(seconds)
        counter("mx_stall_seconds_total", kind=kind).inc(seconds)
    except Exception:
        pass


def mark_step(useful: bool = True, n: int = 1, skipped: int = 0):
    """One optimizer step (``n`` for a K-step chunk): counts
    ``mx_steps_total``, observes the wall time since the previous mark
    into ``mx_step_seconds`` (split into n equal steps), and updates
    ``mx_goodput`` (useful time over wall time: a skipped step's
    interval, the ``skipped`` share of a chunk's, stalls and compile
    seconds are debited) and ``mx_mfu`` (executed FLOPs over wall time
    and :func:`peak_flops`, over the window since the first mark)."""
    if not enabled():
        return
    n = max(1, int(n))
    skipped = min(n, max(0, int(skipped)))
    now = time.perf_counter()
    flops_now = _executed_flops()
    compile_now = _compile_seconds()
    with _STEP_LOCK:
        last = _STEP["last"]
        _STEP["last"] = now
        prev_count = _STEP["count"]
        _STEP["count"] = prev_count + n
        if last is None:
            _STEP["t0"] = now
            _STEP["flops0"] = flops_now
            _STEP["compile_at_last"] = compile_now
        else:
            dt = now - last
            compile_dt = max(0.0, compile_now - _STEP["compile_at_last"])
            _STEP["compile_at_last"] = compile_now
            if useful:
                _STEP["useful_s"] += max(0.0, dt - compile_dt) \
                    * (n - skipped) / n
            t0 = _STEP["t0"]
            wall = now - t0 if t0 is not None else 0.0
            useful_s = max(0.0, _STEP["useful_s"] - _STEP["stall_s"])
            flops0 = _STEP["flops0"]
        count = _STEP["count"]
    counter("mx_steps_total").inc(n)
    if last is not None:
        h = histogram("mx_step_seconds")
        for _ in range(n):
            h.observe((now - last) / n)
        if wall > 0:
            gauge("mx_goodput").set(min(1.0, useful_s / wall))
            peak = peak_flops()
            if peak > 0:
                gauge("mx_mfu").set((flops_now - flops0) / wall / peak)
    _maybe_fleet_tick(count, prev_count)


def _maybe_fleet_tick(step_count: int, prev_count: int = None):
    """``MXNET_FLEET_SNAPSHOT_PERIOD``: merge the fleet view each time the
    step count crosses a multiple of the period."""
    try:
        from .config import get as _cfg
        period = int(_cfg("MXNET_FLEET_SNAPSHOT_PERIOD"))
        if period <= 0 or step_count == 0:
            return
        if prev_count is None:
            prev_count = step_count - 1
        if step_count // period == prev_count // period:
            return
        fleet_snapshot()
    except Exception:
        pass


# ---------------------------------------------------------------------------
# the fleet view: one rank here (ROADMAP.md queue 1, item 11)
# ---------------------------------------------------------------------------
FLEET_FIELDS = ("steps", "step_mean", "step_p50", "step_p99",
                "comm_seconds", "exposed_comm_seconds", "comm_bytes",
                "guard_events", "recompiles", "mfu", "goodput",
                "grad_noise_scale", "anomalies")

_FLEET_LOCK = threading.Lock()
_FLEET = {"last": None}


def local_fleet_stats() -> dict:
    """This rank's row of the fleet view, read from the registry (the
    communication fields stay 0: nothing communicates yet)."""
    st = _METRICS.get(("mx_step_seconds", ()))
    with _STEP_LOCK:
        steps = _STEP["count"]
    out = {k: 0.0 for k in FLEET_FIELDS}
    out["steps"] = float(steps)
    if st is not None and st.count:
        out["step_mean"] = st.sum / st.count
        out["step_p50"] = st.percentile(50)
        out["step_p99"] = st.percentile(99)
    with _REG_LOCK:
        for m in _METRICS.values():
            if m.name == "mx_guard_events_total":
                out["guard_events"] += m.get()
            elif m.name == "mx_recompiles_total":
                out["recompiles"] += m.get()
            elif m.name == "mx_modelwatch_anomalies_total":
                out["anomalies"] += m.get()
    mfu = _METRICS.get(("mx_mfu", ()))
    gp = _METRICS.get(("mx_goodput", ()))
    noise = _METRICS.get(("mx_grad_noise_scale", ()))
    out["mfu"] = mfu.get() if mfu else 0.0
    out["goodput"] = gp.get() if gp else 0.0
    out["grad_noise_scale"] = noise.get() if noise else 0.0
    return out


def _world_size() -> int:
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
    except Exception:
        pass
    return 1


def fleet_snapshot(timeout: Optional[float] = None) -> dict:
    """The fleet view, with the reference's schema: ``{"nw", "rank",
    "ranks", "slowest", "skew", "phase", "step_mean_median"}`` and the
    ``mx_fleet_*`` gauges. One process is a fleet of one rank; under a
    process group of several the gather raises (ROADMAP.md queue 1, item
    11)."""
    if not enabled():
        return {}
    if _world_size() > 1:
        from .base import MXNetError
        raise MXNetError("telemetry.fleet_snapshot: gathering the fleet "
                         "view across ranks is not ported yet (ROADMAP.md "
                         "queue 1, item 11)")
    local = local_fleet_stats()
    ranks = [dict(local)]
    med = ranks[0]["step_mean"]
    view = {"nw": 1, "rank": 0, "ranks": ranks, "slowest": 0, "skew": 0.0,
            "phase": "compute", "step_mean_median": med}
    gauge("mx_fleet_ranks").set(1)
    gauge("mx_fleet_step_skew").set(0.0)
    gauge("mx_fleet_slowest_rank").set(0)
    with _FLEET_LOCK:
        _FLEET["last"] = view
    return view


def fleet_last() -> Optional[dict]:
    """The most recently merged fleet view (None before the first)."""
    with _FLEET_LOCK:
        return _FLEET["last"]


# ---------------------------------------------------------------------------
# event hooks: guardrails, faultinject and checkpoints call these
# ---------------------------------------------------------------------------
def count_event(name: str, /, **labels):
    """A counter increment that never raises (failure paths call it);
    a no-op with telemetry off."""
    try:
        if enabled():
            counter(name, **labels).inc()
    except Exception:
        pass


def guard_event(kind: str):
    """One guard event -> ``mx_guard_events_total{kind}``."""
    count_event("mx_guard_events_total", kind=kind)


def fault_event(site: str):
    """One fault fire -> ``mx_fault_injections_total{site}``."""
    count_event("mx_fault_injections_total", site=site)


def checkpoint_event(ok: bool):
    """One checkpoint write -> ``mx_checkpoint_writes_total`` or
    ``mx_checkpoint_errors_total``."""
    count_event("mx_checkpoint_writes_total" if ok
                else "mx_checkpoint_errors_total")


# ---------------------------------------------------------------------------
# live-NDArray accounting, fed by NDArray while the gate is on. Bytes are
# counted once a storage: every tracked array over one storage (a detach,
# a view, a graph's alias) shares its box, and the storage's bytes leave
# the totals with the last of them. A collected array's finalizer only
# queues its box (it may run inside any allocation, a lock's holder
# included); the queue drains at the next track or read. The totals
# survive reset() and are mirrored into mx_ndarray_live_bytes{ctx} /
# mx_ndarray_live_count{ctx}.
# ---------------------------------------------------------------------------
_MEM_LOCK = threading.Lock()
_LIVE_ND: Dict[str, list] = {}      # ctx key -> [bytes, count]
_STORAGES: Dict[tuple, list] = {}   # (ctx key, storage ptr) -> box
_RELEASED: "collections.deque[list]" = collections.deque()


def _mirror_nd(key: str, nbytes: float, count: float):
    try:
        if _STATE.on:
            gauge("mx_ndarray_live_bytes", ctx=key).set(nbytes)
            gauge("mx_ndarray_live_count", ctx=key).set(count)
            return
        # gate off (a release after reset()): update existing gauges
        # only, never register new ones
        lab = (("ctx", key),)
        m = _METRICS.get(("mx_ndarray_live_bytes", lab))
        if m is not None:
            m.set(nbytes)
        m = _METRICS.get(("mx_ndarray_live_count", lab))
        if m is not None:
            m.set(count)
    except Exception:
        pass


def _drain_released():
    """Apply the queued releases (the caller holds _MEM_LOCK)."""
    while True:
        try:
            box = _RELEASED.popleft()
        except IndexError:
            return
        box[3] -= 1
        if box[3] > 0:
            continue
        key = box[0]
        if _STORAGES.get((key, box[1])) is box:
            del _STORAGES[(key, box[1])]
        rec = _LIVE_ND.setdefault(key, [0, 0])
        rec[0] -= box[2]
        rec[1] -= 1
        _mirror_nd(key, rec[0], rec[1])


def _ndarray_track(key: str, sptr: int, nbytes: int) -> list:
    """One more tracked array over storage ``sptr`` of ``nbytes`` on
    context ``key``; returns the storage's box ``[key, sptr, nbytes,
    arrays]`` for :func:`_ndarray_release`."""
    with _MEM_LOCK:
        _drain_released()
        skey = (key, sptr)
        box = _STORAGES.get(skey)
        rec = _LIVE_ND.setdefault(key, [0, 0])
        if box is None:
            box = _STORAGES[skey] = [key, sptr, nbytes, 0]
            rec[0] += nbytes
            rec[1] += 1
        box[3] += 1
        _mirror_nd(key, rec[0], rec[1])
        return box


def _ndarray_release(box):
    """weakref.finalize target (and a rebind's): one tracked array over
    the box's storage is gone; queued, applied at the next drain."""
    _RELEASED.append(box)


def ndarray_live(ctx_key: Optional[str] = None) -> dict:
    """Live tracked-NDArray footprint: ``{"bytes", "count"}`` of one
    context key (``"gpu(0)"``), or ``{key: {...}}`` of all. ``count``
    counts storages. Tracks arrays made while telemetry was on."""
    with _MEM_LOCK:
        _drain_released()
        if ctx_key is not None:
            b, c = _LIVE_ND.get(ctx_key, (0, 0))
            return {"bytes": b, "count": c}
        return {k: {"bytes": v[0], "count": v[1]}
                for k, v in _LIVE_ND.items()}


def _jit_cache_info() -> dict:
    """Sizes of the program caches: compilewatch's watched sites and
    their signatures (eager ops compile nothing here)."""
    info: Dict[str, object] = {}
    try:
        from . import compilewatch
        fns, progs = compilewatch.cache_counts()
        info["watched_fns"] = fns
        info["watched_programs"] = progs
    except Exception:
        pass
    return info


def memory_snapshot() -> dict:
    """Live NDArray bytes by context, the program caches' sizes, and the
    memory the captured graphs took from the caching allocator
    (``mx_hbm_bytes{kind}``, cumulative over every capture). Pair two
    with :func:`memory_diff`."""
    hbm = {}
    with _REG_LOCK:
        for m in _METRICS.values():
            if m.name == "mx_hbm_bytes":
                kind = dict(m.labels).get("kind", "?")
                hbm[kind] = m.get()
    return {"ndarray": ndarray_live(), "jit_cache": _jit_cache_info(),
            "hbm_planned": hbm}


def memory_diff(before: dict, after: Optional[dict] = None) -> dict:
    """after - before of two :func:`memory_snapshot` dicts (``after``
    None: now), non-zero entries only."""
    after = memory_snapshot() if after is None else after

    def _num_diff(b, a):
        out = {}
        for k in set(b) | set(a):
            bv, av = b.get(k, 0), a.get(k, 0)
            if isinstance(bv, dict) or isinstance(av, dict):
                sub = _num_diff(bv or {}, av or {})
                if sub:
                    out[k] = sub
            else:
                d = av - bv
                if d:
                    out[k] = d
        return out

    return _num_diff(before, after)


# ---------------------------------------------------------------------------
# exposure
# ---------------------------------------------------------------------------
def _escape(value: str) -> str:
    """Label-value escaping of the Prometheus exposition format."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(name: str, labels) -> str:
    if not labels:
        return name
    return "%s{%s}" % (name, ",".join('%s="%s"' % (k, _escape(v))
                                      for k, v in labels))


_KEY_RE = None


def parse_metric_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of the ``name{label="v",...}`` key format: ``(name,
    {label: value})`` with the escaping undone."""
    import re as _re
    global _KEY_RE
    if _KEY_RE is None:
        _KEY_RE = (_re.compile(r"([^{]+)\{(.*)\}$"),
                   _re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"'))
    m = _KEY_RE[0].match(key)
    if not m:
        return key, {}
    labels = {}
    for k, v in _KEY_RE[1].findall(m.group(2)):
        labels[k] = (v.replace("\\n", "\n").replace('\\"', '"')
                     .replace("\\\\", "\\"))
    return m.group(1), labels


def snapshot() -> dict:
    """The registry as one dict: ``{"enabled", "steps", "counters":
    {key: float}, "gauges": {key: float}, "histograms": {key: {count,
    sum, min, max, p50, p90, p99}}, "jit_cache": {...}}`` with keys
    ``name{label="v",...}``."""
    with _REG_LOCK:
        metrics = list(_METRICS.values())
    out = {"enabled": enabled(), "steps": _STEP["count"],
           "counters": {}, "gauges": {}, "histograms": {},
           "jit_cache": _jit_cache_info()}
    for m in metrics:
        key = _fmt(m.name, m.labels)
        if m.kind == "counter":
            out["counters"][key] = m.get()
        elif m.kind == "gauge":
            out["gauges"][key] = m.get()
        else:
            out["histograms"][key] = m.summary()
    return out


def render_prometheus() -> str:
    """Prometheus text exposition (version 0.0.4) of every instrument:
    counters and gauges as one sample, histograms as cumulative
    ``_bucket{le=}`` series with ``_sum`` and ``_count``."""
    with _REG_LOCK:
        metrics = sorted(_METRICS.values(),
                         key=lambda m: (m.name, m.labels))
    lines = []
    typed = set()
    for m in metrics:
        if m.name not in typed:
            typed.add(m.name)
            lines.append("# TYPE %s %s" % (m.name, m.kind))
        if m.kind in ("counter", "gauge"):
            lines.append("%s %.17g" % (_fmt(m.name, m.labels), m.get()))
            continue
        with m._lock:
            counts = list(m.counts)
            count, total = m.count, m.sum
        cum = 0
        for bound, c in zip(BUCKETS, counts):
            cum += c
            lines.append('%s %d' % (
                _fmt(m.name + "_bucket",
                     m.labels + (("le", "%.6g" % bound),)), cum))
        lines.append('%s %d' % (
            _fmt(m.name + "_bucket", m.labels + (("le", "+Inf"),)),
            count))
        lines.append("%s %.17g" % (_fmt(m.name + "_sum", m.labels),
                                   total))
        lines.append("%s %d" % (_fmt(m.name + "_count", m.labels),
                                count))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the heartbeat: the periodic flight-recorder line. It reads the registry
# only (host values), never a device tensor.
# ---------------------------------------------------------------------------
_HB_LOCK = threading.Lock()
_HB = {"thread": None, "stop": None, "last_steps": 0, "last_t": None}


def _sum_of(name: str) -> float:
    with _REG_LOCK:
        return sum(m.get() for m in _METRICS.values() if m.name == name)


def heartbeat_line() -> str:
    """One line: steps and their rate since the last line, p50/p99 step
    time, pending engine ops, guard events, checkpoint errors, program
    cache size, compiles and recompiles, MFU and goodput; then the
    training-dynamics and fleet sections when they have readings."""
    now = time.perf_counter()
    with _STEP_LOCK:
        steps = _STEP["count"]
    with _HB_LOCK:
        last_steps, last_t = _HB["last_steps"], _HB["last_t"]
        _HB["last_steps"], _HB["last_t"] = steps, now
    rate = 0.0
    if last_t is not None and now > last_t:
        rate = (steps - last_steps) / (now - last_t)
    # read-only lookups: a heartbeat registers no instrument
    st = _METRICS.get(("mx_step_seconds", ()))
    pend = _METRICS.get(("mx_engine_pending_ops", ()))
    jit_entries = _jit_cache_info().get("watched_programs", 0)
    mfu = _METRICS.get(("mx_mfu", ()))
    gp = _METRICS.get(("mx_goodput", ()))
    line = ("mx-heartbeat steps=%d rate=%.2f/s step_p50=%.1fms "
            "step_p99=%.1fms pending_engine_ops=%d guard_events=%d "
            "ckpt_errors=%d jit_cache=%d compiles=%d recompiles=%d "
            "mfu=%.1f%% goodput=%.1f%%"
            % (steps, rate,
               st.percentile(50) * 1e3 if st else 0.0,
               st.percentile(99) * 1e3 if st else 0.0,
               int(pend.get()) if pend else 0,
               int(_sum_of("mx_guard_events_total")),
               int(_sum_of("mx_checkpoint_errors_total")),
               int(jit_entries), int(_sum_of("mx_compile_total")),
               int(_sum_of("mx_recompiles_total")),
               (mfu.get() if mfu else 0.0) * 100,
               (gp.get() if gp else 0.0) * 100))
    noise = _METRICS.get(("mx_grad_noise_scale", ()))
    anomalies = _sum_of("mx_modelwatch_anomalies_total")
    if noise is not None and noise.get() > 0:
        line += (" noise_scale=%.4g suggest_batch=%d"
                 % (noise.get(), max(1, int(round(noise.get())))))
    if anomalies:
        line += " layer_anomalies=%d" % int(anomalies)
    fleet = fleet_last()
    if fleet:
        line += (" fleet=nw:%d,skew:%.1f%%,slowest:r%d,phase:%s"
                 % (fleet["nw"], fleet["skew"] * 100, fleet["slowest"],
                    fleet["phase"]))
    # serving: request totals by outcome, live queue depth, the worst
    # tenant p99 and the bucket misses, once the process serves
    serve_reqs = serve_shed = qdepth = bucket_miss = serve_p99 = 0.0
    with _REG_LOCK:
        for m in _METRICS.values():
            if m.name == "mx_serve_requests_total":
                serve_reqs += m.get()
                if dict(m.labels).get("code") in ("overload", "timeout",
                                                  "drain"):
                    serve_shed += m.get()
            elif m.name == "mx_serve_queue_depth":
                qdepth += m.get()
            elif m.name == "mx_serve_bucket_miss_total":
                bucket_miss += m.get()
            elif m.name == "mx_serve_latency_seconds":
                serve_p99 = max(serve_p99, m.percentile(99))
    if serve_reqs:
        line += (" serve=reqs:%d,shed:%d,qdepth:%d,p99:%.1fms,"
                 "bucket_miss:%d"
                 % (int(serve_reqs), int(serve_shed), int(qdepth),
                    serve_p99 * 1e3, int(bucket_miss)))
    # distributed tracing: sampled requests, recorded spans, dropped
    # spans (a ring overflow is counted) and exemplars, once it traces
    try:
        from . import tracing
        ts = tracing.stats()
        if ts["sampled"] or ts["recorded"] or ts["dropped"]:
            line += (" trace=sampled:%d,spans:%d,dropped:%d,"
                     "exemplars:%d"
                     % (ts["sampled"], ts["recorded"], ts["dropped"],
                        ts["exemplars"]))
    except Exception:
        pass
    return line


def _heartbeat_loop(stop: threading.Event, period: float):
    while not stop.wait(period):
        try:
            if _STATE.on:
                _LOG.info(heartbeat_line())
        except Exception:
            pass


def _maybe_start_heartbeat():
    if _HB["thread"] is not None:
        return
    try:
        from .config import get as _cfg
        period = float(_cfg("MXNET_TELEMETRY_HEARTBEAT"))
    except Exception:
        return
    if period <= 0:
        return
    with _HB_LOCK:
        if _HB["thread"] is not None:
            return
        stop = threading.Event()
        t = threading.Thread(target=_heartbeat_loop, args=(stop, period),
                             daemon=True, name="mx-telemetry-heartbeat")
        _HB["thread"], _HB["stop"] = t, stop
        _HB["last_steps"], _HB["last_t"] = (_STEP["count"],
                                            time.perf_counter())
        t.start()


def _stop_heartbeat():
    with _HB_LOCK:
        t, stop = _HB["thread"], _HB["stop"]
        _HB["thread"] = _HB["stop"] = None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=1.0)


# ---------------------------------------------------------------------------
# the crash bundle: when a run dies for a reason the guard or the engine
# names, every diagnostic surface goes into one directory, staged under a
# dot-tmp name and renamed into place (a reader never sees half of it)
# ---------------------------------------------------------------------------
_BUNDLE_LOCK = threading.Lock()
_BUNDLE = {"installed": False, "written": 0, "recent": None}
_BUNDLE_CAP = 4          # a cascade of engine errors writes at most 4
_BUNDLE_TRIGGERS = {"engine_error", "watchdog"}
_ENV_PREFIXES = ("MXNET_", "DMLC_", "CUDA", "TORCH", "NCCL_",
                 "PYTORCH_")


def _bundle_dir() -> str:
    try:
        from .config import get as _cfg
        return _cfg("MXNET_CRASH_BUNDLE_DIR") or ""
    except Exception:
        return ""


def _compact(event: dict) -> dict:
    return {k: v for k, v in event.items()
            if isinstance(v, (str, int, float, bool, list, tuple,
                              type(None)))}


def _crash_listener(event: dict):
    """guardrails.on_event subscriber: keeps the recent events and
    writes a bundle on the fatal kinds (a raising guard's ``nonfinite``,
    an engine op error, a watchdog). Never raises."""
    try:
        rec = _BUNDLE["recent"]
        if rec is not None:
            rec.append(_compact(event))
        kind = event.get("kind")
        if kind in _BUNDLE_TRIGGERS:
            crash_bundle(reason=kind, trigger=event)
        elif kind == "nonfinite" and event.get("policy") == "raise":
            crash_bundle(reason="guard_raise", trigger=event)
    except Exception:
        pass


def install_crash_bundler():
    """Subscribe the crash-bundle trigger to the guard events
    (idempotent; done at import). A no-op until
    ``MXNET_CRASH_BUNDLE_DIR`` is set, read when an event fires."""
    with _BUNDLE_LOCK:
        if _BUNDLE["installed"]:
            return
        _BUNDLE["installed"] = True
        import collections as _collections
        _BUNDLE["recent"] = _collections.deque(maxlen=64)
    from . import guardrails
    guardrails.on_event(_crash_listener)


def crash_bundle(reason: str = "manual", trigger: Optional[dict] = None,
                 dirpath: Optional[str] = None) -> Optional[str]:
    """Write one postmortem bundle; returns its path, or None when
    disabled (no ``MXNET_CRASH_BUNDLE_DIR`` and no ``dirpath``), past its
    cap, or failed. Files: ``modelwatch.jsonl`` (the last sampled
    per-layer vectors), ``anomaly.json`` (the trigger, modelwatch's
    suspects, the recent guard events), ``telemetry.json``,
    ``trace.json`` (the chrome trace the profiler holds),
    ``programs.json`` (compilewatch), ``traces.json`` (the tracing
    stats and the slowest assembled request traces of every live
    ``TraceStore``), ``heartbeat.txt`` and ``env.txt``. Never raises."""
    tmp = None
    try:
        root = dirpath or _bundle_dir()
        if not root:
            return None
        with _BUNDLE_LOCK:
            if _BUNDLE["written"] >= _BUNDLE_CAP:
                return None
            _BUNDLE["written"] += 1
            seq = _BUNDLE["written"]
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in str(reason))[:40]
        name = "crash-%s-p%d-%d-%s" % (
            time.strftime("%Y%m%d-%H%M%S"), _os.getpid(), seq, safe)
        final = _os.path.join(root, name)
        tmp = _os.path.join(root, ".tmp-" + name)
        _os.makedirs(tmp, exist_ok=True)

        from . import modelwatch as _mw
        ring = _mw.ring()
        with open(_os.path.join(tmp, "modelwatch.jsonl"), "w") as f:
            for entry in ring:
                e = dict(entry)
                e.pop("heartbeat", None)
                f.write(_json.dumps(e, default=str) + "\n")

        recent = list(_BUNDLE["recent"] or [])
        compact_trigger = _compact(trigger) if trigger is not None \
            else None
        anomaly = {"reason": reason, "trigger": compact_trigger,
                   "suspects": _mw.suspects(),
                   "recent_guard_events": recent}
        # the trigger's own attribution (the guard names the parameters
        # of a 'nonfinite' event) leads the suspects
        if compact_trigger and compact_trigger.get("params"):
            named = set(compact_trigger["params"])
            anomaly["suspects"] = (
                [{"param": p, "kind": "nonfinite",
                  "step": compact_trigger.get("step")}
                 for p in compact_trigger["params"]]
                + [s for s in anomaly["suspects"]
                   if s.get("param") not in named])
        with open(_os.path.join(tmp, "anomaly.json"), "w") as f:
            _json.dump(anomaly, f, indent=1, default=str)

        with open(_os.path.join(tmp, "telemetry.json"), "w") as f:
            _json.dump(snapshot(), f, indent=1, default=str)

        with open(_os.path.join(tmp, "trace.json"), "w") as f:
            f.write(profiler.dumps())

        try:
            from . import compilewatch as _cw
            progs = {"report": _cw.report(), "programs": _cw.programs()}
        except Exception:
            progs = {"report": [], "programs": []}
        with open(_os.path.join(tmp, "programs.json"), "w") as f:
            _json.dump(progs, f, indent=1, default=str)

        try:
            from . import tracing as _trc
            traces = {"stats": _trc.stats(),
                      "exemplars": _trc.exemplar_dump()}
        except Exception:
            traces = {"stats": {}, "exemplars": []}
        with open(_os.path.join(tmp, "traces.json"), "w") as f:
            _json.dump(traces, f, indent=1, default=str)

        with open(_os.path.join(tmp, "heartbeat.txt"), "w") as f:
            for entry in ring:
                hb = entry.get("heartbeat")
                if hb:
                    f.write(hb + "\n")
            f.write(heartbeat_line() + "\n")

        with open(_os.path.join(tmp, "env.txt"), "w") as f:
            for k in sorted(_os.environ):
                if k.startswith(_ENV_PREFIXES):
                    f.write("%s=%s\n" % (k, _os.environ[k]))

        _os.replace(tmp, final)
        count_event("mx_crash_bundles_total", reason=safe)
        _LOG.warning("crash bundle written: %s (reason=%s)", final, reason)
        return final
    except Exception:
        if tmp is not None:
            try:
                import shutil
                shutil.rmtree(tmp, ignore_errors=True)
            except Exception:
                pass
        # give the slot back: an unwritable directory now must not
        # silence a later crash's bundle
        try:
            with _BUNDLE_LOCK:
                if _BUNDLE["written"] > 0:
                    _BUNDLE["written"] -= 1
        except Exception:
            pass
        return None
