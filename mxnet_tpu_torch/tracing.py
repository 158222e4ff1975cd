"""Distributed request tracing: spans from the HTTP edge to the engine
op, assembled across processes (counterpart of ``mxnet_tpu/tracing.py``).

A served request crosses the frontend, the router and a replica
process; this module correlates what each of them records.

- :class:`TraceContext`: (trace_id, span_id, sampled, deadline), minted
  once at the edge (:func:`mint`, in the frontend or the router), taken
  from an inbound ``x-mxnet-trace`` header (:func:`from_header`) and
  carried in the fleet's json frame header (:meth:`TraceContext.to_wire`,
  :func:`from_wire`). Sampling is decided where the context is minted
  and never again; only sampled requests put trace bytes on the wire.
- :func:`bind` puts a context in thread-local storage and
  :func:`current` reads it back: a replica binds the remote context
  around ``Scheduler.submit``, so the scheduler's and the session's
  spans downstream are tagged without a parameter.
- :func:`record_span`: completed spans go to one bounded ring a process
  (``MXNET_TRACE_RING``); overflow drops the oldest and counts the drop
  (:func:`stats`, the heartbeat's ``trace=`` section). A replica pops a
  request's spans into its reply (:func:`take_for`) and drains the rest
  into its lease payload (:func:`publish_drain`).
- :class:`TraceStore`: assembly on the router, replica spans moved onto
  the router's clock by the offset measured on the wire round trip
  (:func:`clock_skew`), duplicates dropped, a critical-path breakdown a
  request (:func:`critical_path`), the slowest traces kept whole
  (``MXNET_TRACE_EXEMPLARS``, in the crash bundle's ``traces.json``),
  and chrome-trace export (:func:`dump_chrome`), mirrored into the
  port's profiler while it runs.

Every hot-path check is one cached attribute read (:func:`active`); call
:func:`refresh` (or ``telemetry.refresh()``) after changing the
environment. Tracing times the host, as the rest of the telemetry does:
nothing here synchronises the card.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceContext", "TraceStore", "mint", "from_header",
           "from_wire", "current", "bind", "record_span", "take_for",
           "publish_drain", "active", "enabled", "enable", "refresh",
           "stats", "reset", "clock_skew", "critical_path",
           "exemplar_dump", "render_critical_path", "dump_chrome"]

_HEADER = "x-mxnet-trace"        # the HTTP propagation header


# ---------------------------------------------------------------------------
# enable gate — ONE cached attribute read on every hot-path check
# ---------------------------------------------------------------------------
class _TState:
    __slots__ = ("on", "sample", "ring_cap", "exemplars")

    def __init__(self):
        self.on: Optional[bool] = None   # None = not yet resolved
        self.sample: float = 0.0
        self.ring_cap: int = 2048
        self.exemplars: int = 4


_TSTATE = _TState()


def _resolve() -> bool:
    try:
        from .config import get as _cfg
        _TSTATE.sample = min(1.0, max(0.0,
                                      float(_cfg("MXNET_TRACE_SAMPLE"))))
        _TSTATE.ring_cap = max(1, int(_cfg("MXNET_TRACE_RING")))
        _TSTATE.exemplars = max(0, int(_cfg("MXNET_TRACE_EXEMPLARS")))
        _TSTATE.on = bool(_cfg("MXNET_TRACE"))
    except Exception:
        _TSTATE.on = False
    return _TSTATE.on


def active() -> bool:
    """Whether tracing is on (MXNET_TRACE). CACHED — the gate sits on
    every routed request and every scheduler batch; call
    :func:`refresh` after changing the environment."""
    on = _TSTATE.on
    if on is None:
        on = _resolve()
    return on


enabled = active     # telemetry-style alias


def enable(on: bool = True, sample: Optional[float] = None):
    """Programmatic override of the MXNET_TRACE gate (tests/tools)."""
    if _TSTATE.on is None:
        _resolve()                      # load sample/ring from env once
    _TSTATE.on = bool(on)
    if sample is not None:
        _TSTATE.sample = min(1.0, max(0.0, float(sample)))


def refresh():
    """Drop the cached gate/sample/ring knobs so the next check
    re-reads MXNET_TRACE* from the environment."""
    _TSTATE.on = None


# ---------------------------------------------------------------------------
# trace context + propagation formats
# ---------------------------------------------------------------------------
class TraceContext:
    """One node of a distributed trace: trace_id identifies the
    request end-to-end, span_id this scope within it. ``sampled`` is
    decided ONCE at the edge and carried verbatim everywhere —
    downstream processes only ever read it."""

    __slots__ = ("trace_id", "span_id", "sampled", "deadline")

    def __init__(self, trace_id: str, span_id: str, sampled: bool,
                 deadline: Optional[float] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)
        self.deadline = deadline

    def child(self) -> "TraceContext":
        """A child scope: fresh span_id, everything else inherited."""
        return TraceContext(self.trace_id, _new_id(8), self.sampled,
                            self.deadline)

    # -- HTTP header form: "<trace_id>-<span_id>-<0|1>" ----------------
    def to_header(self) -> str:
        return "%s-%s-%d" % (self.trace_id, self.span_id,
                             1 if self.sampled else 0)

    # -- wire (json frame header) form — SAMPLED contexts only ---------
    def to_wire(self) -> dict:
        d = {"tid": self.trace_id, "sid": self.span_id}
        if self.deadline:
            d["d"] = self.deadline
        return d

    def __repr__(self):
        return "TraceContext(%s)" % self.to_header()


def _new_id(n: int = 16) -> str:
    return uuid.uuid4().hex[:n]


def mint(deadline: Optional[float] = None,
         sampled: Optional[bool] = None) -> Optional[TraceContext]:
    """Mint a ROOT context at the edge — the one place the sampling
    decision is made (``MXNET_TRACE_SAMPLE`` head sampling; ``sampled``
    overrides for tests/tools). Returns None when tracing is off."""
    if not active():
        return None
    if sampled is None:
        rate = _TSTATE.sample
        sampled = rate >= 1.0 or (rate > 0.0
                                  and int(uuid.uuid4().int & 0xFFFF)
                                  < rate * 0x10000)
    ctx = TraceContext(_new_id(16), _new_id(8), bool(sampled), deadline)
    if ctx.sampled:
        with _RING_LOCK:
            _STATS["sampled"] += 1
    return ctx


def from_header(value: Optional[str],
                deadline: Optional[float] = None
                ) -> Optional[TraceContext]:
    """Parse an inbound ``x-mxnet-trace`` header. The caller's
    sampling decision is RESPECTED (edge-owned); malformed headers
    yield None (the caller then mints)."""
    if not value or not active():
        return None
    try:
        tid, sid, flag = str(value).strip().split("-", 2)
        if not tid or not sid:
            return None
        ctx = TraceContext(tid, sid, flag.split("-")[0] == "1",
                           deadline)
    except (ValueError, AttributeError):
        return None
    if ctx.sampled:
        with _RING_LOCK:
            _STATS["sampled"] += 1
    return ctx


def from_wire(d: Optional[dict]) -> Optional[TraceContext]:
    """Rebuild the context a wire frame carried. Only sampled contexts
    ever ride the wire, so ``sampled`` is True by construction — a
    replica cannot re-flip an edge decision it never sees."""
    if not d or not active():
        return None
    try:
        return TraceContext(str(d["tid"]), str(d["sid"]), True,
                            d.get("d"))
    except (KeyError, TypeError):
        return None


# ---------------------------------------------------------------------------
# ambient (thread-local) binding
# ---------------------------------------------------------------------------
_TLS = threading.local()


def current() -> Optional[TraceContext]:
    """The context bound on this thread (None = untraced)."""
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def bind(ctx: Optional[TraceContext]):
    """Bind ``ctx`` as this thread's ambient context for the block —
    the replica wraps ``Scheduler.submit`` in this so downstream
    scheduler/engine/session spans tag themselves."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


# ---------------------------------------------------------------------------
# span ring — bounded per-process buffer of completed spans
# ---------------------------------------------------------------------------
_RING_LOCK = threading.Lock()
_RING: List[dict] = []
_STATS = {"sampled": 0, "recorded": 0, "dropped": 0}


def record_span(name: str, cat: str, t0: float, t1: float,
                ctx: Optional[TraceContext] = None,
                args: Optional[dict] = None) -> Optional[dict]:
    """Record one completed span (wall-clock seconds ``t0``..``t1``)
    tagged with ``ctx`` (default: the ambient context). No-op unless
    tracing is on and the context is sampled. Overflow evicts the
    OLDEST span and counts the drop. Never raises."""
    try:
        if not active():
            return None
        if ctx is None:
            ctx = current()
        if ctx is None or not ctx.sampled:
            return None
        span = {"name": name, "cat": cat, "ts": t0 * 1e6,
                "dur": max(0.0, (t1 - t0)) * 1e6,
                "tid": ctx.trace_id, "sid": _new_id(8),
                "psid": ctx.span_id, "args": args or {}}
        with _RING_LOCK:
            _RING.append(span)
            _STATS["recorded"] += 1
            cap = _TSTATE.ring_cap
            if len(_RING) > cap:
                drop = len(_RING) - cap
                del _RING[:drop]
                _STATS["dropped"] += drop
        return span
    except Exception:
        return None


def take_for(trace_id: str) -> List[dict]:
    """Pop (remove and return) every buffered span of one trace — the
    reply-piggyback path: a replica ships a request's spans back on
    its own reply."""
    with _RING_LOCK:
        mine = [s for s in _RING if s["tid"] == trace_id]
        if mine:
            _RING[:] = [s for s in _RING if s["tid"] != trace_id]
    return mine


def publish_drain(max_n: int = 64) -> List[dict]:
    """Pop up to ``max_n`` oldest buffered spans — the pull path: the
    replica's health-lease payload carries whatever the piggyback
    missed (e.g. an engine span that completed after its reply)."""
    with _RING_LOCK:
        out, _RING[:max_n] = _RING[:max_n], []
    return out


def stats() -> dict:
    """{"sampled", "recorded", "dropped", "buffered", "exemplars"} —
    the heartbeat's ``trace=`` section (read-only, never registers
    instruments)."""
    with _RING_LOCK:
        out = dict(_STATS)
        out["buffered"] = len(_RING)
    n = 0
    for store in list(_STORES):
        try:
            n += store.exemplar_count()
        except Exception:
            pass
    out["exemplars"] = n
    return out


def reset():
    """Test isolation: drop the ring, counters and store registry."""
    with _RING_LOCK:
        del _RING[:]
        _STATS.update(sampled=0, recorded=0, dropped=0)
    _STORES.clear()
    _TLS.ctx = None


# ---------------------------------------------------------------------------
# clock-skew correction
# ---------------------------------------------------------------------------
def clock_skew(t_send: float, t_recv: float, tr_in: float,
               tr_out: float) -> float:
    """Replica-clock minus router-clock estimate from one wire round
    trip (the NTP offset formula): the router stamped ``t_send`` /
    ``t_recv`` around the exchange, the replica reported its own
    ``tr_in`` / ``tr_out``. Subtract the result from replica
    timestamps to place them on the router's clock."""
    return ((tr_in - t_send) + (tr_out - t_recv)) / 2.0


# ---------------------------------------------------------------------------
# critical-path analysis
# ---------------------------------------------------------------------------
# span category -> breakdown phase. Categories on the wire: "fleet"
# (root), "attempt", "hedge" (hedge wait), "wire" (transit), "replica"
# (replica handle), "assembly" (scheduler queue+assembly wait), "sched"
# (batch window), "engine" (batch execution), "serve" (program forward).
#
# category "serve" (the session's program-forward span) is nested
# detail INSIDE the engine execute window — shown in the trace, but
# excluded from the breakdown so execute time is not counted twice.
_PHASE_OF = {"assembly": "queue", "sched": "batch", "engine": "execute",
             "wire": "wire", "hedge": "hedge_wait"}


def critical_path(spans: List[dict]) -> dict:
    """Approximate per-phase breakdown of one assembled trace:
    ``{"total_us", "phases": [(phase, us)], "dominant"}``. The root
    span's duration is the denominator; failed attempts count as
    ``retry`` time, the winning replica's queue/batch/execute spans as
    their own phases, anything unaccounted as ``other``. Parallel
    phases (a hedge racing the winner) may overlap, so shares are a
    breakdown, not a partition."""
    total = 0.0
    phases: Dict[str, float] = {}
    saw_exec = False
    replica_us = 0.0
    for s in spans:
        cat, dur = s.get("cat"), float(s.get("dur", 0.0))
        if cat == "fleet":
            total = max(total, dur)
            continue
        if cat == "replica":
            replica_us += dur
            continue
        if cat == "attempt":
            out = (s.get("args") or {}).get("outcome")
            if out in ("ok", "superseded"):
                continue                 # covered by its children
            phase = "retry"
        else:
            phase = _PHASE_OF.get(cat)
            if phase is None:
                continue
            if phase in ("batch", "execute"):
                saw_exec = True
        phases[phase] = phases.get(phase, 0.0) + dur
    if not saw_exec and replica_us:
        # a scheduler that reports no batch spans: the replica-handle
        # span is the best execute attribution there is
        phases["execute"] = phases.get("execute", 0.0) + replica_us
    if total <= 0.0:
        total = sum(phases.values())
    accounted = sum(phases.values())
    if total > accounted:
        phases["other"] = total - accounted
    ranked = sorted(phases.items(), key=lambda kv: -kv[1])
    return {"total_us": total, "phases": ranked,
            "dominant": ranked[0][0] if ranked else "none"}


def render_critical_path(breakdown: dict,
                         trace_id: str = "") -> str:
    """One text table for a :func:`critical_path` result."""
    total = breakdown.get("total_us") or 0.0
    out = ["critical path%s: total %.2fms (dominant: %s)"
           % (" %s" % trace_id if trace_id else "", total / 1e3,
              breakdown.get("dominant"))]
    out.append("%-12s %12s %8s" % ("phase", "time", "share"))
    for phase, us in breakdown.get("phases", ()):
        share = 100.0 * us / total if total else 0.0
        out.append("%-12s %10.2fms %7.1f%%" % (phase, us / 1e3, share))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# router-side trace assembly
# ---------------------------------------------------------------------------
_STORES = []          # live TraceStores (crash-bundle exemplar source)


class TraceStore:
    """Cross-process trace assembly on the router: local spans via
    :meth:`add`, replica spans via :meth:`ingest` (skew-corrected,
    deduplicated — the pull path re-reads a lease payload until its
    next renewal), completion + exemplar retention via :meth:`finish`.
    Bounded: at most ``cap`` traces held, oldest evicted."""

    def __init__(self, cap: int = 256, exemplars: Optional[int] = None):
        self._lock = threading.Lock()
        self._cap = int(cap)
        if exemplars is None:
            active()                 # resolve config into _TSTATE
            exemplars = _TSTATE.exemplars
        self._n_exemplars = int(exemplars)
        self._traces = {}            # tid -> {"spans", "complete", ...}
        self._order: List[str] = []  # insertion order (eviction)
        self._by_req: Dict[str, str] = {}
        self._seen = set()           # (tid, sid) dedup
        self._exemplars: List[Tuple[float, str]] = []  # (dur_us, tid)
        _STORES.append(self)
        while len(_STORES) > 16:     # bounded registry
            _STORES.pop(0)

    # -- recording ----------------------------------------------------
    def _bucket(self, tid: str) -> dict:
        b = self._traces.get(tid)
        if b is None:
            b = self._traces[tid] = {"spans": [], "complete": False,
                                     "root": None}
            self._order.append(tid)
            while len(self._order) > self._cap:
                old = self._order.pop(0)
                dead = self._traces.pop(old, None)
                if dead is not None:
                    for s in dead["spans"]:
                        self._seen.discard((old, s.get("sid")))
        return b

    def add(self, span: dict):
        """One locally-recorded (router-clock) span."""
        with self._lock:
            key = (span["tid"], span.get("sid"))
            if key in self._seen:
                return
            self._seen.add(key)
            self._bucket(span["tid"])["spans"].append(span)
        _mirror_profiler(span)

    def ingest(self, spans: List[dict], replica: Optional[str] = None,
               skew_s: float = 0.0):
        """Replica-recorded spans: timestamps move onto the router's
        clock (``ts -= skew``), the source replica is stamped on, and
        duplicates (lease payload re-reads) are dropped."""
        if not spans:
            return
        off_us = skew_s * 1e6
        with self._lock:
            for s in spans:
                try:
                    key = (s["tid"], s.get("sid"))
                    if key in self._seen:
                        continue
                    self._seen.add(key)
                    s = dict(s)
                    s["ts"] = float(s["ts"]) - off_us
                    if replica is not None:
                        s["replica"] = replica
                    self._bucket(s["tid"])["spans"].append(s)
                except (KeyError, TypeError, ValueError):
                    continue
        for s in spans:
            _mirror_profiler(s)

    def finish(self, tid: str, request_id: str, root_span: dict):
        """Mark one request's trace assembled (its root span is known)
        and fold it into the slow-request exemplar set."""
        with self._lock:
            b = self._bucket(tid)
            b["complete"] = True
            b["root"] = root_span
            self._by_req[request_id] = tid
            while len(self._by_req) > 4 * self._cap:
                self._by_req.pop(next(iter(self._by_req)))
            if self._n_exemplars > 0:
                self._exemplars.append((float(root_span.get("dur", 0.0)),
                                        tid))
                self._exemplars.sort(key=lambda e: -e[0])
                del self._exemplars[self._n_exemplars:]

    # -- queries ------------------------------------------------------
    def resolve(self, ident: str) -> Optional[str]:
        """trace id for either a trace id or a router request id."""
        with self._lock:
            if ident in self._traces:
                return ident
            return self._by_req.get(ident)

    def get(self, ident: str) -> Optional[dict]:
        tid = self.resolve(ident)
        if tid is None:
            return None
        with self._lock:
            b = self._traces.get(tid)
            if b is None:
                return None
            return {"trace_id": tid, "complete": b["complete"],
                    "spans": [dict(s) for s in b["spans"]]}

    def explain(self, ident: str) -> Optional[dict]:
        """Per-request critical-path breakdown (None = unknown id)."""
        t = self.get(ident)
        if t is None:
            return None
        out = critical_path(t["spans"])
        out["trace_id"] = t["trace_id"]
        out["complete"] = t["complete"]
        out["spans"] = len(t["spans"])
        return out

    def exemplar_count(self) -> int:
        with self._lock:
            return len(self._exemplars)

    def exemplars(self) -> List[dict]:
        """The N slowest assembled traces (worst first), each with its
        breakdown — the slow-request corpus crash bundles include."""
        with self._lock:
            worst = list(self._exemplars)
        out = []
        for dur_us, tid in worst:
            ex = self.explain(tid)
            if ex is not None:
                ex["dur_us"] = dur_us
                trace = self.get(tid)
                ex["trace"] = trace["spans"] if trace else []
                out.append(ex)
        return out

    # -- chrome-trace export -------------------------------------------
    def chrome(self, ident: Optional[str] = None) -> List[dict]:
        """traceEvents rows (complete "X" events, the profiler.dump
        shape) for one trace or every held trace; trace and span ids ride
        in ``args``, so a reader can group the events by trace."""
        with self._lock:
            if ident is None:
                tids = list(self._order)
            else:
                tid = (ident if ident in self._traces
                       else self._by_req.get(ident))
                tids = [tid] if tid else []
            spans = [s for t in tids
                     for s in self._traces.get(t, {}).get("spans", ())]
        return [_chrome_event(s) for s in spans]


def _chrome_event(span: dict) -> dict:
    args = dict(span.get("args") or {})
    args["trace"] = span.get("tid")
    args["span"] = span.get("sid")
    if span.get("psid"):
        args["parent"] = span["psid"]
    replica = span.get("replica")
    if replica:
        args["replica"] = replica
    return {"name": span.get("name", "?"), "cat": span.get("cat", "?"),
            "ph": "X", "ts": float(span.get("ts", 0.0)),
            "dur": float(span.get("dur", 0.0)), "pid": os.getpid(),
            "tid": abs(hash(replica or "router")) % 100000,
            "args": args}


def _mirror_profiler(span: dict):
    """Assembled spans land in the live profiler buffer too (when it
    runs), so one profiler.dump carries both local events and the
    cross-process request traces."""
    try:
        from . import profiler
        profiler.record_external(_chrome_event(span))
    except Exception:
        pass


def dump_chrome(path: str, store: TraceStore,
                ident: Optional[str] = None):
    """Write a store's assembled traces as chrome-trace JSON (the shape
    of ``profiler.dump``; written to a temporary name and renamed)."""
    data = json.dumps({"traceEvents": store.chrome(ident)}, indent=1)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def exemplar_dump() -> List[dict]:
    """Slow-request exemplars across every live TraceStore in this
    process (crash_bundle's traces.json source)."""
    out = []
    for store in list(_STORES):
        try:
            out.extend(store.exemplars())
        except Exception:
            pass
    out.sort(key=lambda e: -e.get("dur_us", 0.0))
    return out
