"""Compile-watch: observability of every program the port builds
(counterpart of ``mxnet_tpu/compilewatch.py``).

The reference watches its ``jax.jit`` programs; the port's programs are
CUDA graphs. A program is one signature of a watched site, and the sites
are the capture sites:

- a hybridized block's CachedOp (``cached_op.py``): one program a
  signature, ``CachedOp.forward`` (instance ``cop<uid>/train|eval``) for
  a call that records nothing, ``CachedOp.fwd_vjp`` (``cop<uid>``) for a
  recorded one, and ``CachedOp.bwd`` for its node-by-node backward;
- the tape plans: ``autograd.fused_backward`` (a backward over
  hybridized calls) and ``autograd.fused_step`` (the same with the SGD
  update appended);
- the K-step chunk, ``scan.fused_chunk`` (``scan.py``).

On both devices the first call of a new signature is a **compile** (a
**recompile** when the site has seen another signature: the record
names each argument that changed, which field, from what to what) and
every later call a cache hit. The CPU runs each program eagerly, so the
tests hold this attribution to the reference's. On the card a program
also records its stages, the eager warm-up and the graph capture in
seconds, the memory the capture took from the caching allocator
(``graph_reserved``/``graph_allocated`` bytes), and the FLOPs of one run,
counted by ``torch.utils.flop_counter.FlopCounterMode`` over the warm-up
(the matrix products and convolutions torch dispatches; a hand-written
kernel's work is not counted). Each run after that adds them to
``mx_executed_flops_total``, the numerator of ``mx_mfu``. A graph captured
again for a signature that has one (after its graphs were released, or
for another instance of it) is a **recapture**.

The accounting feeds the telemetry registry under the reference's names:
``mx_compile_total{fn}``, ``mx_recompiles_total{fn}``,
``mx_compile_cache_hits_total{fn}``, ``mx_compile_seconds{fn,stage}``,
``mx_compile_flops{fn}``, ``mx_hbm_bytes{kind}``, ``mx_jit_cache_entries``,
and ``compile::<fn>`` chrome-trace events; and the port's
``mx_graph_captures_total{fn}`` and ``mx_recaptures_total{fn}``. The
storm guard (``MXNET_COMPILE_WARN_N``, ``MXNET_COMPILE_STRICT``) warns or
raises with the signature-diff history once a site keeps taking new
signatures. Everything rides the ``MXNET_TELEMETRY`` gate; off, a site
pays one attribute read.

The reference also watches each eager registry op's jitted program
(``ops._jit_cache``); the port's eager ops run torch's kernels as they
are and compile nothing, so there is nothing to watch there.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .base import MXNetError
from . import profiler
from . import telemetry

__all__ = ["Watch", "enabled", "programs", "report", "recompile_log",
           "cache_counts", "cache_entries", "reset", "render_report",
           "compile_seconds_total", "count_flops", "tensor_sig",
           "value_sig", "timed", "note_external_compile"]

_LOG = logging.getLogger("mxnet_tpu_torch.compilewatch")

# the telemetry gate, read as one attribute load on the hot paths
_TSTATE = telemetry._STATE

_WATCHED: "weakref.WeakSet[Watch]" = weakref.WeakSet()

_PROG_LOCK = threading.Lock()
_PROGRAMS: "collections.deque[dict]" = collections.deque(maxlen=10000)
_COMPILE_SECONDS = [0.0]   # running total, debited from goodput


def note_external_compile(seconds: float):
    """Add compile time spent outside the watched sites to the goodput
    debit total."""
    with _PROG_LOCK:
        _COMPILE_SECONDS[0] += max(0.0, float(seconds))


def enabled() -> bool:
    """Compile watching rides the MXNET_TELEMETRY gate (cached)."""
    on = _TSTATE.on
    if on is None:
        on = telemetry._resolve()
    return on


# ---------------------------------------------------------------------------
# signatures: one leaf per argument
# ---------------------------------------------------------------------------
_SHORT = {"torch.float32": "f32", "torch.float64": "f64",
          "torch.float16": "f16", "torch.bfloat16": "bf16",
          "torch.int32": "i32", "torch.int64": "i64", "torch.int16": "i16",
          "torch.int8": "i8", "torch.uint8": "u8", "torch.bool": "pred"}

# the fields of a tensor leaf, in order; a stride change is named only
# where the shape did not change
_FIELDS = ("shape", "dtype", "requires_grad", "device", "stride")


def tensor_sig(t) -> Tuple:
    """Hashable signature of one tensor argument: ``("t", shape, dtype,
    requires_grad, device, stride)``."""
    return ("t", tuple(t.shape), t.dtype, bool(t.requires_grad), t.device,
            tuple(t.stride()))


def value_sig(value, text: Optional[str] = None) -> Tuple:
    """Signature of a non-tensor argument: compared by equality, shown
    as ``text`` (default: its repr, cut to 60 characters)."""
    return ("v", value, text if text is not None else repr(value)[:60])


def _fmt_leaf(sig) -> str:
    if sig[0] == "v":
        return "py:%s" % sig[2]
    dtype = str(sig[2])
    return "%s[%s]%s" % (_SHORT.get(dtype, dtype),
                         ",".join(str(s) for s in sig[1]),
                         "^" if sig[3] else "")


def _diff_args(names, old: Sequence, new: Sequence) -> List[dict]:
    """What changed between two signatures, one ``{arg, field, from,
    to}`` a change (the recompile attribution)."""
    changes = []
    if len(old) != len(new):
        changes.append({"arg": "*", "field": "arg_count",
                        "from": len(old), "to": len(new)})
    for i in range(min(len(old), len(new))):
        o, n = old[i], new[i]
        if o == n:
            continue
        name = names(i)
        if o[0] != n[0] or o[0] == "v":
            changes.append({"arg": name,
                            "field": "value" if o[0] == n[0] else "type",
                            "from": _fmt_leaf(o), "to": _fmt_leaf(n)})
            continue
        for k, field in enumerate(_FIELDS, start=1):
            if o[k] == n[k]:
                continue
            if field == "stride" and o[1] != n[1]:
                continue
            ov, nv = o[k], n[k]
            if field in ("dtype", "device"):
                ov, nv = str(ov), str(nv)
            changes.append({"arg": name, "field": field, "from": ov,
                            "to": nv})
    return changes


# ---------------------------------------------------------------------------
# FLOPs of one run
# ---------------------------------------------------------------------------
def count_flops(fn: Callable):
    """``(fn(), flops)``: the FLOPs of the run as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (None when
    it cannot)."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
        mode = FlopCounterMode(display=False)
    except Exception:
        return fn(), None
    with mode:
        out = fn()
    try:
        return out, float(mode.get_total_flops())
    except Exception:
        return out, None


# ---------------------------------------------------------------------------
# a watched site
# ---------------------------------------------------------------------------
class Watch:
    """One program site: its signatures (one record each), the last
    signature taken, the recompiles and their diffs.

    ``miss(sig)`` publishes the record of a new signature (compile or
    recompile, with its diff; the storm guard runs there), ``stage(rec,
    name, seconds, ...)`` adds a stage (warm-up, capture), ``hit(rec)``
    counts a later run. ``lookup(sig)`` is the record of a known
    signature or None."""

    __slots__ = ("fn_label", "site", "instance", "_arg_names", "_lock",
                 "_records", "_last_sig", "_recompiles", "_diff_history",
                 "_warned", "__weakref__")

    def __init__(self, fn_label: str, site: str,
                 arg_names: Optional[Sequence[str]] = None,
                 instance: Optional[str] = None):
        self.fn_label = fn_label
        self.site = site
        self.instance = instance or fn_label
        self._arg_names = list(arg_names) if arg_names else None
        self._lock = threading.Lock()
        self._records: Dict[Tuple, dict] = {}
        self._last_sig: Optional[Tuple] = None
        self._recompiles = 0
        self._diff_history: List[dict] = []
        self._warned = False
        _WATCHED.add(self)

    def _name(self, i: int) -> str:
        if self._arg_names and i < len(self._arg_names):
            return self._arg_names[i]
        return "arg%d" % i

    def cache_info(self) -> dict:
        return {"fn": self.fn_label, "site": self.site,
                "instance": self.instance, "entries": len(self._records),
                "recompiles": self._recompiles}

    @property
    def recompiles(self) -> int:
        return self._recompiles

    def lookup(self, sig) -> Optional[dict]:
        return self._records.get(sig)

    # -- a new signature -------------------------------------------------
    def miss(self, sig) -> dict:
        with self._lock:
            rec = self._records.get(sig)
            if rec is not None:
                return rec
            is_recompile = self._last_sig is not None
            changed = (_diff_args(self._name, self._last_sig, sig)
                       if is_recompile else [])
            rec = {"site": self.site, "fn": self.fn_label,
                   "instance": self.instance,
                   "kind": "recompile" if is_recompile else "compile",
                   "stages": {}, "flops": None, "bytes": {},
                   "signature": [_fmt_leaf(s) for s in sig],
                   "changed": changed, "time": time.perf_counter(),
                   "captures": 0}
            self._records[sig] = rec
            self._last_sig = sig
            if is_recompile:
                self._recompiles += 1
                self._diff_history.append(
                    {"changed": changed, "signature": rec["signature"]})
        _publish(self, rec)
        if is_recompile:
            self._storm_guard()
        return rec

    def _storm_guard(self):
        """Warn (or raise under MXNET_COMPILE_STRICT) once a site has
        taken more than MXNET_COMPILE_WARN_N new signatures after its
        first, with the last diffs."""
        from .config import get as _cfg
        try:
            warn_n = int(_cfg("MXNET_COMPILE_WARN_N"))
        except Exception:
            warn_n = 0
        if warn_n <= 0 or self._recompiles <= warn_n:
            return
        history = "; ".join(
            ", ".join("%s.%s %s->%s" % (c["arg"], c["field"],
                                        c["from"], c["to"])
                      for c in h["changed"]) or "<no diff>"
            for h in self._diff_history[-8:])
        msg = ("recompile storm: %s (%s) recompiled %d times "
               "(MXNET_COMPILE_WARN_N=%d); last signature diffs: %s"
               % (self.fn_label, self.instance, self._recompiles,
                  warn_n, history))
        if not self._warned:
            self._warned = True
            _LOG.warning(msg)
        if _cfg("MXNET_COMPILE_STRICT"):
            raise MXNetError(msg)

    # -- stages and runs -------------------------------------------------
    def stage(self, rec: dict, name: str, seconds: float,
              flops: Optional[float] = None,
              nbytes: Optional[Dict[str, int]] = None):
        """Add stage ``name`` of ``seconds`` to ``rec``; ``flops`` are one
        run's (the warm-up ran once: counted as executed), ``nbytes`` the
        memory a capture took. A second capture of a record is a
        recapture, published as a record of its own."""
        try:
            fn = self.fn_label
            if name == "capture":
                rec["captures"] += 1
                telemetry.counter("mx_graph_captures_total", fn=fn).inc()
                if rec["captures"] > 1:
                    telemetry.counter("mx_recaptures_total", fn=fn).inc()
                    again = dict(rec, kind="recapture",
                                 stages={"capture": seconds},
                                 bytes=dict(nbytes or {}), changed=[],
                                 time=time.perf_counter())
                    with _PROG_LOCK:
                        _PROGRAMS.append(again)
            rec["stages"][name] = rec["stages"].get(name, 0.0) + seconds
            telemetry.histogram("mx_compile_seconds", fn=fn,
                                stage=name).observe(seconds)
            with _PROG_LOCK:
                _COMPILE_SECONDS[0] += seconds
            if flops is not None and rec["flops"] is None:
                rec["flops"] = flops
                telemetry.counter("mx_compile_flops", fn=fn).inc(flops)
                if flops:
                    telemetry.counter("mx_executed_flops_total").inc(flops)
            for kind, n in (nbytes or {}).items():
                rec["bytes"][kind] = rec["bytes"].get(kind, 0) + n
                telemetry.gauge("mx_hbm_bytes", kind=kind).inc(n)
            args = {"site": self.site, "instance": self.instance,
                    "stage": name, "signature": rec["signature"],
                    "%s_ms" % name: round(seconds * 1e3, 3)}
            if flops is not None:
                args["flops"] = flops
            if nbytes:
                args["bytes"] = dict(nbytes)
            profiler.record_event("compile::%s" % fn, "compile",
                                  (time.perf_counter() - seconds) * 1e6,
                                  seconds * 1e6, args)
        except Exception:
            pass

    def hit(self, rec: dict):
        """One run of a known signature: a cache hit, its FLOPs
        executed."""
        try:
            telemetry.counter("mx_compile_cache_hits_total",
                              fn=self.fn_label).inc()
            if rec["flops"]:
                telemetry.counter("mx_executed_flops_total").inc(
                    rec["flops"])
        except Exception:
            pass


def _publish(w: Watch, rec: dict):
    try:
        with _PROG_LOCK:
            _PROGRAMS.append(rec)
        fn = w.fn_label
        telemetry.counter("mx_compile_total", fn=fn).inc()
        if rec["kind"] == "recompile":
            telemetry.counter("mx_recompiles_total", fn=fn).inc()
        telemetry.gauge("mx_jit_cache_entries").set(cache_entries())
        args = {"site": w.site, "instance": w.instance, "kind": rec["kind"],
                "signature": rec["signature"]}
        if rec["changed"]:
            args["changed"] = rec["changed"]
        profiler.record_event("compile::%s" % fn, "compile",
                              rec["time"] * 1e6, 0.0, args)
    except Exception:
        pass


def timed(w: Optional[Watch], rec: Optional[dict], stage: str,
          fn: Callable, flops: bool = False, memory: bool = False):
    """Run ``fn()`` as stage ``stage`` of ``rec`` (just ``fn()`` when
    ``rec`` is None): its seconds, with ``flops`` the FLOPs counted over
    it, with ``memory`` the caching allocator's growth across it (a
    capture's graph pool)."""
    if rec is None:
        return fn()
    m0 = _allocator() if memory else None
    t0 = time.perf_counter()
    if flops:
        out, n = count_flops(fn)
    else:
        out, n = fn(), None
    dt = time.perf_counter() - t0
    nbytes = None
    if m0 is not None:
        m1 = _allocator()
        nbytes = {"graph_reserved": max(0, m1[0] - m0[0]),
                  "graph_allocated": max(0, m1[1] - m0[1])}
    w.stage(rec, stage, dt, flops=n, nbytes=nbytes)
    return out


def _allocator():
    """(reserved, allocated) bytes of the caching allocator: host
    counters, no synchronisation."""
    import torch
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


# ---------------------------------------------------------------------------
# process-wide introspection
# ---------------------------------------------------------------------------
def cache_counts() -> Tuple[int, int]:
    """(live watched sites, their signatures)."""
    ws = list(_WATCHED)
    return len(ws), sum(len(w._records) for w in ws)


def cache_entries() -> int:
    return cache_counts()[1]


def programs() -> List[dict]:
    """Every program record, oldest first."""
    with _PROG_LOCK:
        return list(_PROGRAMS)


def compile_seconds_total() -> float:
    """Seconds spent warming up and capturing watched programs (the
    goodput debit)."""
    return _COMPILE_SECONDS[0]


def recompile_log(fn_label: Optional[str] = None) -> List[dict]:
    """Recompile records with their diffs, oldest first."""
    return [r for r in programs()
            if r["kind"] == "recompile"
            and (fn_label is None or r["fn"] == fn_label)]


def report() -> List[dict]:
    """Rows per (site, fn): compiles, recompiles, recaptures, seconds,
    FLOPs, bytes, the last signature."""
    rows: Dict[Tuple[str, str], dict] = {}
    for r in programs():
        key = (r["site"], r["fn"])
        row = rows.get(key)
        if row is None:
            row = rows[key] = {
                "site": r["site"], "fn": r["fn"], "compiles": 0,
                "recompiles": 0, "recaptures": 0, "compile_seconds": 0.0,
                "flops": 0.0, "bytes": {}, "last_signature": None}
        if r["kind"] == "recapture":
            row["recaptures"] += 1
        else:
            row["compiles"] += 1
            if r["kind"] == "recompile":
                row["recompiles"] += 1
            if r["flops"]:
                row["flops"] += r["flops"]
            row["last_signature"] = r["signature"]
        row["compile_seconds"] += sum(r["stages"].values())
        for kind, nbytes in r["bytes"].items():
            row["bytes"][kind] = row["bytes"].get(kind, 0) + nbytes
    return sorted(rows.values(), key=lambda row: -row["compile_seconds"])


def _fmt_count(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if v >= div:
            return "%.2f%s" % (v / div, unit)
    return "%.0f" % v


def render_report(rows: Optional[List[dict]] = None) -> str:
    """The per-site table."""
    rows = report() if rows is None else rows
    out = ["%-24s %-24s %8s %9s %10s %10s %12s"
           % ("callsite", "fn", "compiles", "recompile",
              "compile_s", "flops", "graph_bytes")]
    for r in rows:
        mem = r["bytes"].get("graph_reserved", 0)
        out.append("%-24s %-24s %8d %9d %10.3f %10s %12s"
                   % (r["site"], r["fn"], r["compiles"], r["recompiles"],
                      r["compile_seconds"],
                      _fmt_count(r["flops"]) if r["flops"] else "-",
                      _fmt_count(mem) if mem else "-"))
    return "\n".join(out)


def reset():
    """Drop the program records and each site's history (the sites and
    their graphs stay)."""
    with _PROG_LOCK:
        _PROGRAMS.clear()
        _COMPILE_SECONDS[0] = 0.0
    for w in list(_WATCHED):
        w._recompiles = 0
        w._diff_history = []
        w._warned = False
