"""Communication accounting for the eager collectives (counterpart of the
eager half of ``mxnet_tpu/commwatch.py``): the NCCL-tests bookkeeping of
every kvstore reduce.

:class:`comm_span` times one collective call (the in-process grouped
reduce, the dist store's all-reduce) and :func:`record` adds it to the
telemetry registry: op kind, axis, participant count, payload bytes,
algorithm bandwidth (the logical payload a second) and bus bandwidth
(algbw times the NCCL per-op factor, ``2 (n - 1) / n`` for an
all-reduce, so rings of different sizes compare). A collective inside
:class:`exposed_region` (the Trainer's ``allreduce`` phase: the gradient
sync blocks the step's thread) counts its seconds as exposed, else as
overlapped.

Everything is gated on ``MXNET_COMMWATCH`` (on by default) and
``MXNET_TELEMETRY``; both reads are cached (:func:`refresh`, which
``telemetry.refresh()`` calls too). Metrics:
``mx_comm_ops_total{op,axis}``, ``mx_comm_bytes_total{op,axis}``,
``mx_comm_bus_bytes_total{op,axis}``, ``mx_comm_seconds{op,axis}``,
``mx_comm_bandwidth_bytes_per_sec{op,axis}``,
``mx_comm_bus_bandwidth_bytes_per_sec{op,axis}``,
``mx_comm_exposed_seconds_total{op,axis}`` and
``mx_comm_overlapped_seconds_total{op,axis}``, with ``comm::<op>``
chrome-trace events. :func:`report` aggregates them per (op, axis,
dtype) and :func:`comm_totals` feeds the fleet view.

The axes: ``kv`` for the in-process reduce across a process's contexts,
``kv.dcn`` for the dist store's reduce across processes. The reference's
other half (collectives traced inside compiled sharded programs,
``traced_collective``, ``register_program``, ``program_watch``) comes
with the sharded step (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from . import profiler
from . import telemetry

__all__ = ["enabled", "refresh", "record", "comm_span", "exposed_region",
           "report", "report_key", "comm_totals", "reset",
           "render_report", "wire_dtype_label", "BUS_FACTORS"]

# the telemetry gate object: one attribute load on the hot path
_TSTATE = telemetry._STATE


class _CState:
    __slots__ = ("on",)

    def __init__(self):
        self.on: Optional[bool] = None


_CSTATE = _CState()


def _resolve() -> bool:
    from .config import get as _cfg
    _CSTATE.on = bool(_cfg("MXNET_COMMWATCH"))
    return _CSTATE.on


def enabled() -> bool:
    """Both gates: ``MXNET_TELEMETRY`` (cached by telemetry) and
    ``MXNET_COMMWATCH`` (cached here; :func:`refresh` after a change)."""
    on = _TSTATE.on
    if on is None:
        on = telemetry._resolve()
    if not on:
        return False
    con = _CSTATE.on
    if con is None:
        con = _resolve()
    return con


def refresh():
    """Drop the cached ``MXNET_COMMWATCH`` gate."""
    _CSTATE.on = None


# bus-bandwidth factors (NCCL-tests conventions): busbw = algbw * f(n),
# the bytes each link moves a second
def _f_allreduce(n):
    return 2.0 * (n - 1) / n if n > 1 else 1.0


def _f_shifted(n):
    return (n - 1.0) / n if n > 1 else 1.0


BUS_FACTORS = {
    "allreduce": _f_allreduce,
    "reduce_scatter": _f_shifted,
    "allgather": _f_shifted,
    "all_to_all": _f_shifted,
    "ppermute": lambda n: 1.0,
    "broadcast": lambda n: 1.0,
}


def _axis_label(axis) -> str:
    if isinstance(axis, (list, tuple)):
        return "+".join(str(a) for a in axis)
    return str(axis)


# the 1-byte wire formats get a dtype label; wider payloads stay
# unlabelled (read as f32-class by report())
_WIRE_DTYPES = {"int8": "int8", "uint8": "int8",
                "float8_e4m3fn": "fp8", "float8_e5m2": "fp8",
                "s8": "int8", "u8": "int8",
                "f8e4m3fn": "fp8", "f8e5m2": "fp8"}


def wire_dtype_label(dtype) -> Optional[str]:
    """The ``dtype`` label of a collective payload: a short name for the
    1-byte formats, None for everything else."""
    if dtype is None:
        return None
    return _WIRE_DTYPES.get(str(dtype).replace("torch.", ""))


_TL = threading.local()


class exposed_region:
    """Mark the enclosed region as blocking the step's thread: the
    collectives recorded inside count their time as exposed."""

    def __enter__(self):
        _TL.exposed = getattr(_TL, "exposed", 0) + 1
        return self

    def __exit__(self, *exc):
        _TL.exposed = max(0, getattr(_TL, "exposed", 1) - 1)
        return False


def _in_exposed() -> bool:
    return getattr(_TL, "exposed", 0) > 0


def record(op: str, axis, nbytes: int, participants: int,
           seconds: Optional[float] = None, exposed: Optional[bool] = None,
           count: int = 1, dtype: Optional[str] = None):
    """Account one (or ``count`` identical) collective(s) of ``nbytes``
    payload each. ``seconds`` adds the latency and bandwidth histograms
    and the exposed/overlapped split (``exposed=None`` reads the
    thread's :class:`exposed_region`). Never raises."""
    try:
        if not enabled():
            return
        lab = {"op": op, "axis": _axis_label(axis)}
        if dtype is not None:
            lab["dtype"] = dtype
        telemetry.counter("mx_comm_ops_total", **lab).inc(count)
        telemetry.counter("mx_comm_bytes_total", **lab).inc(nbytes * count)
        factor = BUS_FACTORS.get(op, lambda n: 1.0)(max(1, participants))
        telemetry.counter("mx_comm_bus_bytes_total",
                          **lab).inc(nbytes * count * factor)
        if seconds is None or seconds <= 0:
            return
        telemetry.histogram("mx_comm_seconds", **lab).observe(seconds)
        algbw = nbytes * count / seconds
        telemetry.histogram("mx_comm_bandwidth_bytes_per_sec",
                            **lab).observe(algbw)
        telemetry.histogram("mx_comm_bus_bandwidth_bytes_per_sec",
                            **lab).observe(algbw * factor)
        if exposed is None:
            exposed = _in_exposed()
        telemetry.counter(
            "mx_comm_exposed_seconds_total" if exposed
            else "mx_comm_overlapped_seconds_total", **lab).inc(seconds)
    except Exception:
        pass


class comm_span:
    """Time one eager collective and record it: a ``comm::<op>``
    chrome-trace event (category ``comm``) with its bytes, axis and
    bandwidth, and the :func:`record` metrics. The caller synchronises
    the device inside the span when it is live (``live``), so the time
    is the collective's completion, not its launch."""

    __slots__ = ("op", "axis", "nbytes", "participants", "exposed",
                 "key", "_t0", "live")

    def __init__(self, op: str, axis, nbytes: int, participants: int,
                 exposed: Optional[bool] = None, key: Optional[str] = None):
        self.op = op
        self.axis = axis
        self.nbytes = int(nbytes)
        self.participants = int(participants)
        self.exposed = exposed
        self.key = key
        self.live = False

    def __enter__(self):
        try:
            self.live = enabled() or profiler.state() == "run"
            if self.live:
                self._t0 = time.perf_counter()
        except Exception:
            self.live = False
        return self

    def __exit__(self, *exc):
        if not self.live:
            return False
        try:
            dt = time.perf_counter() - self._t0
            exposed = self.exposed
            if exposed is None:
                exposed = _in_exposed()
            record(self.op, self.axis, self.nbytes, self.participants,
                   seconds=dt, exposed=exposed)
            args = {"axis": _axis_label(self.axis), "bytes": self.nbytes,
                    "participants": self.participants,
                    "exposed": bool(exposed)}
            if dt > 0:
                args["algbw_GBs"] = round(self.nbytes / dt / 1e9, 3)
            if self.key is not None:
                args["key"] = self.key
            profiler.record_event("comm::%s" % self.op, "comm",
                                  self._t0 * 1e6, dt * 1e6, args)
        except Exception:
            pass
        return False


def report() -> List[dict]:
    """Per-(op, axis, dtype) rows from the registry: ops, bytes, bus
    bytes, measured seconds, mean algbw and busbw, exposed and
    overlapped seconds; ``dtype`` is ``f32`` for unlabelled payloads."""
    rows: Dict[Tuple[str, str, str], dict] = {}

    def _row(labels):
        lab = dict(labels)
        key = (lab.get("op", "?"), lab.get("axis", "?"),
               lab.get("dtype", "f32"))
        row = rows.get(key)
        if row is None:
            row = rows[key] = {"op": key[0], "axis": key[1],
                               "dtype": key[2], "ops": 0, "bytes": 0.0,
                               "bus_bytes": 0.0, "seconds": 0.0,
                               "algbw": 0.0, "busbw": 0.0,
                               "exposed_s": 0.0, "overlapped_s": 0.0}
        return row

    with telemetry._REG_LOCK:
        metrics = list(telemetry._METRICS.values())
    for m in metrics:
        if m.name == "mx_comm_ops_total":
            _row(m.labels)["ops"] += m.get()
        elif m.name == "mx_comm_bytes_total":
            _row(m.labels)["bytes"] += m.get()
        elif m.name == "mx_comm_bus_bytes_total":
            _row(m.labels)["bus_bytes"] += m.get()
        elif m.name == "mx_comm_seconds":
            _row(m.labels)["seconds"] += m.sum
        elif m.name == "mx_comm_bandwidth_bytes_per_sec":
            _row(m.labels)["algbw"] = m.sum / m.count if m.count else 0.0
        elif m.name == "mx_comm_bus_bandwidth_bytes_per_sec":
            _row(m.labels)["busbw"] = m.sum / m.count if m.count else 0.0
        elif m.name == "mx_comm_exposed_seconds_total":
            _row(m.labels)["exposed_s"] += m.get()
        elif m.name == "mx_comm_overlapped_seconds_total":
            _row(m.labels)["overlapped_s"] += m.get()
    return sorted(rows.values(), key=lambda r: -r["bytes"])


def report_key(row: dict) -> str:
    """``op/axis`` for f32-class rows, ``op/axis/dtype`` for the others."""
    dt = row.get("dtype", "f32")
    if dt == "f32":
        return "%s/%s" % (row["op"], row["axis"])
    return "%s/%s/%s" % (row["op"], row["axis"], dt)


def comm_totals() -> dict:
    """Bytes, seconds, exposed seconds and ops over every row: the
    numbers the fleet view publishes a rank."""
    tot = {"bytes": 0.0, "seconds": 0.0, "exposed_seconds": 0.0,
           "ops": 0.0}
    for r in report():
        tot["bytes"] += r["bytes"]
        tot["seconds"] += r["exposed_s"] + r["overlapped_s"]
        tot["exposed_seconds"] += r["exposed_s"]
        tot["ops"] += r["ops"]
    return tot


def _fmt_bytes(v: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if v >= div:
            return "%.2f%s" % (v / div, unit)
    return "%.0fB" % v


def render_report(rows: Optional[List[dict]] = None) -> str:
    """:func:`report` as a text table."""
    rows = report() if rows is None else rows
    out = ["%-16s %-10s %-6s %8s %10s %10s %11s %11s %10s %10s"
           % ("collective", "axis", "dtype", "ops", "bytes", "seconds",
              "algbw", "busbw", "exposed_s", "overlap_s")]
    for r in rows:
        out.append("%-16s %-10s %-6s %8d %10s %10.4f %9s/s %9s/s "
                   "%10.4f %10.4f"
                   % (r["op"], r["axis"], r.get("dtype", "f32"),
                      r["ops"], _fmt_bytes(r["bytes"]),
                      r["seconds"], _fmt_bytes(r["algbw"]),
                      _fmt_bytes(r["busbw"]), r["exposed_s"],
                      r["overlapped_s"]))
    return "\n".join(out)


def reset():
    """Nothing of its own to drop: the series live in the telemetry
    registry and clear with ``telemetry.reset()`` (the reference drops
    its program inventories here)."""
