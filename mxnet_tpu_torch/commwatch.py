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
``kv.dcn`` for the dist store's reduce across processes, and the mesh
axes (``dp``, ``tp``, ``dcn+dp``, ...) for the collectives of
:mod:`mxnet_tpu_torch.parallel`.

The program half. The reference harvests the collectives of a compiled
sharded program from its HLO. The port's sharded step runs its
collectives itself (:mod:`mxnet_tpu_torch.parallel`), and each one calls
:func:`traced_collective`: inside a :class:`program_watch` the records
become that program's inventory (op, axis, dtype, bytes, participants),
charged on each later run of the program; outside one they count once.
:func:`register_program` stores an inventory and the program's FLOPs
under a key (the step re-registers after ``telemetry.reset()``),
:class:`program_watch` charges them per run, timing the run to its
completion, and :func:`program_flops`, :func:`has_program` and
:func:`program_execs` read them back. The reference's HLO parsers have no
counterpart.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import profiler
from . import telemetry

__all__ = ["enabled", "refresh", "record", "comm_span", "exposed_region",
           "traced_collective", "register_program", "program_watch",
           "program_execs", "report", "report_key", "comm_totals",
           "reset", "render_report", "wire_dtype_label", "BUS_FACTORS"]

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


# ---------------------------------------------------------------------------
# the program half: collectives recorded by the sharded step's own runs
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def bound_collector(collector: Optional[list]):
    """Inside the scope this thread's :func:`traced_collective` records go
    to ``collector`` (a program's inventory being harvested; the SPMD
    runtime binds its device threads to the watch of the thread that
    started them)."""
    prev = getattr(_TL, "collector", None)
    _TL.collector = collector
    try:
        yield
    finally:
        _TL.collector = prev


def current_collector() -> Optional[list]:
    return getattr(_TL, "collector", None)


def _payload_bytes(x) -> int:
    """Bytes of a tensor, NDArray or numpy array (4 for a scalar)."""
    if hasattr(x, "tensor"):
        x = x.tensor()
    if hasattr(x, "element_size"):
        return int(x.numel() * x.element_size())
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    return 4


def traced_collective(op: str, axis, x, participants: int, count: int = 1,
                      nbytes: Optional[int] = None,
                      dtype: Optional[str] = None):
    """Record one collective: inside a :class:`program_watch` it joins
    that program's inventory (charged per run); otherwise it counts once.
    ``nbytes`` overrides the payload of ``x`` (an all-gather's message
    size is its total output); ``dtype`` labels a 1-byte wire payload."""
    if not enabled():
        return
    try:
        if nbytes is None:
            nbytes = _payload_bytes(x)
        rec = {"op": op, "axis": _axis_label(axis), "bytes": int(nbytes),
               "participants": int(participants), "count": int(count),
               "dtype": dtype}
        collector = getattr(_TL, "collector", None)
        if collector is not None:
            collector.append(rec)
        else:
            record(op, rec["axis"], rec["bytes"], rec["participants"],
                   count=rec["count"], dtype=dtype)
    except Exception:
        pass


# program key -> {"label", "collectives": [rec], "flops", "execs"}
_PROG_LOCK = threading.Lock()
_PROG_INV: Dict[object, dict] = {}


def register_program(key, label: str, compiled=None, mesh=None,
                     flops: Optional[float] = None,
                     collectives: Optional[List[dict]] = None):
    """Register a program's collective inventory and FLOPs under ``key``:
    a later :class:`program_watch` on the key charges both once per run.
    ``compiled`` and ``mesh`` are the reference's arguments (its HLO
    source) and are not read. Never raises."""
    try:
        if not enabled():
            return
        with _PROG_LOCK:
            _PROG_INV[key] = {"label": label,
                              "collectives": [dict(c) for c in
                                              (collectives or [])],
                              "flops": flops, "execs": 0,
                              "fixed": collectives is not None}
    except Exception:
        pass


def program_inventory(key) -> Optional[Tuple[List[dict], Optional[float]]]:
    """``(collectives, flops)`` registered under ``key``, or None."""
    with _PROG_LOCK:
        inv = _PROG_INV.get(key)
        if inv is None:
            return None
        return [dict(c) for c in inv["collectives"]], inv["flops"]


class program_watch:
    """Wrap one run of a program.

    - A first run's :func:`traced_collective` records become the
      program's inventory (keyed by ``key``), unless one was registered.
    - Every exit charges the inventory: per-collective op and byte
      counters, and the program-effective bandwidth (payload over the
      run's wall time, a lower bound: the wall includes the compute
      around the collectives); and the program's FLOPs into
      ``mx_executed_flops_total`` (the MFU numerator). ``flops`` set on
      the watch before it exits gives a program without FLOPs its
      count. The caller makes the run complete inside the watch (a
      synchronize on the card), so the wall is not its enqueue time.
    """

    __slots__ = ("key", "label", "exposed", "flops", "_t0", "_live",
                 "_outer")

    def __init__(self, key, label: Optional[str] = None,
                 exposed: bool = False):
        self.key = key
        self.label = label or str(key)
        self.exposed = bool(exposed)
        self.flops = None

    def __enter__(self):
        self._live = enabled()
        if not self._live:
            return self
        self._outer = getattr(_TL, "collector", None)
        _TL.collector = []
        self._t0 = time.perf_counter()
        return self

    @property
    def collector(self) -> Optional[list]:
        """The list this run's records go to (None when off)."""
        return getattr(_TL, "collector", None) if self._live else None

    def __exit__(self, exc_type, *exc):
        if not self._live:
            return False
        try:
            dt = time.perf_counter() - self._t0
            traced = getattr(_TL, "collector", None) or []
            _TL.collector = self._outer
            if exc_type is not None:
                return False
            with _PROG_LOCK:
                inv = _PROG_INV.get(self.key)
                if inv is None:
                    inv = _PROG_INV[self.key] = {
                        "label": self.label, "collectives": [],
                        "flops": None, "execs": 0, "fixed": False}
                if traced and not inv["fixed"] and not inv["collectives"]:
                    inv["collectives"] = [dict(c) for c in traced]
                inv["fixed"] = True
                if inv["flops"] is None and self.flops:
                    inv["flops"] = float(self.flops)
                inv["execs"] += 1
                colls = list(inv["collectives"])
                flops = inv["flops"]
            total_bytes = sum(c["bytes"] * c["count"] for c in colls)
            for c in colls:
                secs = (dt * (c["bytes"] * c["count"]) / total_bytes
                        if total_bytes and dt > 0 else None)
                record(c["op"], c["axis"], c["bytes"], c["participants"],
                       seconds=secs, exposed=self.exposed,
                       count=c["count"], dtype=c.get("dtype"))
            if flops:
                telemetry.counter("mx_executed_flops_total").inc(flops)
        except Exception:
            pass
        return False


def program_flops(key) -> Optional[float]:
    with _PROG_LOCK:
        inv = _PROG_INV.get(key)
        return inv["flops"] if inv else None


def has_program(key) -> bool:
    """Whether ``key`` has a registered inventory (a step re-registers
    after ``telemetry.reset()`` cleared them)."""
    with _PROG_LOCK:
        return key in _PROG_INV


def program_execs(key) -> int:
    """Runs charged to ``key``'s inventory so far (0 for unknown keys)."""
    with _PROG_LOCK:
        inv = _PROG_INV.get(key)
        return int(inv["execs"]) if inv else 0


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
    """Drop the program inventories (the metric series live in the
    telemetry registry and clear with ``telemetry.reset()``)."""
    with _PROG_LOCK:
        _PROG_INV.clear()
