"""Profiler (counterpart of ``mxnet_tpu/profiler.py``; ref:
src/profiler/profiler.cc + python/mxnet/profiler.py).

Two layers, as in the reference:

1. A host-side event recorder with the reference's surface
   (``set_config``, ``set_state``, ``pause``/``resume``, scopes,
   ``Task``/``Frame``/``Event``/``Counter``/``Marker``, ``dumps``/
   ``dump``) that emits chrome://tracing JSON in the reference's schema:
   the Python dispatch, the data pipeline, the engine's ops, the step
   phases and the users' scopes.
2. With ``profile_device=True`` the card's own timeline: ``set_state
   ("run")`` starts ``torch.profiler`` with the CUDA activity only (the
   reference starts ``jax.profiler``), and stopping it merges every
   kernel and memory-copy event into the same event list, under a pid
   of their own (the process id + 1) and on the host clock's origin, so
   one dump shows a span and the kernels it launched side by side.

The two clocks: host events are ``time.perf_counter()`` microseconds;
the profiler stamps its events on its own clock. When the device trace
starts, one ``cudaEventRecord`` is called (on an event made before the
trace, so the call does nothing else) and the host stamps its return;
the end of its runtime event in the device trace is the anchor, and
every device event is shifted by the stamp minus the anchor's trace
time. The card's
timestamps reach the profiler's clock through a conversion of their own,
which can lag the host's by a fraction of a millisecond, so the device
events are then moved later by the most any kernel starts before the
runtime call that launched it (matched by their ``correlation`` id): no
kernel starts before its launch. No anchor found, the device events keep
their own clock and carry ``"clock": "unaligned"``.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import List, Optional

__all__ = ["set_config", "set_state", "state", "dump", "dumps", "pause",
           "resume", "Task", "Frame", "Event", "Counter", "Marker", "scope",
           "record_event", "record_external", "device_events",
           "device_clock_shift"]

_CONFIG = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "profile_device": False,
    "aggregate_stats": False,
}
_STATE = "stop"
_EVENTS: List[dict] = []
_LOCK = threading.Lock()
_DEVICE = {"prof": None, "anchor": None, "shift_us": 0.0}

# device-trace categories merged into the dump
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def set_config(**kwargs):
    _CONFIG.update(kwargs)


def state():
    return _STATE


def _start_device():
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    ev = torch.cuda.Event()
    ev.record()                # made and recorded once outside the trace
    prof.start()
    # the anchor: the runtime call's end, stamped on the host as it returns
    ev.record()
    t1 = time.perf_counter()
    _DEVICE["prof"] = prof
    _DEVICE["anchor"] = t1 * 1e6


def _stop_device():
    """Stop the device trace and merge its events into the event list."""
    prof, anchor = _DEVICE["prof"], _DEVICE["anchor"]
    _DEVICE["prof"] = _DEVICE["anchor"] = None
    if prof is None:
        return
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mxt_devtrace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass
    events = trace.get("traceEvents", trace) \
        if isinstance(trace, dict) else trace
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and "ts" in e]
    marks = sorted(float(e["ts"]) + float(e.get("dur", 0.0))
                   for e in runtime
                   if str(e.get("name", "")).startswith("cudaEventRecord"))
    offset = anchor - marks[0] if marks else None
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    # causality: a kernel starts after the runtime call that launched it
    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                for e in runtime}
    lead = max([launched[c] - float(e["ts"]) for e in device
                for c in [(e.get("args") or {}).get("correlation")]
                if c is not None and c in launched] + [0.0])
    _DEVICE["shift_us"] = lead
    pid = os.getpid() + 1
    merged = []
    for e in device:
        args = dict(e.get("args") or {})
        if offset is None:
            args["clock"] = "unaligned"
        merged.append({
            "name": e.get("name", "?"), "cat": "device::" + e["cat"],
            "ph": "X", "ts": float(e["ts"]) + (offset or 0.0) + lead,
            "dur": float(e.get("dur", 0.0)), "pid": pid,
            "tid": "stream %s" % args.get("stream", e.get("tid", "?")),
            "args": args})
    with _LOCK:
        _EVENTS.extend(merged)


def set_state(state_name: str = "stop", profile_process="worker"):
    """``"run"`` starts recording (and the device trace with
    ``profile_device``); ``"stop"`` ends it, merging the device events."""
    global _STATE
    if state_name == _STATE:
        return
    _STATE = state_name
    if state_name == "run":
        if _CONFIG.get("profile_device"):
            _start_device()
    else:
        _stop_device()


def pause(profile_process="worker"):
    set_state("stop")


def resume(profile_process="worker"):
    set_state("run")


def record_event(name: str, category: str, ts_us: float, dur_us: float,
                 args: Optional[dict] = None):
    """One complete ("X") event on the host clock (perf_counter us)."""
    if _STATE != "run":
        return
    with _LOCK:
        _EVENTS.append({
            "name": name, "cat": category, "ph": "X",
            "ts": ts_us, "dur": dur_us, "pid": os.getpid(),
            "tid": threading.get_ident() % 100000,
            "args": args or {}})


def record_external(event: dict):
    """Append one chrome event formed elsewhere (the assembled request
    traces of ``tracing.TraceStore``, on the wall clock), so one dump
    carries local events and cross-process traces side by side. Missing
    fields are defaulted; nothing else is rewritten."""
    if _STATE != "run":
        return
    ev = dict(event)
    ev.setdefault("ph", "X")
    ev.setdefault("pid", os.getpid())
    ev.setdefault("tid", threading.get_ident() % 100000)
    ev.setdefault("args", {})
    with _LOCK:
        _EVENTS.append(ev)


def device_clock_shift() -> float:
    """Microseconds the last device trace was moved later so that no
    kernel starts before its launch (0 when none did)."""
    return _DEVICE["shift_us"]


def device_events() -> List[dict]:
    """The merged device events held so far (``cat`` ``device::*``)."""
    with _LOCK:
        return [e for e in _EVENTS
                if str(e.get("cat", "")).startswith("device::")]


class scope:
    """Context manager timing a region into the trace."""

    def __init__(self, name: str, category: str = "user"):
        self.name, self.category = name, category

    def __enter__(self):
        self._t0 = time.perf_counter() * 1e6
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter() * 1e6
        record_event(self.name, self.category, self._t0, t1 - self._t0)
        return False


class Task(scope):
    def __init__(self, name, domain=None):
        super().__init__(name, "task")

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__()


class Frame(Task):
    pass


class Event(Task):
    pass


class Counter:
    """Trace counter; updates are atomic and the counter event is
    appended under the value's lock, so the track is monotone with the
    updates."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value
        self._vlock = threading.Lock()

    def _emit_locked(self, value):
        if _STATE == "run":
            with _LOCK:
                _EVENTS.append({"name": self.name, "ph": "C",
                                "ts": time.perf_counter() * 1e6,
                                "pid": os.getpid(),
                                "args": {"value": value}})

    def set_value(self, value):
        with self._vlock:
            self.value = value
            self._emit_locked(value)

    def increment(self, delta=1):
        with self._vlock:
            self.value += delta
            self._emit_locked(self.value)

    def decrement(self, delta=1):
        with self._vlock:
            self.value -= delta
            self._emit_locked(self.value)


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope_name="process"):
        if _STATE == "run":
            with _LOCK:
                _EVENTS.append({"name": self.name, "ph": "i",
                                "ts": time.perf_counter() * 1e6,
                                "pid": os.getpid(), "s": "p"})


def dumps(reset=False) -> str:
    with _LOCK:
        out = json.dumps({"traceEvents": list(_EVENTS)}, indent=1)
        if reset:
            _EVENTS.clear()
    return out


def dump(finished=True, profile_process="worker", reset=False):
    """Write the chrome://tracing JSON to the configured ``filename``
    atomically (a temp file renamed into place); ``reset=True`` drops
    the events written, once the write landed."""
    path = _CONFIG["filename"]
    with _LOCK:
        snap = list(_EVENTS)
    data = json.dumps({"traceEvents": snap}, indent=1)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    if reset:
        with _LOCK:
            del _EVENTS[:len(snap)]
