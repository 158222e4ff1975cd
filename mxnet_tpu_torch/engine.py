"""The execution engine: the dependency engine for host-side work and
the ``NaiveEngine`` switch (counterpart of ``mxnet_tpu/engine.py``; ref:
src/engine/ :: Engine::PushAsync / WaitForVar / WaitForAll,
threaded_engine_perdevice.cc, naive_engine.cc, ``MXNET_ENGINE_TYPE``).

Torch already runs the card's work asynchronously, ordered on its
streams, and surfaces a device fault at the next synchronisation. What
this module keeps is the reference's surface over that:

- :class:`Engine` (:func:`engine`): ``on_dispatch(tensor)`` for every
  registry op's output and every new array, ``wait_for_var`` (the
  stream sync ``NDArray.wait_to_read`` does) and ``wait_for_all``.
  ``MXNET_ENGINE_TYPE=NaiveEngine`` makes ``on_dispatch`` synchronise
  the tensor's stream, so a fault raises at the op that caused it (not
  while a CUDA graph is being captured: the capture would break).
- :class:`NativeDependencyEngine` (:func:`native_engine`): host work
  torch cannot see — the Python callbacks of custom operators — runs on
  the port's copy of the reference's C++ dependency engine
  (``csrc/engine.cc``: per-var pending read and write queues, a worker
  pool, an op's exception captured on its written vars). The original
  exception re-raises, with the op's label and enqueue site, at
  ``wait_for_var``/``wait_for_all``; an op that reads a poisoned var
  fails without running; ``MXNET_ENGINE_WATCHDOG`` turns a hung wait
  into an error listing the pending ops. The library is built with g++
  at first use (``native.load_engine_lib``); a failed build raises.
- :func:`push_gated`, :class:`EngineGate`, :func:`gate_arrays`,
  :func:`read_deps`, :func:`pin_reads`, :func:`unpin_reads`,
  :func:`consume_read_pins`: an NDArray whose value an engine op
  produces carries ``_pending = (gate, slot, meta)``; reading it waits
  for the op and re-raises its error; an in-place write to an array a
  pending op still reads waits for that reader first (write after
  read).

With telemetry on or the profiler running, each native op is timed from
its push to its start and from its start to its end: two chrome-trace
events (``engine::<label> (queued)`` and ``engine::<label>``), and with
telemetry on ``mx_engine_ops_total{label}``, ``mx_engine_pending_ops``,
``mx_engine_queue_seconds{label}``, ``mx_engine_op_seconds{label}`` and
``mx_engine_op_errors_total{label}`` (the label cut at its first ':').
``push_async(on_done=...)`` runs a completion hook on the worker thread
after the op (the serve scheduler's in-flight accounting rides on it).
``push_async(collective=...)`` keeps a multi-device program's
descriptor (``{"program", "lock"}``) in the op's record
(:meth:`NativeDependencyEngine.collective_pushes`); the
``engine_collective_overlap`` fault site strips the lock from it. Its
reader, the reference's race-detector hook, comes with ``staticcheck/``
(ROADMAP.md queue 1, item 16).
"""
from __future__ import annotations

import collections
import ctypes
import sys
import threading
import time
import weakref

import torch

from .base import MXNetError
from . import profiler
from . import telemetry

__all__ = ["Engine", "engine", "NativeDependencyEngine", "native_engine",
           "native_wait_all", "native_drain", "push_gated", "EngineGate",
           "gate_arrays", "read_deps", "pin_reads", "unpin_reads",
           "consume_read_pins"]


def _cfg(name):
    from .config import get
    return get(name)


def _tele_live() -> bool:
    """Whether ops are timed: telemetry on or the profiler running."""
    return telemetry.enabled() or profiler.state() == "run"


def _metric_label(label: str) -> str:
    """An op's histogram label: its label up to the first ':' (labels
    carry instance detail, 'checkpoint_write:run-0003.params')."""
    return label.split(":", 1)[0]


def _record_op_done(label, site, t_queued, t_run, failed, ginc):
    """One op's queued and running spans, and with telemetry on its
    latency histograms and error counter; ``ginc`` says whether its push
    raised the pending gauge (the decrement pairs with that)."""
    t_done = time.perf_counter()
    if ginc:
        telemetry.gauge("mx_engine_pending_ops").dec()
    pargs = {"site": site}
    profiler.record_event("engine::%s (queued)" % label, "engine",
                          t_queued * 1e6, (t_run - t_queued) * 1e6, pargs)
    profiler.record_event("engine::%s" % label, "engine", t_run * 1e6,
                          (t_done - t_run) * 1e6, dict(pargs, failed=failed))
    if telemetry.enabled():
        ml = _metric_label(label)
        telemetry.histogram("mx_engine_queue_seconds",
                            label=ml).observe(t_run - t_queued)
        telemetry.histogram("mx_engine_op_seconds",
                            label=ml).observe(t_done - t_run)
        if failed:
            telemetry.counter("mx_engine_op_errors_total", label=ml).inc()


def _enqueue_site() -> str:
    """file:line of the frame that pushed the op (engine frames
    skipped): an async error names where its op was scheduled."""
    try:
        f = sys._getframe(2)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return "<unknown>"
        return "%s:%d" % (f.f_code.co_filename, f.f_lineno)
    except Exception:
        return "<unknown>"


class NativeDependencyEngine:
    """ctypes wrapper over the C++ engine (the MXEngine* C ABI).

    Error contract: an exception raised inside an async op is kept as
    the original exception object with the op's label and enqueue site,
    and re-raised (same type, the message extended by that context, the
    original as ``__cause__``) at the next ``wait_for_var`` or
    ``wait_for_all`` that touches a poisoned var, once. An op that reads
    a poisoned var fails without running, and the error propagates to
    its own written vars. With ``MXNET_ENGINE_WATCHDOG`` seconds set, a
    wait past the deadline raises MXNetError listing every pending op.
    """

    def __init__(self, num_workers: int = 2, naive: bool = False):
        from . import native
        lib = native.load_engine_lib()
        self._lib = lib
        self._h = lib.MXEngineCreate(num_workers, int(naive))
        # err_out is a c_void_p: a c_char_p would hand the callback an
        # immutable bytes copy instead of the writable buffer
        self._cb_type = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_int)
        # one callback thunk for the engine's lifetime, dispatching by the
        # op's token: no libffi closure is freed while a worker thread
        # may still be in its native epilogue
        self._fns = {}
        # token -> (label, site, reads, writes, t_queued, ginc, on_done,
        # collective)
        self._meta = {}
        # (label, descriptor) of the latest collective pushes
        self._collectives = collections.deque(maxlen=256)
        self._var_errors = {}  # var -> error record
        self._live_lock = threading.Lock()
        self._next = 1         # ctypes maps a NULL ctx to None: no token 0

        def _dispatch(ctx_token, err_out, err_cap):
            with self._live_lock:
                fn = self._fns.pop(ctx_token, None)
                label, site, reads, writes, t_queued, ginc, on_done, _ = \
                    self._meta.get(ctx_token, ("<unlabeled>", "<unknown>",
                                               (), (), None, False, None,
                                               None))
                upstream = None
                for rv in reads:
                    rec = self._var_errors.get(rv)
                    if rec is not None:
                        upstream = rec
                        break
            t_run = time.perf_counter() if t_queued is not None \
                else None
            rc = 0
            err_text = None
            if upstream is not None:
                # a dependency is poisoned: do not run, pass its error on
                rc = 1
                rec = dict(upstream)
                rec["via"] = list(rec.get("via") or ()) + [label]
                err_text = ("not run: upstream engine op %r failed "
                            "(%s: %s)" % (rec["label"],
                                          type(rec["exc"]).__name__,
                                          rec["exc"]))
                self._record_error(writes, rec)
            else:
                try:
                    if fn is None:
                        raise MXNetError("engine: unknown op token %r"
                                         % (ctx_token,))
                    _EXEC_TLS.in_op = True
                    try:
                        fn()
                    finally:
                        _EXEC_TLS.in_op = False
                    if writes:
                        # a successful write is fresh data: later readers
                        # of a recovered var are not failed
                        with self._live_lock:
                            for wv in writes:
                                self._var_errors.pop(wv, None)
                except BaseException as e:
                    rc = 1
                    # "consumed" is shared by the propagated copies, so
                    # wait_for_all raises the error once
                    rec = {"exc": e, "label": label, "site": site,
                           "via": [], "consumed": [False]}
                    err_text = "%s: %s [engine op %r pushed at %s]" % (
                        type(e).__name__, e, label, site)
                    self._record_error(writes, rec)
                    try:
                        from . import guardrails
                        guardrails.emit("engine_error", label=label,
                                        site=site, error="%s: %s"
                                        % (type(e).__name__, e))
                    except Exception:
                        pass
            with self._live_lock:
                self._meta.pop(ctx_token, None)
            if t_run is not None:
                try:
                    _record_op_done(label, site, t_queued, t_run,
                                    bool(rc), ginc)
                except Exception:  # noqa: BLE001 - never poison the op
                    pass
            if on_done is not None:
                # after the op's own bookkeeping, on the worker thread; a
                # failing hook never poisons the op's result
                try:
                    on_done(bool(rc))
                except Exception:  # noqa: BLE001
                    pass
            if rc:
                try:
                    msg = (err_text or "engine op failed") \
                        .encode("utf-8", "replace")[:err_cap - 1]
                    ctypes.memmove(err_out, msg + b"\x00", len(msg) + 1)
                except Exception:
                    pass
            return rc

        self._cb = self._cb_type(_dispatch)

    def _record_error(self, writes, rec):
        with self._live_lock:
            for wv in writes:
                self._var_errors.setdefault(wv, rec)

    def new_var(self) -> int:
        return self._lib.MXEngineNewVar(self._h)

    def delete_var(self, var: int) -> bool:
        """True if deleted; False while the var has pending ops (the
        caller may retry after a wait)."""
        ok = self._lib.MXEngineDeleteVar(self._h, var) == 0
        if ok:
            with self._live_lock:
                self._var_errors.pop(var, None)
        return ok

    def push_async(self, fn, read_vars=(), write_vars=(), label=None,
                   on_done=None, collective=None):
        """Schedule ``fn()`` once its read and write dependencies clear.
        ``label`` (default: the callable's name) names the op in errors
        and in the watchdog's report. A raised exception poisons the
        written vars and re-raises at the wait. ``on_done(failed)``, if
        given, runs on the worker thread after the op, whether it failed
        or not; its exceptions are swallowed. ``collective`` declares
        that ``fn`` runs a multi-device program: ``{"program": label,
        "lock": id of the serializing lock the caller holds around it, or
        None}``. It is kept in the op's record (:meth:`pending_ops`,
        :meth:`collective_pushes`) for the collective-interleave check,
        and changes nothing of the op's execution."""
        if label is None:
            label = getattr(fn, "__name__", None) or "<unlabeled>"
        site = _enqueue_site()
        from . import faultinject
        if faultinject.active():
            if read_vars and faultinject.should_fail("engine_dep_drop"):
                # drop one declared read edge: the op still runs, its
                # order against that producer left to chance
                read_vars = tuple(read_vars)[1:]
            if collective is not None \
                    and collective.get("lock") is not None \
                    and faultinject.should_fail(
                        "engine_collective_overlap"):
                # strip the serializing-lock sanction from the record:
                # the execution stays under its lock, but the checker
                # sees two multi-device programs with no shared lock
                collective = dict(collective, lock=None)
            real_fn = fn

            def fn(real_fn=real_fn, label=label):
                faultinject.maybe_fail(
                    "engine_op", msg="injected fault: engine_op %r" % label)
                real_fn()
        t_queued = None
        ginc = False
        if _tele_live():
            t_queued = time.perf_counter()
            if telemetry.enabled():
                ml = _metric_label(label)
                telemetry.counter("mx_engine_ops_total", label=ml).inc()
                telemetry.gauge("mx_engine_pending_ops").inc()
                ginc = True
        with self._live_lock:
            token = self._next
            self._next += 1
            self._fns[token] = fn
            self._meta[token] = (label, site, tuple(read_vars),
                                 tuple(write_vars), t_queued, ginc, on_done,
                                 collective)
            if collective is not None:
                self._collectives.append((label, dict(collective)))
        r = (ctypes.c_uint64 * max(1, len(read_vars)))(*read_vars)
        w = (ctypes.c_uint64 * max(1, len(write_vars)))(*write_vars)
        rc = self._lib.MXEnginePushAsync(
            self._h, ctypes.cast(self._cb, ctypes.c_void_p),
            ctypes.c_void_p(token), r, len(read_vars), w, len(write_vars))
        if rc != 0:
            with self._live_lock:
                self._fns.pop(token, None)
                self._meta.pop(token, None)
            if ginc:
                telemetry.gauge("mx_engine_pending_ops").dec()
            raise MXNetError(self._lib.MXGetLastError().decode(
                "utf-8", "replace"))

    # ------------------------------------------------------------------
    def _pop_error(self, var):
        with self._live_lock:
            return self._var_errors.pop(var, None)

    @staticmethod
    def _reraise(rec):
        """Re-raise the original exception with its op's label and
        enqueue site (type kept, the original chained as __cause__)."""
        rec.get("consumed", [False])[0] = True
        exc = rec["exc"]
        ctx = "[engine op %r pushed at %s%s]" % (
            rec["label"], rec["site"],
            "; propagated through %s" % rec["via"] if rec.get("via")
            else "")
        try:
            new = type(exc)("%s %s" % (exc, ctx))
        except Exception:
            new = MXNetError("%s: %s %s" % (type(exc).__name__, exc, ctx))
        raise new from exc

    def collective_pushes(self):
        """``[(label, descriptor)]`` of the latest pushes that declared a
        ``collective`` (at most 256, oldest first), as recorded: what the
        collective-interleave check reads."""
        with self._live_lock:
            return [(label, dict(d)) for label, d in self._collectives]

    def pending_ops(self):
        """``[(label, site, reads, writes)]`` of the ops not completed
        yet (the watchdog's report)."""
        with self._live_lock:
            return [m[:4] for m in self._meta.values()]

    def _blocking_wait(self, call, what):
        """Run a blocking C wait, under the watchdog when
        ``MXNET_ENGINE_WATCHDOG`` is set: past the deadline, raise with
        every pending op's label and enqueue site."""
        deadline = float(_cfg("MXNET_ENGINE_WATCHDOG") or 0.0)
        if deadline <= 0:
            return call()
        box = {}
        done = threading.Event()

        def _run():
            try:
                box["rc"] = call()
            except BaseException as e:   # pragma: no cover - ctypes
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=_run, daemon=True,
                             name="mxt-engine-wait")
        t.start()
        if not done.wait(deadline):
            pending = self.pending_ops()
            diag = "\n".join(
                "  op %r (reads=%s writes=%s) pushed at %s"
                % (lbl, list(rd), list(wr), st)
                for lbl, st, rd, wr in pending) or "  (none known)"
            try:
                from . import guardrails
                guardrails.emit("watchdog", where="engine", wait=what,
                                deadline=deadline,
                                pending=[p[0] for p in pending])
            except Exception:
                pass
            raise MXNetError(
                "engine watchdog: wait on %s exceeded %.1fs "
                "(MXNET_ENGINE_WATCHDOG); pending op(s):\n%s"
                % (what, deadline, diag))
        if "err" in box:
            raise box["err"]
        return box.get("rc", 0)

    def wait_for_var(self, var: int):
        rc = self._blocking_wait(
            lambda: self._lib.MXEngineWaitForVar(self._h, var),
            "var %d" % var)
        if rc != 0:
            rec = self._pop_error(var)
            if rec is not None:
                self._reraise(rec)
            raise MXNetError(self._lib.MXGetLastError().decode(
                "utf-8", "replace"))

    def wait_for_all(self):
        """Barrier over every pushed op; the first error not raised yet
        re-raises here with its op's context."""
        self._blocking_wait(
            lambda: self._lib.MXEngineWaitForAll(self._h), "all")
        with self._live_lock:
            if not self._var_errors:
                return
            # errors raised at a wait_for_var already are not raised again
            recs = [r for r in self._var_errors.values()
                    if not r.get("consumed", [False])[0]]
            self._var_errors.clear()
        if recs:
            self._reraise(recs[0])

    def close(self):
        if self._h:
            # drain without raising: the native handle is always freed
            self._lib.MXEngineWaitForAll(self._h)
            self._lib.MXEngineFree(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the facade: on_dispatch, the waits, NaiveEngine
# ---------------------------------------------------------------------------
_NAIVE = [False]     # read by ndarray.invoke on every op


class Engine:
    """The engine facade over torch's asynchronous streams."""

    def __init__(self):
        _NAIVE[0] = _cfg("MXNET_ENGINE_TYPE") == "NaiveEngine"

    @property
    def is_naive(self) -> bool:
        return _NAIVE[0]

    def set_naive(self, naive: bool):
        _NAIVE[0] = bool(naive)

    def on_dispatch(self, t):
        """An op's output or a new array (a tensor, or a tuple of them).
        Under ``NaiveEngine`` the card's stream is synchronised here, so
        an asynchronous fault raises at its op; never while the stream
        is being captured into a CUDA graph."""
        if not _NAIVE[0]:
            return
        ts = t if isinstance(t, (tuple, list)) else (t,)
        for x in ts:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                if torch.cuda.is_current_stream_capturing():
                    return
                torch.cuda.current_stream(x.device).synchronize()
                return

    def wait_for_var(self, t):
        """Block until the tensor's values are computed (its stream's
        work done); an asynchronous device error raises here."""
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    def wait_for_all(self):
        """Every card's queued work, then the native engine's ops."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        native_wait_all()


_ENGINE = Engine()


def engine() -> Engine:
    return _ENGINE


# ---------------------------------------------------------------------------
# the process's native engine and NDArray gating
# ---------------------------------------------------------------------------
_NATIVE = None
_NATIVE_LOCK = threading.Lock()
_DEFERRED_VARS: list = []
_EXEC_TLS = threading.local()    # write vars of the op running on a thread


def native_engine() -> NativeDependencyEngine:
    """The process's native dependency engine, created at first use with
    ``MXNET_CUSTOM_OP_NUM_THREADS`` workers (0: those of
    ``MXNET_CPU_WORKER_NTHREADS``); under ``NaiveEngine`` every push
    runs at once on the pushing thread. Raises MXNetError when the
    library cannot be built."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            workers = int(_cfg("MXNET_CUSTOM_OP_NUM_THREADS")) or \
                int(_cfg("MXNET_CPU_WORKER_NTHREADS"))
            _NATIVE = NativeDependencyEngine(
                num_workers=max(1, workers),
                naive=_cfg("MXNET_ENGINE_TYPE") == "NaiveEngine")
        return _NATIVE


def native_wait_all():
    """Barrier over the native engine, if one was created (part of
    ``nd.waitall``)."""
    if _NATIVE is not None:
        _NATIVE.wait_for_all()


def native_drain():
    """Wait for every op of the native engine, raising nothing (a CUDA
    graph capture starts with no worker running); errors stay for the
    waits that touch them. An engine op would wait for itself: on a
    worker thread this raises MXNetError (a capture belongs outside the
    engine's ops)."""
    if getattr(_EXEC_TLS, "in_op", False):
        raise MXNetError("engine: an engine op cannot drain the engine "
                         "(it would wait for itself); capture outside the "
                         "engine's ops")
    if _NATIVE is not None and _NATIVE._h:
        _NATIVE._blocking_wait(
            lambda: _NATIVE._lib.MXEngineWaitForAll(_NATIVE._h), "all")


def push_gated(fn, write_var, read_vars=(), label=None):
    """``push_async`` with the running op's write var published on its
    thread, so an op that reads its own gated outputs does not wait on
    itself."""
    def wrapped(fn=fn, wv=(write_var,)):
        prev = getattr(_EXEC_TLS, "vars", ())
        _EXEC_TLS.vars = wv
        try:
            fn()
        finally:
            _EXEC_TLS.vars = prev
    native_engine().push_async(wrapped, read_vars=read_vars,
                               write_vars=(write_var,),
                               label=label or getattr(fn, "__name__", None))


class EngineGate:
    """The ``NDArray._pending`` marker of arrays an engine op produces:
    ``_pending = (gate, slot, meta)``. The first read calls
    :meth:`force`, which waits for the var and re-raises the op's error.
    The var is deleted when the gate dies (retried later while its op
    is still in flight)."""

    __slots__ = ("var", "arrays", "__weakref__")

    def __init__(self, var, arrays=()):
        self.var = var
        self.arrays = list(arrays)
        weakref.finalize(self, _release_var, var)

    def force(self):
        if self.var in getattr(_EXEC_TLS, "vars", ()):
            return   # the producing op reads its own output
        native_engine().wait_for_var(self.var)   # raises if poisoned
        self.clear()

    def clear(self):
        """The values are in place: drop the marks."""
        for a in self.arrays:
            p = a._pending
            if p is not None and p[0] is self:
                a._pending = None


def _release_var(var):
    """Gate finalizer: delete the var, deferred while its op runs."""
    try:
        if _NATIVE is None:
            return
        if not _NATIVE.delete_var(var):
            with _NATIVE_LOCK:
                _DEFERRED_VARS.append(var)
    except Exception:
        pass


def _drain_deferred_vars():
    if not _DEFERRED_VARS or _NATIVE is None:
        return
    with _NATIVE_LOCK:
        pend, _DEFERRED_VARS[:] = list(_DEFERRED_VARS), []
    for v in pend:
        try:
            if not _NATIVE.delete_var(v):
                with _NATIVE_LOCK:
                    _DEFERRED_VARS.append(v)
        except Exception:
            pass


def gate_arrays(arrays, metas):
    """A new engine var and its gate, with ``arrays`` marked pending on
    it; returns (var, gate). Push the producing op with ``write_var=var``
    (:func:`push_gated`)."""
    _drain_deferred_vars()
    var = native_engine().new_var()
    gate = EngineGate(var, arrays)
    for i, (a, meta) in enumerate(zip(arrays, metas)):
        a._pending = (gate, i, meta)
    return var, gate


def read_deps(arrays):
    """The engine vars of the inputs still gated on an engine op: the
    read set of a consumer's push."""
    deps = []
    for a in arrays:
        p = getattr(a, "_pending", None)
        if p is not None and isinstance(p[0], EngineGate):
            deps.append(p[0].var)
    return deps


def pin_reads(arrays, gate):
    """Register ``gate`` (a pushed op's write gate) as a pending reader
    of each engine-gated input, so an in-place write on the main thread
    waits for the op first (write after read). The inputs not gated are
    snapshotted by the caller instead. Returns the pinned arrays: call
    :func:`unpin_reads` with them when the read is over."""
    pinned = []
    for a in arrays:
        p = getattr(a, "_pending", None)
        if p is None or not isinstance(p[0], EngineGate):
            continue
        if a._read_pins is None:
            a._read_pins = []
        a._read_pins.append(gate)
        pinned.append(a)
    return pinned


def unpin_reads(pinned, gate):
    """Drop a finished reader's pins."""
    for a in pinned:
        pins = a._read_pins
        if pins:
            try:
                pins.remove(gate)
            except ValueError:
                pass


def consume_read_pins(array):
    """Wait until every reader pinned on ``array`` ran, then drop the
    pins. Inside an engine op nothing waits and the pins stay for the
    main thread: the producer writing its own gated output must not wait
    on readers that depend on it, and two readers must not wait on each
    other. A reader's failure is not raised here: it surfaces at the
    reader's outputs."""
    pins = array._read_pins
    if not pins:
        return
    if getattr(_EXEC_TLS, "vars", ()):
        return
    array._read_pins = None
    for gate in pins:
        try:
            native_engine().wait_for_var(gate.var)
        except Exception:
            pass
