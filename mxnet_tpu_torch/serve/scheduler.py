"""Continuous-batching request scheduler (counterpart of
``mxnet_tpu/serve/scheduler.py``).

Serving a captured program is a batching problem: the card wants full
bucket-sized batches, clients want bounded latency, tenants want
isolation from each other.

- **Admission.** :meth:`Scheduler.submit` enqueues per tenant. A tenant
  past its ``queue_cap`` gets a typed :class:`OverloadError` (code
  ``overload``) at once, and a request whose tenant deadline passes
  while queued is shed with code ``timeout``.
- **Weighted-fair assembly.** Batches are assembled by stride
  scheduling over the tenant queues: each admitted request advances its
  tenant's virtual pass by rows / weight, and the next admit goes to the
  lowest pass, so a tenant of weight 2 gets twice the rows of a weight-1
  tenant under saturation; an idle tenant re-enters at the current
  virtual time. Each tenant's order stays FIFO.
- **Continuous batching on the dependency engine.** An assembled batch
  is pushed to the native engine (:mod:`mxnet_tpu_torch.engine`) as op
  ``serve.batch``, and the assembler builds the next batch while the
  card runs this one; the op's completion hook
  (``push_async(on_done=...)``) frees the in-flight slot.
  ``MXNET_SERVE_INFLIGHT`` caps the pipeline's depth and
  ``MXNET_SERVE_MAX_WAIT_MS`` how long a batch's first request waits
  for company. At an in-flight cap of 1 a batch runs on the batcher's
  thread, as the reference runs it: the engine would buy no overlap.
  Otherwise the engine must build; a build failure raises, with no
  synchronous fallback. A batch whose bucket the session has not
  captured yet runs on the batcher's thread too: a capture drains the
  engine first, which an engine op cannot do.
- **Graceful drain.** :meth:`close` stops admission, serves what is
  queued for up to ``MXNET_SERVE_DRAIN_S``, fails the rest with code
  ``drain`` and waits for the batches in flight.

Requests of different sequence buckets never share a batch. The
session serialises its requests (its ``_exec_lock``), so two batches in
flight overlap one's host work (assembly, padding, the replies) with the
other's run on the card. Under a sampled trace each request gets the
spans ``sched::queue``, ``sched::batch`` and ``engine::serve.batch``.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

_LOG = logging.getLogger("mxnet_tpu_torch.serve")

from ..base import MXNetError
from .. import engine as engine_mod
from .. import tracing
from .tenancy import OverloadError, TenantConfig, record_request, \
    set_queue_depth

__all__ = ["Scheduler", "ServeFuture"]


class ServeFuture:
    """Handle of one submitted request. ``result(timeout)`` blocks
    until served and returns the outputs (numpy), or raises the typed
    error (:class:`OverloadError` on shed, the original exception on a
    failed batch)."""

    __slots__ = ("_ev", "_result", "_exc", "tenant", "order")

    def __init__(self, tenant: str, order: int):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.tenant = tenant
        self.order = order       # process-wide admission sequence number

    def done(self) -> bool:
        return self._ev.is_set()

    def _set_result(self, value):
        self._result = value
        self._ev.set()

    def _set_exception(self, exc: BaseException):
        self._exc = exc
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise MXNetError("ServeFuture.result: timed out after %ss"
                             % timeout)
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("tenant", "arrays", "n", "seq", "seq_rung", "tokens",
                 "future", "t_submit", "trace")

    def __init__(self, tenant, arrays, n, seq, seq_rung, tokens, future):
        self.tenant = tenant
        self.arrays = arrays
        self.n = n
        self.seq = seq
        self.seq_rung = seq_rung
        self.tokens = tokens
        self.future = future
        self.t_submit = time.perf_counter()
        # the ambient trace context at submit (a replica binds the wire
        # context around Scheduler.submit); one cached read when off
        tr = tracing.current() if tracing.active() else None
        self.trace = tr if (tr is not None and tr.sampled) else None


class Scheduler:
    """Async continuous-batching front of one
    :class:`~.session.InferenceSession` (see module docstring)."""

    def __init__(self, session, tenants: Optional[Sequence[TenantConfig]]
                 = None, max_wait_ms: Optional[float] = None,
                 inflight: Optional[int] = None):
        from ..config import get as _cfg
        self._session = session
        self._tenants: Dict[str, TenantConfig] = {}
        for t in (tenants or []):
            self._tenants[t.name] = t
        self._max_wait_s = (float(_cfg("MXNET_SERVE_MAX_WAIT_MS"))
                            if max_wait_ms is None else float(max_wait_ms)
                            ) / 1e3
        self._cap_inflight = max(1, int(_cfg("MXNET_SERVE_INFLIGHT"))
                                 if inflight is None else int(inflight))
        self._cv = threading.Condition()
        self._q: Dict[str, collections.deque] = {}
        self._order: List[str] = []      # tenant admission order (FIFO of
        #                                  first submit; the WRR sweep order)
        self._pass: Dict[str, float] = {}
        self._rows = 0                   # running total of queued rows
        #                                  (O(1) per cv wakeup; maintained
        #                                  at append/admit/shed under _cv)
        self._vt = 0.0                   # global virtual time: the pass of
        #                                  the most recent admit — idle
        #                                  tenants re-enter HERE, not at
        #                                  their stale pass (no burst debt)
        self._inflight = 0
        self._seq = 0
        self._closed = False
        self._drain_deadline: Optional[float] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mx-serve-batcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def _cfg_for(self, tenant: str) -> TenantConfig:
        cfg = self._tenants.get(tenant)
        if cfg is None:
            cfg = self._tenants[tenant] = TenantConfig(tenant)
        return cfg

    def submit(self, *data, tenant: str = "default",
               tokens: Optional[float] = None) -> ServeFuture:
        """Enqueue one request (rows = the inputs' leading dim).
        Returns a :class:`ServeFuture`; raises :class:`OverloadError`
        immediately when the engine is closed or the tenant's queue is
        at cap (fail fast — the client's retry policy needs the signal
        NOW, not after a dead wait)."""
        cfg = self._cfg_for(tenant)
        hosts = [self._session._as_host(x) for x in data]
        # validate HERE, where the fail-fast contract lives: a
        # malformed request must fail its own submit, not hang a
        # future (0 rows never wakes the assembler) or poison the
        # whole assembled batch other tenants share. ONE shape
        # contract, owned by the session (infer shares it).
        self._session.validate_request(hosts)
        n = int(hosts[0].shape[0])
        seq_axis = self._session.seq_axis
        seq = int(hosts[0].shape[seq_axis]) if seq_axis is not None else None
        seq_rung = (self._session.ladder.bucket_for(1, seq)[0][-1]
                    if seq_axis is not None else None)
        tok = float(tokens) if tokens is not None else float(
            n * (seq if seq is not None else 1))
        with self._cv:
            if self._closed:
                record_request(tenant, "drain")
                raise OverloadError(
                    "serve scheduler is shutting down", code="drain",
                    tenant=tenant)
            q = self._q.get(tenant)
            if q is None:
                q = self._q[tenant] = collections.deque()
                self._order.append(tenant)
                self._pass.setdefault(tenant, 0.0)
            if not q:
                # queue empty -> nonempty: the tenant re-enters the
                # stride schedule at the CURRENT virtual time — a
                # stale low pass would let a long-idle tenant
                # monopolize assembly until its debt burned off,
                # starving the tenants that kept the engine busy
                self._pass[tenant] = max(self._pass[tenant], self._vt)
            if len(q) >= cfg.queue_cap:
                record_request(tenant, "overload")
                raise OverloadError(
                    "tenant %r queue at cap (%d queued, cap %d) — "
                    "shedding instead of queuing forever"
                    % (tenant, len(q), cfg.queue_cap),
                    code="overload", tenant=tenant)
            self._seq += 1
            fut = ServeFuture(tenant, self._seq)
            q.append(_Request(tenant, hosts, n, seq, seq_rung, tok, fut))
            self._rows += n
            set_queue_depth(tenant, len(q))
            self._cv.notify_all()
        return fut

    # ------------------------------------------------------------------
    # batcher internals (all queue state under self._cv)
    # ------------------------------------------------------------------
    def _queued_rows(self) -> int:
        return self._rows

    def _shed_expired_locked(self, everything: bool = False
                             ) -> List[_Request]:
        """Pop requests past their tenant deadline (or ALL of them on
        the drain path) — failed outside the lock by the caller (the
        caller picks the OverloadError code)."""
        now = time.perf_counter()
        out = []
        for tenant, q in self._q.items():
            cfg = self._cfg_for(tenant)
            keep = collections.deque()
            shed = 0
            while q:
                r = q.popleft()
                dead = everything or (
                    cfg.deadline_ms > 0
                    and (now - r.t_submit) * 1e3 > cfg.deadline_ms)
                if dead:
                    out.append(r)
                    self._rows -= r.n
                    shed += 1
                else:
                    keep.append(r)
            self._q[tenant] = keep
            if shed:
                set_queue_depth(tenant, len(keep))
        return out

    def _fail(self, reqs: List[_Request], code: str, msg: str):
        for r in reqs:
            record_request(r.tenant, code)
            r.future._set_exception(
                OverloadError(msg % {"tenant": r.tenant}, code=code,
                              tenant=r.tenant))

    def _assemble_locked(self) -> List[_Request]:
        """Weighted-fair (stride-scheduled) batch assembly; requests
        sharing the batch must share a seq rung (same padded
        program)."""
        cap = self._session.max_batch
        if not any(self._q[t] for t in self._order):
            return []
        head_rung = [None]
        batch: List[_Request] = []
        rows = 0
        while rows < cap:
            cands = []
            for t in self._order:
                q = self._q[t]
                if not q:
                    continue
                r = q[0]
                # an oversized request (n >= cap) is served ALONE —
                # skipping it forever would spin the assembler
                if batch and rows + r.n > cap:
                    continue
                if head_rung[0] is not None \
                        and r.seq_rung != head_rung[0]:
                    continue
                cands.append(t)
            if not cands:
                break
            t = min(cands, key=lambda t: (self._pass[t],
                                          self._order.index(t)))
            r = self._q[t].popleft()
            self._rows -= r.n
            set_queue_depth(t, len(self._q[t]))
            # charge ROWS, not requests: batch slots are the shared
            # resource, and a tenant shipping 8-row requests must pay
            # 8x what a 1-row tenant pays per admit
            self._pass[t] += float(r.n) / self._cfg_for(t).weight
            self._vt = max(self._vt, self._pass[t])
            if head_rung[0] is None:
                head_rung[0] = r.seq_rung
            batch.append(r)
            rows += r.n
        return batch

    def _loop(self):
        leftovers: List[_Request] = []
        while True:
            # -- wait for work (or shutdown) ---------------------------
            with self._cv:
                while not self._closed and self._queued_rows() == 0:
                    self._cv.wait(0.2)
                if self._closed:
                    now = time.perf_counter()
                    past = (self._drain_deadline is not None
                            and now >= self._drain_deadline)
                    if self._queued_rows() == 0 or past:
                        leftovers = self._shed_expired_locked(
                            everything=True)
                        break
            try:
                self._serve_one_window()
            except Exception:
                # the batcher daemon must NEVER die silently: a dead
                # assembler turns every future into a client-side
                # hang. Log, breathe, keep serving.
                _LOG.exception("serve batcher: window failed; "
                               "continuing")
                time.sleep(0.05)
        # -- drain epilogue (loop exited under close) ------------------
        if leftovers:
            self._fail(leftovers, "drain",
                       "serve scheduler drained before tenant "
                       "%(tenant)r's request ran")
        # bounded wait for in-flight batches: a batch hung past the
        # deadline cannot be completed from here — give up (its own
        # futures are the clients' result(timeout) problem) rather
        # than wedging this thread forever
        give_up = (self._drain_deadline or time.perf_counter()) + 30.0
        with self._cv:
            while self._inflight > 0 \
                    and time.perf_counter() < give_up:
                self._cv.wait(0.2)

    def _serve_one_window(self):
        """One batch-assembly window: wait for company, respect the
        in-flight cap, shed expired, assemble, dispatch."""
        deadline = time.perf_counter() + self._max_wait_s
        batch: List[_Request] = []
        expired: List[_Request] = []
        with self._cv:
            while not self._closed:
                if self._queued_rows() >= self._session.max_batch:
                    break
                remain = deadline - time.perf_counter()
                if remain <= 0:
                    break
                self._cv.wait(remain)
            # respect the in-flight cap: backpressure belongs in
            # the queues, not stacked on the engine. Past a drain
            # deadline, stop waiting on a possibly-hung batch — the
            # loop top then sheds the queue with code='drain' instead
            # of leaving every queued client hanging.
            while self._inflight >= self._cap_inflight:
                if self._closed and self._drain_deadline is not None \
                        and time.perf_counter() >= self._drain_deadline:
                    return
                self._cv.wait(0.2)
            # shed stale requests at the last moment BEFORE
            # spending batch rows on them — the in-flight wait
            # above is exactly where queued deadlines expire
            expired = self._shed_expired_locked()
            batch = self._assemble_locked()
            if batch:
                self._inflight += 1
        if expired:
            self._fail(expired, "timeout",
                       "tenant %(tenant)r deadline passed while "
                       "queued — request shed")
        if batch:
            try:
                self._dispatch(batch)
            except BaseException as e:
                # dispatch itself failed (e.g. the native engine
                # rejected the push BEFORE on_done could ever fire):
                # the batch's futures must still complete and the
                # in-flight slot must come back
                for r in batch:
                    if not r.future.done():
                        record_request(r.tenant, "error")
                        r.future._set_exception(e)
                self._on_batch_done(True)
                raise

    # ------------------------------------------------------------------
    def _dispatch(self, reqs: List[_Request]):
        """Run one assembled batch through the session as ONE engine op
        (``serve.batch``): concat rows (seq-padded to the shared rung),
        infer, scatter result rows back to the futures. The engine's
        on_done completion callback frees the in-flight slot."""
        session = self._session
        seq_axis = session.seq_axis
        t_admit = time.perf_counter()
        # traced requests (sampled remote contexts captured at submit):
        # the wall anchor pins this batch's perf_counter stamps onto
        # the wall clock so the spans are skew-correctable cross-process
        traced = [r for r in reqs if r.trace is not None] \
            if tracing.active() else []
        tw0 = time.time() if traced else 0.0

        def _wall(tp):
            return tw0 + (tp - t_admit)

        def run_batch():
            datas = []
            for i in range(len(reqs[0].arrays)):
                parts = []
                for r in reqs:
                    a = r.arrays[i]
                    if seq_axis is not None and a.ndim > seq_axis \
                            and r.seq_rung is not None \
                            and a.shape[seq_axis] < r.seq_rung:
                        shape = list(a.shape)
                        shape[seq_axis] = r.seq_rung
                        buf = torch.zeros(shape, dtype=a.dtype)
                        buf[tuple(slice(0, n) for n in a.shape)] = a
                        a = buf
                    parts.append(a)
                datas.append(parts[0] if len(parts) == 1
                             else torch.cat(parts, dim=0))
            te0 = time.perf_counter()
            if traced:
                # bind the first traced request's context on this thread
                # (the engine worker), so the session's forward span is
                # tagged with the remote trace
                with tracing.bind(traced[0].trace):
                    outs = session.infer(*datas)
            else:
                outs = session.infer(*datas)
            outs = outs if isinstance(outs, list) else [outs]
            t_done = time.perf_counter()
            total_rows = sum(r.n for r in reqs)
            for r in traced:
                # recorded before any future is set, so the replica's
                # reply (fleet's take_for) finds this request's spans
                tracing.record_span("sched::queue", "assembly",
                                    _wall(r.t_submit), _wall(t_admit),
                                    ctx=r.trace,
                                    args={"tenant": r.tenant})
                tracing.record_span("sched::batch", "sched",
                                    _wall(t_admit), _wall(te0),
                                    ctx=r.trace,
                                    args={"requests": len(reqs),
                                          "rows": total_rows})
                tracing.record_span("engine::serve.batch", "engine",
                                    _wall(te0), _wall(t_done),
                                    ctx=r.trace,
                                    args={"rows": total_rows})
            scales = session._out_scales
            offset = 0
            for r in reqs:
                rows = []
                for i, o in enumerate(outs):
                    # split only the outputs that carry the batch axis
                    # (the session's probe, else the shape heuristic); a
                    # batch-reduced output goes to every request whole
                    batched = (scales[i][0] if scales else
                               o.ndim and o.shape[0] == total_rows)
                    seqful = (scales[i][1] if scales else
                              seq_axis is not None
                              and o.ndim > seq_axis
                              and o.shape[seq_axis] == r.seq_rung)
                    seg = o[offset:offset + r.n] if batched else o
                    # the batch was padded to the shared rung before the
                    # session saw it: restore each request's own length
                    # (what a direct infer returns)
                    if (seqful and seq_axis is not None
                            and r.seq is not None
                            and seg.ndim > seq_axis
                            and seg.shape[seq_axis] == r.seq_rung
                            and r.seq != r.seq_rung):
                        idx = [slice(None)] * seg.ndim
                        idx[seq_axis] = slice(0, r.seq)
                        seg = seg[tuple(idx)]
                    rows.append(seg)
                offset += r.n
                cfg = self._cfg_for(r.tenant)
                record_request(r.tenant, "ok",
                               latency_s=t_done - r.t_submit,
                               queue_s=t_admit - r.t_submit,
                               tokens=r.tokens,
                               deadline_ms=cfg.deadline_ms)
                r.future._set_result(rows if len(rows) > 1 else rows[0])

        def run_guarded():
            try:
                run_batch()
            except BaseException as e:
                for r in reqs:
                    # requests already completed (and counted 'ok')
                    # before a mid-scatter failure keep their result
                    # and must not double-count as 'error'
                    if not r.future.done():
                        record_request(r.tenant, "error")
                        r.future._set_exception(e)
                raise    # let the engine poison/record the op too

        # an in-flight cap of 1 serialises batches: the engine would buy
        # no overlap and cost a thread hand-off a batch, so the batch
        # runs here. So does a cold bucket's batch, whose capture drains
        # the engine and so cannot run inside an engine op. From 2 up
        # warm batches pipeline through the engine, which must build (a
        # failed build raises: no synchronous fallback).
        if self._cap_inflight > 1 and session._is_warm(
                sum(r.n for r in reqs), reqs[0].seq_rung):
            # a session over several devices declares its program and
            # its serializing lock (InferenceSession.collective_tag)
            engine_mod.native_engine().push_async(
                run_guarded, label="serve.batch",
                on_done=self._on_batch_done,
                collective=session.collective_tag())
        else:
            failed = False
            try:
                run_guarded()
            except BaseException:
                failed = True
            self._on_batch_done(failed)

    def _on_batch_done(self, failed: bool):
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    # ------------------------------------------------------------------
    @property
    def inflight(self) -> int:
        return self._inflight

    def queue_depth(self, tenant: Optional[str] = None) -> int:
        with self._cv:
            if tenant is not None:
                return len(self._q.get(tenant, ()))
            return sum(len(q) for q in self._q.values())

    def stats(self) -> dict:
        """One consistent load snapshot: what a fleet replica publishes
        in its lease (serve/fleet.py)."""
        with self._cv:
            return {"queue_depth": sum(len(q) for q in self._q.values()),
                    "inflight": self._inflight,
                    "tenants": sorted(self._q)}

    def close(self, drain: Optional[float] = None):
        """Graceful shutdown: stop admission now, keep serving queued
        requests for up to `drain` seconds (default
        MXNET_SERVE_DRAIN_S), fail the rest with OverloadError
        (code='drain'), wait for in-flight batches."""
        from ..config import get as _cfg
        drain_s = (float(_cfg("MXNET_SERVE_DRAIN_S")) if drain is None
                   else float(drain))
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._drain_deadline = time.perf_counter() + drain_s
            self._cv.notify_all()
        self._thread.join(timeout=drain_s + 30.0)
