"""The serving fleet: replica processes, their supervisor and a
health-gated router (counterpart of ``mxnet_tpu/serve/fleet.py``).

- :class:`ReplicaServer`: the wire front of one replica, a stdlib TCP
  server on a :class:`~.scheduler.Scheduler`. Every heartbeat it
  publishes a TTL'd liveness lease with a health snapshot (queue depth,
  p99, tokens/s, the bucket table, spans, a compact telemetry slice)
  into the fleet KV (:func:`mxnet_tpu_torch.dist.fleet_kv`), and it
  drains on a KV notice (:func:`mxnet_tpu_torch.elastic.consume_kv_notice`)
  or on SIGTERM.
- :func:`replica_main` and :class:`ReplicaManager`: replica processes
  (multiprocessing spawn) and their supervisor, which spawns N, kills or
  drains one and waits for their leases. Replicas load their weights
  through :func:`mxnet_tpu_torch.model.load_latest_checkpoint` (checked
  against its sha256), so a respawned replica boots from the published
  set. One deliberate difference: a replica runs on the card
  (``gpu(0)``) unless its spec says ``"ctx": "cpu"``; the reference's
  replicas default to the CPU.
- :class:`Router`: spreads requests over the live replicas by their
  lease load, with the whole resilience ladder: a replica missing
  ``MXNET_SERVE_FLEET_MISS_K`` heartbeats is ejected before new work
  lands on it, a circuit breaker a replica with backed-off half-open
  probes, bounded retries of idempotent requests on another replica,
  hedged requests (``MXNET_SERVE_HEDGE_MS``: the first completion wins,
  the loser is counted), the deadline carried end to end, typed
  :class:`~.tenancy.OverloadError` sheds on the wire, and failover
  exactly once: a request in flight on a dead replica is resubmitted,
  and :class:`FleetFuture` delivers only its first completion.

Wire format (stdlib only): one frame is ``<u32 header_len><json
header><raw array bytes>``, byte for byte the reference's; the header
carries the op, tenant and deadline and each array's shape, dtype and
byte count, and the arrays ride as raw numpy bytes. Requests on one
connection are served in turn; the router pools connections a replica.

The ``mx_fleet_*`` series count replica liveness, outcomes and latency
by replica, retries by reason, hedges, failovers, sheds by code, breaker
transitions, KV errors and the last-known-good (stale routing) flag. The
``replica_crash``, ``replica_slow`` and ``kv_flap`` fault sites make
every rung testable on one host.
"""
from __future__ import annotations

import collections
import concurrent.futures
import json
import logging
import os
import socket
import struct
import threading
import time
import uuid
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import config
from .. import dist
from .. import elastic
from .. import faultinject
from .. import telemetry
from .. import tracing
from ..base import MXNetError
from . import tenancy
from .tenancy import OverloadError, TenantConfig

__all__ = ["ReplicaServer", "ReplicaManager", "Router", "FleetFuture",
           "replica_main", "demo_factory", "fleet_table",
           "render_fleet_table", "render_replica_metrics", "explain"]

_LOG = logging.getLogger(__name__)

_LAST_ROUTER = None     # weakref to the most recent Router (explain())


def _cfg(name):
    from ..config import get
    return get(name)


def _replica_prefix(fleet: str) -> str:
    return "mx/fleet/%s/replicas/" % fleet


def _drain_key(fleet: str, rid: str) -> str:
    return "mx/fleet/%s/drain/%s" % (fleet, rid)


_TELE_PREFIXES = ("mx_serve_", "mx_engine_", "mx_jit_")
_TELE_CAP = 128      # keys per kind — a lease payload stays small


def _tele_compact() -> dict:
    """Compact slice of this replica's telemetry registry for the
    health-lease payload: serving/engine counters and gauges plus
    latency-histogram summaries, capped so a label explosion cannot
    bloat every heartbeat."""
    snap = telemetry.snapshot()
    out = {"counters": {}, "gauges": {}, "summaries": {}}
    for kind in ("counters", "gauges"):
        for key in sorted(snap[kind]):
            if key.startswith(_TELE_PREFIXES):
                out[kind][key] = snap[kind][key]
                if len(out[kind]) >= _TELE_CAP:
                    break
    for key in sorted(snap["histograms"]):
        if key.startswith(_TELE_PREFIXES):
            s = snap["histograms"][key]
            out["summaries"][key] = {"count": s["count"],
                                     "sum": s["sum"], "p99": s["p99"]}
            if len(out["summaries"]) >= _TELE_CAP:
                break
    return out


# ---------------------------------------------------------------------------
# wire framing
# ---------------------------------------------------------------------------
class _Abandoned(Exception):
    """recv abandoned: the request completed elsewhere, or the serving
    replica's lease expired mid-wait (the failover signal)."""


class _DeadlinePassed(Exception):
    """recv abandoned: the request's end-to-end deadline passed."""


def _send_frame(sock, header: dict, arrays: Sequence[np.ndarray] = ()):
    metas, blobs = [], []
    for a in arrays:
        a = np.ascontiguousarray(a)
        blob = a.tobytes()
        metas.append({"shape": list(a.shape), "dtype": str(a.dtype),
                      "nbytes": len(blob)})
        blobs.append(blob)
    hdr = dict(header)
    hdr["arrays"] = metas
    hb = json.dumps(hdr).encode("utf-8")
    sock.sendall(b"".join([struct.pack("<I", len(hb)), hb] + blobs))


# a replica's replies are sent under this timeout (or what is left of the
# request's deadline, if more): the receive loop leaves its connection
# with a 0.1 s poll timeout, under which a reply larger than the socket's
# buffers (BERT's decoder output is tens of MB) would fail mid-frame
# whenever the router reads it a little slowly
_REPLY_S = 30.0


def _reply(conn, header: dict, arrays: Sequence[np.ndarray] = (),
           timeout: float = _REPLY_S):
    conn.settimeout(timeout)
    _send_frame(conn, header, arrays)


def _recv_exact(sock, n: int, deadline: Optional[float],
                should_abandon, poll_s: float) -> bytes:
    """Read exactly n bytes; polls ``should_abandon`` between short
    recv timeouts so a waiter can bail out the moment its replica is
    declared dead or another attempt already won the request."""
    buf = bytearray()
    while len(buf) < n:
        if should_abandon is not None and should_abandon():
            raise _Abandoned()
        if deadline is not None and time.time() >= deadline:
            raise _DeadlinePassed()
        sock.settimeout(poll_s)
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            continue
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock, deadline: Optional[float] = None,
                should_abandon=None, poll_s: float = 0.02
                ) -> Tuple[dict, List[np.ndarray]]:
    hlen, = struct.unpack(
        "<I", _recv_exact(sock, 4, deadline, should_abandon, poll_s))
    header = json.loads(
        _recv_exact(sock, hlen, deadline, should_abandon, poll_s))
    arrays = []
    for meta in header.get("arrays", ()):
        raw = _recv_exact(sock, int(meta["nbytes"]), deadline,
                          should_abandon, poll_s)
        arrays.append(np.frombuffer(raw, dtype=meta["dtype"])
                      .reshape(meta["shape"]))
    return header, arrays


# ---------------------------------------------------------------------------
# replica side
# ---------------------------------------------------------------------------
class ReplicaServer:
    """Wire front + lease publisher of one serving replica (module
    docstring). ``inproc=True`` (thread-backed test replicas) turns a
    ``replica_crash`` fire into an abrupt connection drop + stopped
    lease renewal — exactly what a SIGKILL looks like from the router —
    instead of taking the host process down with os._exit."""

    def __init__(self, scheduler, replica_id: str, fleet: str = "fleet",
                 kv: Optional[dist.KV] = None, host: str = "127.0.0.1",
                 port: int = 0, heartbeat_s: Optional[float] = None,
                 miss_k: Optional[int] = None, session=None,
                 inproc: bool = True, slow_s: float = 0.25,
                 drain_s: Optional[float] = None):
        self._sched = scheduler
        self._session = session or getattr(scheduler, "_session", None)
        self.replica_id = replica_id
        self.fleet = fleet
        self._kv = kv
        self._inproc = inproc
        self._slow_s = float(slow_s)
        self._drain_s = drain_s
        self._hb = float(heartbeat_s if heartbeat_s is not None
                         else _cfg("MXNET_SERVE_FLEET_HEARTBEAT_S"))
        k = int(miss_k if miss_k is not None
                else _cfg("MXNET_SERVE_FLEET_MISS_K"))
        self._ttl = self._hb * max(1, k)

        self._stop = threading.Event()
        self._done = threading.Event()
        self._state_lock = threading.Lock()
        self._draining = False
        self.crashed = False
        self._wire_inflight = 0      # infer requests accepted, not yet
        self._conns: List[socket.socket] = []   # answered (drain gate)
        self._lat = collections.deque(maxlen=256)   # served latencies (s)
        self._tok = [time.time(), 0.0]              # tokens/s window
        self._served = 0
        # SIGTERM arrives on the main thread, which may hold any lock:
        # the handler only flips this flag, and the drain-poll thread
        # folds it in
        self._sigterm_flag = [False]
        self._drain_dedup: List[Optional[str]] = [None]

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.addr = self._listener.getsockname()
        self.address = "%s:%d" % self.addr

        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="mx-replica-%s" % replica_id)
        self._accept_thread.start()

        self._lease = None
        self._poll_thread = None
        if kv is not None:
            self._lease = dist.Lease(
                kv, _replica_prefix(fleet) + replica_id, self._ttl,
                self._health, period_s=self._hb).start()
            self._poll_thread = threading.Thread(
                target=self._drain_poll, daemon=True,
                name="mx-replica-poll-%s" % replica_id)
            self._poll_thread.start()

    # -- health snapshot (the lease payload) ---------------------------
    def _health(self) -> dict:
        stats = {}
        try:
            if hasattr(self._sched, "stats"):
                stats = self._sched.stats()
            elif hasattr(self._sched, "queue_depth"):
                stats = {"queue_depth": self._sched.queue_depth()}
        except Exception:
            pass
        lats = sorted(self._lat)
        p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))] if lats \
            else 0.0
        now = time.time()
        dt = now - self._tok[0]
        rate = self._tok[1] / dt if dt > 1e-3 else 0.0
        if dt > 10.0:
            self._tok[0], self._tok[1] = now, 0.0
        payload = {"addr": self.address,
                   "queue_depth": int(stats.get("queue_depth", 0)),
                   "inflight": int(stats.get("inflight", 0)),
                   "p99_ms": p99 * 1e3,
                   "tokens_per_s": rate,
                   "served": self._served,
                   "draining": self._draining,
                   "pid": os.getpid()}
        if self._session is not None:
            try:
                payload["buckets"] = self._session.bucket_table()
            except Exception:
                pass
        if tracing.active():
            # the trace pull path: spans whose reply already shipped
            # drain into the lease payload; the router drops the ones it
            # has by span id
            sp = tracing.publish_drain(64)
            if sp:
                payload["spans"] = sp
        if telemetry.enabled():
            # compact per-replica telemetry snapshot for the router's
            # fleet-aggregated /metrics (replica= labelled series)
            try:
                payload["tele"] = _tele_compact()
            except Exception:
                pass
        return payload

    # -- notice/drain plumbing ----------------------------------------
    def install_sigterm(self):
        """SIGTERM -> graceful drain (process-mode replicas; main
        thread only, idempotent)."""
        import signal
        try:
            flag = self._sigterm_flag

            def _handler(signum, frame):
                flag[0] = True        # lock-free (see field comment)

            signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError) as e:
            _LOG.warning("replica %s: SIGTERM handler not installed "
                         "(%s)", self.replica_id, e)

    def _drain_poll(self):
        key = _drain_key(self.fleet, self.replica_id)
        client = self._kv.client if self._kv is not None else None
        while not self._stop.wait(self._hb):
            notice = None
            if self._sigterm_flag[0]:
                self._sigterm_flag[0] = False
                notice = "sigterm"
            if notice is None:
                try:
                    notice = elastic.consume_kv_notice(
                        key, self._drain_dedup, client=client)
                except Exception:
                    notice = None
            if notice:
                _LOG.info("replica %s: drain notice (%s)",
                          self.replica_id, notice)
                self.drain()
                return

    def drain(self, timeout: Optional[float] = None):
        """Graceful leave. Order matters for zero-drop: first ADVERTISE
        the drain (lease stays alive, payload flips ``draining`` — new
        wire requests get a typed 'drain' shed, retryable elsewhere,
        and routers stop picking us while still trusting our in-flight
        replies), then let the scheduler serve everything already
        queued and flush every accepted wire reply, and only THEN drop
        the lease (the explicit leave signal) and shut the wire down.
        Dropping the lease first would make routers abandon in-flight
        requests as dead — queued work is never shed by a drain unless
        the drain deadline itself expires."""
        with self._state_lock:
            if self._draining:
                return
            self._draining = True
        if self._lease is not None:
            self._lease.renew_now()      # readers see draining=True NOW
        budget = timeout if timeout is not None else self._drain_s
        try:
            self._sched.close(drain=budget)
        except Exception as e:
            _LOG.warning("replica %s: scheduler drain failed (%s: %s)",
                         self.replica_id, type(e).__name__, e)
        flush_deadline = time.time() + (budget if budget else 30.0)
        while time.time() < flush_deadline:
            with self._state_lock:
                if self._wire_inflight == 0:
                    break
            time.sleep(0.01)
        if self._lease is not None:
            self._lease.stop(drop=True)
        self._shutdown()

    def _crash(self):
        """The ``replica_crash`` site: the response is LOST. Process
        mode dies hard (no lease cleanup — routers must detect the
        death via lease expiry / broken connections); in-process mode
        mimics that exactly minus the os._exit."""
        _LOG.warning("replica %s: injected crash (replica_crash)",
                     self.replica_id)
        if not self._inproc:
            os._exit(9)
        self.crashed = True
        if self._lease is not None:
            self._lease.stop(drop=False)     # renewal stops; key EXPIRES
        self._shutdown(abrupt=True)

    def _shutdown(self, abrupt: bool = False):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if abrupt:
            with self._state_lock:
                conns = list(self._conns)
            for c in conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
        self._done.set()

    def close(self):
        """Immediate teardown (tests): lease dropped, no drain grace."""
        if self._lease is not None:
            self._lease.stop(drop=True)
        self._shutdown(abrupt=True)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until drained/crashed (replica_main's main loop)."""
        return self._done.wait(timeout)

    # -- wire serving --------------------------------------------------
    def _accept_loop(self):
        self._listener.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._state_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="mx-replica-conn-%s"
                             % self.replica_id).start()

    def _serve_conn(self, conn):
        try:
            while not self._stop.is_set():
                try:
                    header, arrays = _recv_frame(
                        conn, should_abandon=self._stop.is_set,
                        poll_s=0.1)
                except (_Abandoned, ConnectionError, OSError):
                    return
                op = header.get("op")
                if op == "ping":
                    _reply(conn, {"ok": True,
                                       "replica": self.replica_id})
                elif op == "stats":
                    _reply(conn, {"ok": True,
                                       "stats": self._health()})
                elif op == "infer":
                    if not self._handle_infer(conn, header, arrays):
                        return
                else:
                    _reply(conn, {"ok": False, "error": {
                        "code": "error",
                        "message": "unknown op %r" % (op,)}})
        except OSError:
            pass
        finally:
            with self._state_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_infer(self, conn, header: dict,
                      arrays: List[np.ndarray]) -> bool:
        tenant = header.get("tenant", "default")
        t0 = time.perf_counter()
        t0w = time.time()       # wall stamp: the reply's "tr" pair and
        #                         the replica::handle span start HERE,
        #                         before the slow-site sleep, so a slow
        #                         replica's stall is attributed to the
        #                         replica, not to wire transit
        if faultinject.should_fail("replica_slow"):
            time.sleep(self._slow_s)
        deadline = header.get("deadline") or 0.0
        err = None
        # accept-or-shed under the state lock: a request either holds a
        # wire-inflight slot (drain waits for its reply) or sees the
        # draining flag — never neither
        with self._state_lock:
            if self._draining or self._stop.is_set():
                err = OverloadError("replica %s is draining"
                                    % self.replica_id, code="drain",
                                    tenant=tenant)
            else:
                self._wire_inflight += 1
        if err is None and deadline and time.time() >= deadline:
            err = OverloadError("deadline passed before execution",
                                code="timeout", tenant=tenant)
            with self._state_lock:
                self._wire_inflight -= 1
        if err is not None:
            _reply(conn, {"ok": False,
                               "error": tenancy.to_wire_error(err)})
            return True
        try:
            return self._execute_infer(conn, header, arrays, tenant,
                                       t0, t0w)
        finally:
            with self._state_lock:
                self._wire_inflight -= 1

    def _execute_infer(self, conn, header: dict,
                       arrays: List[np.ndarray], tenant: str,
                       t0: float, t0w: float) -> bool:
        deadline = header.get("deadline") or 0.0
        # rebind the remote trace context (sampled requests only — the
        # edge decided; unsampled frames carry no "trace" key at all)
        # so scheduler/engine/session spans downstream tag themselves
        tctx = tracing.from_wire(header.get("trace")) \
            if tracing.active() else None
        try:
            if tctx is not None:
                with tracing.bind(tctx):
                    fut = self._sched.submit(*arrays, tenant=tenant)
            else:
                fut = self._sched.submit(*arrays, tenant=tenant)
            budget = (deadline - time.time()) if deadline else 60.0
            res = fut.result(timeout=max(0.01, budget))
        except OverloadError as e:
            _reply(conn, {"ok": False,
                               "error": tenancy.to_wire_error(e)})
            return True
        except MXNetError as e:
            if "timed out" in str(e):
                e = OverloadError("deadline passed while queued",
                                  code="timeout", tenant=tenant)
            _reply(conn, {"ok": False,
                               "error": tenancy.to_wire_error(e)})
            return True
        except Exception as e:
            _reply(conn, {"ok": False,
                               "error": tenancy.to_wire_error(e)})
            return True
        # crash site sits AFTER the compute and BEFORE the reply: the
        # worst case for the router — work done, response lost
        if faultinject.should_fail("replica_crash"):
            self._crash()
            return False
        single = not isinstance(res, (list, tuple))
        outs = [np.asarray(o) for o in ([res] if single else res)]
        self._lat.append(time.perf_counter() - t0)
        self._served += 1
        self._tok[1] += float(sum(o.size for o in outs))
        reply = {"ok": True, "single": single,
                 "id": header.get("id", "")}
        if tctx is not None:
            # piggyback this request's replica-side spans + the wall
            # receive/reply pair the router's skew correction needs
            tr_out = time.time()
            tracing.record_span("replica::handle", "replica", t0w,
                                tr_out, ctx=tctx,
                                args={"replica": self.replica_id,
                                      "tenant": tenant})
            reply["spans"] = tracing.take_for(tctx.trace_id)
            reply["tr"] = [t0w, tr_out]
        try:
            _reply(conn, reply, outs,
                   max(_REPLY_S, deadline - time.time()) if deadline
                   else _REPLY_S)
        except OSError:
            return False
        return True


# ---------------------------------------------------------------------------
# replica processes + supervisor
# ---------------------------------------------------------------------------
def demo_factory(spec: dict):
    """The demo replica factory: a small Dense net served through the
    session and the scheduler, on the context :func:`spec_context`
    names. When ``spec['ckpt_prefix']`` names a published checkpoint the
    weights come from :func:`~mxnet_tpu_torch.model.load_latest_checkpoint`
    (the fleet's join path); otherwise from ``spec['seed']``. Returns a
    :class:`~.scheduler.Scheduler`."""
    from .. import initializer
    from .. import nd
    from .. import random as _random
    from ..gluon import nn
    from .scheduler import Scheduler

    ctx = spec_context(spec)
    in_dim = int(spec.get("in_dim", 8))
    hidden = int(spec.get("hidden", 16))
    out_dim = int(spec.get("out_dim", 4))
    _random.seed(int(spec.get("seed", 7)))
    # a fixed prefix: the checkpoint's publisher, another process with
    # its own prefix counters, must produce these parameter names
    net = nn.HybridSequential(prefix="fleetrep_")
    with net.name_scope():
        net.add(nn.Dense(hidden, in_units=in_dim, activation="relu"),
                nn.Dense(out_dim, in_units=hidden))
    net.initialize(init=initializer.Xavier(), ctx=ctx)
    prefix = spec.get("ckpt_prefix")
    if prefix:
        from .. import model
        loaded = model.load_latest_checkpoint(prefix)
        if loaded is None:
            raise MXNetError("replica %s: no valid checkpoint at %r"
                             % (spec.get("replica_id"), prefix))
        arg_params, _, _ = loaded
        for name, p in net.collect_params().items():
            if name not in arg_params:
                # serving a local init instead of the published
                # weights would be a silent wrong-answer fleet
                raise MXNetError(
                    "replica %s: parameter %r missing from checkpoint "
                    "%r (has: %s)" % (spec.get("replica_id"), name,
                                      prefix, sorted(arg_params)))
            p.set_data(arg_params[name])
    session = net.serve_session(
        nd.ones((1, in_dim), ctx=ctx), max_batch=int(spec.get("max_batch", 4)))
    tenants = [TenantConfig(**t) for t in spec.get("tenants", [])]
    return Scheduler(session, tenants=tenants or None)


def _resolve_factory(factory):
    if callable(factory):
        return factory
    if not factory:
        return demo_factory
    mod, _, attr = str(factory).partition(":")
    import importlib
    return getattr(importlib.import_module(mod), attr or "factory")


def spec_context(spec: dict):
    """The context a replica serves on: ``gpu(0)`` unless the spec says
    ``"ctx": "cpu"`` (the reference's replicas default to the CPU)."""
    from ..context import cpu, gpu
    return cpu() if str(spec.get("ctx", "gpu")).lower() == "cpu" else gpu(0)


def replica_main(spec: dict):
    """Entry point of one replica process (the spawn target). ``spec``
    is a plain picklable dict: replica_id, kv_addr, fleet, factory
    ("module:callable"), env overrides, ctx ("cpu", else the card), and
    whatever the factory consumes (ckpt_prefix, tenants, sizes, ...).
    A factory that raises (a kernel that does not build, weights that do
    not load) ends the process before it publishes a lease, so its join
    fails."""
    config.apply_overrides(spec.get("env"))
    telemetry.refresh()
    with spec_context(spec):
        sched = _resolve_factory(spec.get("factory"))(spec)
    kv = dist.fleet_kv(spec.get("kv_addr") or None)
    server = ReplicaServer(
        sched, spec["replica_id"], fleet=spec.get("fleet", "fleet"),
        kv=kv, port=int(spec.get("port", 0)), inproc=False,
        heartbeat_s=spec.get("heartbeat_s"), miss_k=spec.get("miss_k"),
        slow_s=float(spec.get("slow_s", 0.25)))
    server.install_sigterm()
    server.wait()


class ReplicaManager:
    """Supervisor of N replica processes: owns (or joins) the fleet KV
    server, spawns replicas, waits for their leases, and exposes the
    failure controls a chaos test drives — kill (SIGKILL),
    terminate (SIGTERM -> drain), drain (KV notice), respawn."""

    def __init__(self, n: int = 2, factory: Optional[str] = None,
                 fleet: str = "fleet", kv_addr: Optional[str] = None,
                 spec: Optional[dict] = None,
                 heartbeat_s: Optional[float] = None,
                 miss_k: Optional[int] = None):
        self.fleet = fleet
        self._n = int(n)
        self._kv_server = None
        if kv_addr is None:
            self._kv_server = dist.KVServer()
            kv_addr = self._kv_server.address
        self.kv_addr = kv_addr
        self.kv = dist.fleet_kv(kv_addr)
        base = dict(spec or {})
        base.setdefault("factory",
                        factory or "mxnet_tpu_torch.serve.fleet:demo_factory")
        base["fleet"] = fleet
        base["kv_addr"] = kv_addr
        if heartbeat_s is not None:
            base["heartbeat_s"] = float(heartbeat_s)
        if miss_k is not None:
            base["miss_k"] = int(miss_k)
        self._base_spec = base
        self._procs: Dict[str, object] = {}
        self._lock = threading.Lock()

    def spawn(self, rid: str, extra: Optional[dict] = None):
        import multiprocessing
        spec = dict(self._base_spec)
        spec["replica_id"] = rid
        if extra:
            spec.update(extra)
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(target=replica_main, args=(spec,),
                           daemon=True, name="mx-replica-%s" % rid)
        proc.start()
        with self._lock:
            self._procs[rid] = proc
        return proc

    def start(self, timeout: float = 60.0) -> "ReplicaManager":
        for i in range(self._n):
            self.spawn("r%d" % i)
        self.wait_live(timeout=timeout)
        return self

    def wait_live(self, rids: Optional[Sequence[str]] = None,
                  timeout: float = 60.0):
        """Block until every named replica's lease is alive on the KV
        (replicas are only 'started' once routable)."""
        want = set(rids if rids is not None else self._procs)
        deadline = time.time() + timeout
        prefix = _replica_prefix(self.fleet)
        while time.time() < deadline:
            try:
                leases = dist.lease_list(self.kv, prefix)
            except Exception:
                leases = {}
            live = {k[len(prefix):] for k, rec in leases.items()
                    if rec["alive"]}
            if want <= live:
                return
            with self._lock:
                dead = [r for r in want
                        if r in self._procs
                        and not self._procs[r].is_alive()]
            if dead:
                raise MXNetError(
                    "replica(s) %s died before publishing a lease "
                    "(exitcodes: %s)"
                    % (dead, [self._procs[r].exitcode for r in dead]))
            time.sleep(0.05)
        raise MXNetError("replicas %s not live within %.1fs"
                         % (sorted(want - live), timeout))

    def kill(self, rid: str):
        """SIGKILL — no goodbye; routers must detect via lease expiry."""
        self._procs[rid].kill()

    def terminate(self, rid: str):
        """SIGTERM — the replica drains (preemption-warning path)."""
        self._procs[rid].terminate()

    def drain(self, rid: str):
        """Post the KV drain notice (elastic notice semantics)."""
        self.kv.set(_drain_key(self.fleet, rid), "drain@%f" % time.time())

    def alive(self) -> Dict[str, bool]:
        with self._lock:
            return {rid: p.is_alive() for rid, p in self._procs.items()}

    def stop(self, timeout: float = 15.0):
        with self._lock:
            procs = dict(self._procs)
        for rid in procs:
            try:
                self.drain(rid)
            except Exception:
                pass
        deadline = time.time() + timeout
        for rid, p in procs.items():
            p.join(timeout=max(0.1, deadline - time.time()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)
        if self._kv_server is not None:
            self._kv_server.close()


# ---------------------------------------------------------------------------
# router side
# ---------------------------------------------------------------------------
class FleetFuture:
    """First-wins request handle: whichever attempt (primary, hedge,
    failover resubmission) completes first delivers; every later
    completion is discarded and counted — the structural guarantee
    behind 'zero duplicate responses'."""

    __slots__ = ("id", "tenant", "_ev", "_lock", "_value", "_exc",
                 "replica")

    def __init__(self, req_id: str, tenant: str):
        self.id = req_id
        self.tenant = tenant
        self.replica: Optional[str] = None   # who served it (ok only)
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def _set(self, value, exc, replica=None) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._value, self._exc = value, exc
            self.replica = replica
            self._ev.set()
            return True

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise OverloadError(
                "FleetFuture.result timed out after %ss" % timeout,
                code="timeout", tenant=self.tenant)
        if self._exc is not None:
            raise self._exc
        return self._value


class _Breaker:
    """Per-replica circuit breaker: closed -> open after N consecutive
    failures; open -> half-open (ONE probe) after an exponentially
    backed-off wait; half-open -> closed on probe success, -> open
    (doubled wait) on probe failure."""

    __slots__ = ("state", "fails", "opens", "threshold", "base_s",
                 "open_until", "_probing", "_lock")

    def __init__(self, threshold: int, base_s: float):
        self.state = "closed"
        self.fails = 0
        self.opens = 0          # consecutive opens -> backoff exponent
        self.threshold = max(1, int(threshold))
        self.base_s = max(1e-3, float(base_s))
        self.open_until = 0.0
        self._probing = False
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May a request go to this replica now? Claims the single
        half-open probe slot when the open wait has elapsed."""
        now = time.time()
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open" and now >= self.open_until:
                self.state = "half"
                self._probing = True
                return True
            if self.state == "half" and not self._probing:
                self._probing = True
                return True
            return False

    def record(self, ok: bool) -> Optional[str]:
        """Record an attempt outcome; returns the new state on a
        transition (for telemetry) else None."""
        with self._lock:
            self._probing = False
            if ok:
                self.fails = 0
                self.opens = 0
                if self.state != "closed":
                    self.state = "closed"
                    return "closed"
                return None
            self.fails += 1
            if self.state == "half" or self.fails >= self.threshold:
                self.fails = 0
                self.opens += 1
                backoff = self.base_s * (2 ** min(self.opens - 1, 6))
                self.open_until = time.time() + backoff
                was = self.state
                self.state = "open"
                return "open" if was != "open" else None
            return None


class _Replica:
    __slots__ = ("rid", "addr", "payload", "alive", "gone", "breaker",
                 "inflight", "pool", "pool_lock", "p99_ms", "skew_s")

    def __init__(self, rid: str, breaker: _Breaker):
        self.rid = rid
        self.addr: Optional[Tuple[str, int]] = None
        self.payload: dict = {}
        self.alive = False           # routable: lease alive, not draining
        self.gone = False            # lease expired/removed: abandon
        self.breaker = breaker       # in-flight waits (zero-drop resubmit)
        self.inflight = 0            # router-local in-flight attempts
        self.pool: List[socket.socket] = []
        self.pool_lock = threading.Lock()
        self.p99_ms = 0.0            # replica-reported (lease payload)
        self.skew_s = 0.0            # last measured clock offset (trace)


class _RouteReq:
    __slots__ = ("id", "tenant", "arrays", "deadline", "idempotent",
                 "hedge_s", "hedged", "future", "ctx")

    def __init__(self, req_id, tenant, arrays, deadline, idempotent,
                 hedge_s):
        self.id = req_id
        self.tenant = tenant
        self.arrays = arrays
        self.deadline = deadline
        self.idempotent = idempotent
        self.hedge_s = hedge_s
        self.hedged = False
        self.future = FleetFuture(req_id, tenant)
        self.ctx = None              # SAMPLED TraceContext, or None


class Router:
    """Health-gated, breaker-guarded, hedging request router over the
    live replicas (module docstring). ``submit`` returns a
    :class:`FleetFuture` driven by a bounded thread pool; ``infer``
    drives the attempts on the caller's thread."""

    def __init__(self, kv=None, fleet: str = "fleet",
                 tenants: Optional[Sequence[TenantConfig]] = None,
                 heartbeat_s: Optional[float] = None,
                 miss_k: Optional[int] = None,
                 retries: Optional[int] = None,
                 hedge_ms: Optional[float] = None,
                 conc: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 breaker_fails: Optional[int] = None,
                 breaker_ms: Optional[float] = None):
        if kv is None:
            kv = dist.fleet_kv()
        elif not isinstance(kv, dist.KV):
            kv = dist.KV(kv)
        self._kv = kv
        self.fleet = fleet
        self._prefix = _replica_prefix(fleet)
        self._tenants = {t.name: t for t in (tenants or [])}
        self._hb = float(heartbeat_s if heartbeat_s is not None
                         else _cfg("MXNET_SERVE_FLEET_HEARTBEAT_S"))
        self._miss_k = int(miss_k if miss_k is not None
                           else _cfg("MXNET_SERVE_FLEET_MISS_K"))
        self._retries = int(retries if retries is not None
                            else _cfg("MXNET_SERVE_FLEET_RETRIES"))
        self._hedge_ms = float(hedge_ms if hedge_ms is not None
                               else _cfg("MXNET_SERVE_HEDGE_MS"))
        self._timeout_s = float(timeout_s if timeout_s is not None
                                else _cfg("MXNET_SERVE_FLEET_TIMEOUT_S"))
        self._bk_fails = int(breaker_fails if breaker_fails is not None
                             else _cfg("MXNET_SERVE_FLEET_BREAKER_FAILS"))
        self._bk_base_s = float(
            breaker_ms if breaker_ms is not None
            else _cfg("MXNET_SERVE_FLEET_BREAKER_MS")) / 1e3
        n_conc = int(conc if conc is not None
                     else _cfg("MXNET_SERVE_FLEET_CONC"))
        self._lock = threading.Lock()
        self._reps: Dict[str, _Replica] = {}
        self._stale = False
        self._rr = 0
        self._lat = collections.deque(maxlen=512)   # fleet-wide (s)
        self._traces = tracing.TraceStore()         # trace assembly
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, n_conc), thread_name_prefix="mx-router")
        self._watcher = dist.KVWatcher(
            self._kv, self._prefix, self._hb, self._on_leases,
            self._on_kv_error).start()
        global _LAST_ROUTER
        _LAST_ROUTER = weakref.ref(self)

    # -- routing table maintenance ------------------------------------
    def refresh(self):
        """Synchronous table poll (deterministic tests)."""
        self._watcher.poll_once()

    def _on_leases(self, leases: Dict[str, dict]):
        drop_pools = []
        pulled = []          # (rid, spans, skew) — ingest outside lock
        with self._lock:
            seen = set()
            for key, rec in leases.items():
                rid = key[len(self._prefix):]
                seen.add(rid)
                rep = self._reps.get(rid)
                if rep is None:
                    rep = self._reps[rid] = _Replica(
                        rid, _Breaker(self._bk_fails, self._bk_base_s))
                    _LOG.info("router: replica %s joined (%s)", rid,
                              rec["payload"].get("addr"))
                rep.payload = rec["payload"]
                sp = rec["payload"].get("spans")
                if sp:
                    # trace pull path: spans the reply piggyback missed
                    # arrive via the lease; corrected with the last
                    # wire-measured skew, deduped by span id
                    pulled.append((rid, sp, rep.skew_s))
                rep.p99_ms = float(rec["payload"].get("p99_ms", 0.0))
                addr = rec["payload"].get("addr", "")
                host, _, port = addr.rpartition(":")
                if port:
                    rep.addr = (host or "127.0.0.1", int(port))
                was = rep.alive
                # draining is NOT gone: the replica still answers the
                # requests it accepted — route nothing new, but let
                # in-flight attempts wait for their replies
                rep.gone = not rec["alive"]
                rep.alive = rec["alive"] \
                    and not rec["payload"].get("draining")
                if was and not rep.alive:
                    self._eject(rep, "lease_expired" if rep.gone
                                else "draining", drop_pools)
                elif not was and rep.alive:
                    _LOG.info("router: replica %s live", rid)
            for rid, rep in self._reps.items():
                if rid not in seen:
                    rep.gone = True
                    if rep.alive:
                        rep.alive = False
                        self._eject(rep, "lease_removed", drop_pools)
            if self._stale:
                self._stale = False
                telemetry.gauge("mx_fleet_routing_stale").set(0)
                _LOG.info("router: fleet KV recovered — routing table "
                          "fresh again")
            live = sum(1 for r in self._reps.values() if r.alive)
            telemetry.gauge("mx_fleet_replicas_live").set(live)
            for rid, rep in self._reps.items():
                telemetry.gauge("mx_fleet_replica_liveness",
                                replica=rid).set(1 if rep.alive else 0)
        for rep in drop_pools:
            self._drop_pool(rep)
        for rid, sp, skew in pulled:
            try:
                self._traces.ingest(list(sp), replica=rid, skew_s=skew)
            except Exception:
                pass

    def _eject(self, rep: _Replica, reason: str, drop_pools: list):
        _LOG.warning("router: replica %s ejected (%s)", rep.rid, reason)
        telemetry.counter("mx_fleet_ejections_total", replica=rep.rid,
                          reason=reason).inc()
        drop_pools.append(rep)

    def _on_kv_error(self, exc: Exception):
        telemetry.counter("mx_fleet_kv_errors_total").inc()
        with self._lock:
            if not self._stale:
                self._stale = True
                telemetry.gauge("mx_fleet_routing_stale").set(1)
                _LOG.warning(
                    "router: fleet KV unreachable (%s: %s) — degrading "
                    "to last-known-good routing table",
                    type(exc).__name__, exc)

    # -- replica selection --------------------------------------------
    def _score(self, rep: _Replica) -> float:
        return (float(rep.payload.get("queue_depth", 0))
                + float(rep.payload.get("inflight", 0))
                + 2.0 * rep.inflight)

    def _pick(self, exclude: Set[str]) -> Optional[_Replica]:
        with self._lock:
            cands = [r for r in self._reps.values()
                     if r.alive and r.addr is not None
                     and r.rid not in exclude]
            if not cands:
                return None
            order = sorted(
                cands,
                key=lambda r: (0 if r.breaker.state == "closed" else 1,
                               self._score(r), r.rid))
            best = [r for r in order
                    if r.breaker.state == order[0].breaker.state
                    and self._score(r) == self._score(order[0])]
            if len(best) > 1:     # spread equal-load ties round-robin
                self._rr += 1
                order = best[self._rr % len(best):] + order
        for rep in order:
            if rep.breaker.allow():
                return rep
        return None

    def table(self) -> dict:
        """Routing-table snapshot (the frontend's /v1/fleet)."""
        with self._lock:
            reps = {rid: {"alive": rep.alive,
                          "addr": "%s:%d" % rep.addr if rep.addr else "",
                          "breaker": rep.breaker.state,
                          "inflight": rep.inflight,
                          "payload": dict(rep.payload)}
                    for rid, rep in self._reps.items()}
            return {"replicas": reps, "stale": self._stale}

    # -- distributed-trace queries ------------------------------------
    def trace(self, ident: str) -> Optional[dict]:
        """Assembled trace for a request id or trace id (GET
        /v1/trace/<id>), or None when unknown/evicted."""
        return self._traces.get(ident)

    def explain(self, ident: str) -> Optional[dict]:
        """Critical-path breakdown of one request: which phase (queue /
        batch / execute / wire / hedge_wait / retry) ate the latency."""
        return self._traces.explain(ident)

    def trace_store(self) -> tracing.TraceStore:
        return self._traces

    def replica_payloads(self) -> List[Tuple[str, dict]]:
        """Last-known lease payload per replica (stale entries
        included — the kv-flap degradation keeps serving the cached
        view with mx_fleet_routing_stale=1)."""
        with self._lock:
            return [(rid, dict(rep.payload))
                    for rid, rep in sorted(self._reps.items())]

    # -- request driving ----------------------------------------------
    def _deadline_of(self, tenant: str,
                     deadline_ms: Optional[float]) -> float:
        if deadline_ms is None:
            t = self._tenants.get(tenant)
            if t is not None and t.deadline_ms > 0:
                deadline_ms = t.deadline_ms
        if deadline_ms is None or deadline_ms <= 0:
            return time.time() + self._timeout_s
        return time.time() + float(deadline_ms) / 1e3

    def _make_req(self, arrays, tenant, deadline_ms, idempotent,
                  hedge_ms, trace=None) -> _RouteReq:
        hedge = self._hedge_ms if hedge_ms is None else float(hedge_ms)
        if hedge < 0:                       # auto: fleet p99
            lats = sorted(self._lat)
            hedge_s = (lats[int(0.99 * len(lats))]
                       if len(lats) >= 16 else None)
        elif hedge == 0:
            hedge_s = None
        else:
            hedge_s = hedge / 1e3
        req = _RouteReq(uuid.uuid4().hex[:16], tenant,
                        [np.ascontiguousarray(a) for a in arrays],
                        self._deadline_of(tenant, deadline_ms),
                        bool(idempotent), hedge_s)
        if tracing.active():
            # accept the edge's context (frontend header / caller) or
            # mint here — either way the sampling decision is made
            # exactly once; only SAMPLED contexts ride on the request
            ctx = trace if trace is not None else tracing.current()
            if ctx is None:
                ctx = tracing.mint(deadline=req.deadline)
            if ctx is not None and ctx.sampled:
                req.ctx = ctx
        return req

    def submit(self, *arrays, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               idempotent: bool = True,
               hedge_ms: Optional[float] = None,
               trace=None) -> FleetFuture:
        """Route one request; returns a :class:`FleetFuture`. Only
        ``idempotent=True`` requests may be retried/hedged after they
        may have EXECUTED (transport failure, dead replica) — typed
        overload/drain sheds were never executed and retry regardless
        (the idempotency contract). ``trace`` carries a
        :class:`~mxnet_tpu_torch.tracing.TraceContext` minted at the
        edge (the frontend's x-mxnet-trace header); None mints one when
        tracing is on."""
        req = self._make_req(arrays, tenant, deadline_ms, idempotent,
                             hedge_ms, trace)
        self._exec.submit(self._drive, req)
        return req.future

    def infer(self, *arrays, tenant: str = "default",
              deadline_ms: Optional[float] = None,
              idempotent: bool = True,
              hedge_ms: Optional[float] = None, trace=None):
        """A synchronous routed request, driven on the caller's thread
        (no hand-off to the pool). Returns the outputs; raises the typed
        error on failure."""
        req = self._make_req(arrays, tenant, deadline_ms, idempotent,
                             hedge_ms, trace)
        self._drive(req)
        return req.future.result(timeout=0)

    def _fail(self, req: _RouteReq, exc: BaseException):
        if isinstance(exc, OverloadError):
            telemetry.counter("mx_fleet_shed_total",
                              code=exc.code).inc()
        req.future._set(None, exc)

    def _drive(self, req: _RouteReq):
        t0w = time.time() if req.ctx is not None else 0.0
        try:
            self._drive_inner(req)
        except BaseException as e:       # never lose a future
            req.future._set(None, e)
        if req.ctx is not None:
            self._finish_trace(req, t0w)

    def _finish_trace(self, req: _RouteReq, t0w: float):
        """Close out a sampled request: record the root span and mark
        the assembled trace complete (exemplar retention keys off the
        root's duration). Never raises."""
        try:
            fut = req.future
            exc = fut._exc
            outcome = "ok" if exc is None else \
                (getattr(exc, "code", None) or type(exc).__name__)
            ctx = req.ctx
            root = {"name": "fleet::request", "cat": "fleet",
                    "ts": t0w * 1e6,
                    "dur": (time.time() - t0w) * 1e6,
                    "tid": ctx.trace_id, "sid": ctx.span_id,
                    "psid": None,
                    "args": {"id": req.id, "tenant": req.tenant,
                             "replica": fut.replica,
                             "outcome": outcome,
                             "hedged": req.hedged}}
            self._traces.add(root)
            self._traces.finish(ctx.trace_id, req.id, root)
        except Exception:
            pass

    def _drive_inner(self, req: _RouteReq):
        fut = req.future
        tried: Set[str] = set()
        retries_left = self._retries
        last_exc: Optional[BaseException] = None
        while not fut.done():
            if time.time() >= req.deadline:
                if not (isinstance(last_exc, OverloadError)
                        and last_exc.code == "timeout"):
                    last_exc = OverloadError(
                        "deadline exceeded after %d attempt(s)"
                        % len(tried), code="timeout", tenant=req.tenant)
                self._fail(req, last_exc)
                return
            rep = self._pick(tried)
            if rep is None:
                self._fail(req, last_exc or OverloadError(
                    "no live replica admits tenant %r (fleet %s)"
                    % (req.tenant, self.fleet), code="overload",
                    tenant=req.tenant))
                return
            status, exc = self._attempt_maybe_hedged(rep, req, tried)
            if status in ("ok", "superseded"):
                return
            last_exc = exc
            executed_maybe = status in ("conn", "dead", "error")
            retryable = ((executed_maybe and req.idempotent)
                         or status in ("shed:overload", "shed:drain"))
            if not retryable or retries_left <= 0:
                self._fail(req, exc)
                return
            retries_left -= 1
            tried.add(rep.rid)
            reason = status.split(":", 1)[-1]
            telemetry.counter("mx_fleet_retries_total",
                              reason=reason).inc()
            if status in ("conn", "dead"):
                # the replica went away with our request in flight —
                # the zero-drop failover resubmission
                telemetry.counter("mx_fleet_failovers_total").inc()

    def _spawn_attempt(self, rep: _Replica, req: _RouteReq, kind: str):
        # a dedicated thread, NOT self._exec: a saturated driver pool
        # waiting on pooled attempt tasks would deadlock on itself
        f: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                f.set_result(self._attempt(rep, req, kind))
            except BaseException as e:
                f.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="mx-router-attempt").start()
        return f

    def _attempt_maybe_hedged(self, rep: _Replica, req: _RouteReq,
                              tried: Set[str]):
        if req.hedge_s is None or not req.idempotent:
            return self._attempt(rep, req, "solo")
        f1 = self._spawn_attempt(rep, req, "primary")
        try:
            return f1.result(timeout=req.hedge_s)
        except concurrent.futures.TimeoutError:
            pass
        rep2 = self._pick(tried | {rep.rid})
        if rep2 is None:
            return f1.result()
        req.hedged = True
        telemetry.counter("mx_fleet_hedges_total",
                          result="launched").inc()
        if req.ctx is not None:
            # hedge-wait span: the time the primary was given before
            # the duplicate launched (a critical-path phase of its own)
            now_w = time.time()
            self._traces.add(
                {"name": "hedge::wait", "cat": "hedge",
                 "ts": (now_w - req.hedge_s) * 1e6,
                 "dur": req.hedge_s * 1e6, "tid": req.ctx.trace_id,
                 "sid": uuid.uuid4().hex[:8], "psid": req.ctx.span_id,
                 "args": {"primary": rep.rid, "hedge": rep2.rid}})
        f2 = self._spawn_attempt(rep2, req, "hedge")
        while True:
            done, _ = concurrent.futures.wait(
                {f1, f2}, timeout=0.05,
                return_when=concurrent.futures.FIRST_COMPLETED)
            if req.future.done():
                return ("ok", None)
            if f1.done() and f2.done():
                st1, st2 = f1.result(), f2.result()
                return st1 if st1[0] != "superseded" else st2

    def _checkout(self, rep: _Replica) -> socket.socket:
        with rep.pool_lock:
            if rep.pool:
                return rep.pool.pop()
        sock = socket.create_connection(rep.addr, timeout=1.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkin(self, rep: _Replica, sock: socket.socket):
        with rep.pool_lock:
            if rep.alive and len(rep.pool) < 8:
                rep.pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def _drop_pool(self, rep: _Replica):
        with rep.pool_lock:
            conns, rep.pool = rep.pool, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _attempt(self, rep: _Replica, req: _RouteReq, kind: str):
        """One wire attempt against one replica (``_attempt_wire``),
        wrapped so every attempt of a SAMPLED request — primary, solo,
        hedge, failover resubmission — becomes a child span carrying
        its replica id, kind, outcome (the shed code / error included).
        Untraced requests skip straight through."""
        tctx = req.ctx
        if tctx is None:
            return self._attempt_wire(rep, req, kind, None)
        actx = tctx.child()     # replica spans parent onto THIS id
        t0w = time.time()
        status, exc = "error", None
        try:
            status, exc = self._attempt_wire(rep, req, kind, actx)
            return (status, exc)
        except BaseException as e:
            exc = e
            raise
        finally:
            try:
                self._traces.add(
                    {"name": "attempt::%s" % kind, "cat": "attempt",
                     "ts": t0w * 1e6,
                     "dur": (time.time() - t0w) * 1e6,
                     "tid": tctx.trace_id, "sid": actx.span_id,
                     "psid": tctx.span_id,
                     "args": {"replica": rep.rid, "kind": kind,
                              "outcome": status,
                              "error": str(exc) if exc is not None
                              else None}})
            except Exception:
                pass

    def _attempt_wire(self, rep: _Replica, req: _RouteReq, kind: str,
                      actx):
        """One wire attempt against one replica. Returns (status, exc):
        'ok' (this attempt set the future), 'superseded' (another
        attempt won, or the replica died and the request was abandoned
        AFTER someone else completed it), 'dead' (lease expired
        mid-wait — failover), 'conn' (transport failure), 'error'
        (remote exception), 'shed:<code>' (typed shed). ``actx`` is the
        attempt's trace context or None — the trace fields are added to
        the wire header ONLY then, so untraced frames stay
        byte-identical to the untraced format."""
        fut = req.future
        t0 = time.perf_counter()
        t_send_w = 0.0
        with self._lock:
            rep.inflight += 1
        sock = None
        try:
            try:
                sock = self._checkout(rep)
                hdr = {"op": "infer", "id": req.id,
                       "tenant": req.tenant,
                       "deadline": req.deadline}
                if actx is not None:
                    hdr["trace"] = actx.to_wire()
                    t_send_w = time.time()
                _send_frame(sock, hdr, req.arrays)
                header, outs = _recv_frame(
                    sock, deadline=req.deadline,
                    should_abandon=lambda: fut.done() or rep.gone)
            except _Abandoned:
                self._close(sock)
                sock = None
                if fut.done():
                    self._note_discard(kind)
                    return ("superseded", None)
                self._record(rep, "dead", ok=False)
                return ("dead", ConnectionError(
                    "replica %s declared dead (lease expiry) with "
                    "request %s in flight" % (rep.rid, req.id)))
            except _DeadlinePassed:
                self._close(sock)
                sock = None
                return ("shed:timeout", OverloadError(
                    "deadline passed waiting on replica %s" % rep.rid,
                    code="timeout", tenant=req.tenant))
            except (ConnectionError, OSError) as e:
                self._close(sock)
                sock = None
                self._record(rep, "conn", ok=False)
                return ("conn", ConnectionError(
                    "replica %s connection failed: %s: %s"
                    % (rep.rid, type(e).__name__, e)))
            if not header.get("ok"):
                self._checkin(rep, sock)
                sock = None
                err = tenancy.from_wire_error(header.get("error", {}))
                if isinstance(err, OverloadError):
                    # typed shed: the replica is HEALTHY and said no —
                    # not a breaker failure
                    self._record(rep, err.code, ok=None)
                    return ("shed:" + err.code, err)
                self._record(rep, "error", ok=False)
                return ("error", err)
            self._checkin(rep, sock)
            sock = None
            if actx is not None:
                self._ingest_reply(actx, rep, header, t_send_w)
            result = outs[0] if header.get("single") else list(outs)
            if fut._set(result, None, replica=rep.rid):
                dt = time.perf_counter() - t0
                self._lat.append(dt)
                self._record(rep, "ok", ok=True, latency_s=dt)
                if kind == "hedge":
                    telemetry.counter("mx_fleet_hedges_total",
                                      result="won").inc()
                elif kind == "primary" and req.hedged:
                    telemetry.counter("mx_fleet_hedges_total",
                                      result="lost").inc()
                return ("ok", None)
            self._note_discard(kind)
            return ("superseded", None)
        finally:
            with self._lock:
                rep.inflight -= 1
            if sock is not None:
                self._close(sock)

    def _ingest_reply(self, actx, rep: _Replica, header: dict,
                      t_send_w: float):
        """Fold a traced reply's piggybacked spans into the store:
        clock skew estimated from this very round-trip (NTP offset —
        the replica reported its wall receive/reply pair in "tr"), a
        wire-transit span derived as RTT minus server time, and the
        replica's spans shifted onto the router's clock. Never
        raises."""
        try:
            t_recv_w = time.time()
            tr = header.get("tr")
            skew = 0.0
            if tr and len(tr) == 2:
                tr_in, tr_out = float(tr[0]), float(tr[1])
                skew = tracing.clock_skew(t_send_w, t_recv_w,
                                          tr_in, tr_out)
                rep.skew_s = skew        # pull-path correction cache
                wire_s = max(0.0, (t_recv_w - t_send_w)
                             - (tr_out - tr_in))
                self._traces.add(
                    {"name": "wire::transit", "cat": "wire",
                     "ts": t_send_w * 1e6, "dur": wire_s * 1e6,
                     "tid": actx.trace_id,
                     "sid": uuid.uuid4().hex[:8],
                     "psid": actx.span_id,
                     "args": {"replica": rep.rid,
                              "skew_us": skew * 1e6}})
            spans = header.get("spans")
            if spans:
                self._traces.ingest(list(spans), replica=rep.rid,
                                    skew_s=skew)
        except Exception:
            pass

    def _note_discard(self, kind: str):
        """A completion arrived for an already-completed request: the
        client saw exactly one response; this counter is where the
        other one went."""
        if kind in ("primary", "hedge"):
            telemetry.counter("mx_fleet_hedge_cancelled_total").inc()
        else:
            telemetry.counter("mx_fleet_discarded_results_total",
                              context="failover").inc()

    def _record(self, rep: _Replica, code: str, ok: Optional[bool],
                latency_s: float = 0.0):
        telemetry.counter("mx_fleet_requests_total", replica=rep.rid,
                          code=code).inc()
        if latency_s:
            telemetry.histogram("mx_fleet_latency_seconds",
                                replica=rep.rid).observe(latency_s)
        if ok is not None:
            transition = rep.breaker.record(ok)
            if transition is not None:
                telemetry.counter("mx_fleet_breaker_transitions_total",
                                  replica=rep.rid, to=transition).inc()
                _LOG.warning("router: replica %s breaker -> %s",
                             rep.rid, transition)

    @staticmethod
    def _close(sock):
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        self._watcher.stop()
        self._exec.shutdown(wait=False)
        with self._lock:
            reps = list(self._reps.values())
        for rep in reps:
            self._drop_pool(rep)


# ---------------------------------------------------------------------------
# the fleet table
# ---------------------------------------------------------------------------
def fleet_table() -> list:
    """Per-replica rows from the live mx_fleet_* registry: outcomes by
    code, router-observed p50/p99. Sorted slowest-first by p99, so row
    0 NAMES the slowest replica."""
    snap = telemetry.snapshot()
    rows: Dict[str, dict] = {}

    def row(rid: str) -> dict:
        r = rows.get(rid)
        if r is None:
            r = rows[rid] = {"replica": rid, "requests": 0,
                             "by_code": {}, "p50_ms": 0.0,
                             "p99_ms": 0.0}
        return r

    for key, val in snap["counters"].items():
        name, labels = telemetry.parse_metric_key(key)
        rid = labels.get("replica")
        if rid is None or name != "mx_fleet_requests_total":
            continue
        r = row(rid)
        code = labels.get("code", "error")
        r["requests"] += int(val)
        r["by_code"][code] = r["by_code"].get(code, 0) + int(val)
    for key, summ in snap["histograms"].items():
        name, labels = telemetry.parse_metric_key(key)
        rid = labels.get("replica")
        if rid is not None and name == "mx_fleet_latency_seconds":
            row(rid)["p50_ms"] = summ["p50"] * 1e3
            row(rid)["p99_ms"] = summ["p99"] * 1e3
    return sorted(rows.values(), key=lambda r: -r["p99_ms"])


def explain(request_id: str) -> Optional[dict]:
    """The critical-path breakdown of one request, through the most
    recent Router of this process. None when no router is live or the
    id is unknown."""
    ref = _LAST_ROUTER
    router = ref() if ref is not None else None
    if router is None:
        return None
    return router.explain(request_id)


def render_replica_metrics(router: "Router") -> str:
    """Prometheus exposition of every replica's compact telemetry
    snapshot (the "tele" field replicas publish in their health lease),
    each series re-labelled with ``replica=``. Merged under the
    router-local registry by the frontend's /metrics — during a KV flap
    the cached payloads keep rendering (with mx_fleet_routing_stale=1
    from the router registry). Histogram summaries surface as
    ``_count``/``_sum``/``_p99`` samples."""
    lines = []
    for rid, payload in router.replica_payloads():
        tele = payload.get("tele")
        if not isinstance(tele, dict):
            continue
        for kind in ("counters", "gauges"):
            for key in sorted(tele.get(kind) or {}):
                try:
                    name, labels = telemetry.parse_metric_key(key)
                    labels["replica"] = rid
                    lines.append("%s %.17g" % (
                        telemetry._fmt(name, tuple(sorted(
                            labels.items()))),
                        float(tele[kind][key])))
                except Exception:
                    continue
        for key in sorted(tele.get("summaries") or {}):
            try:
                summ = tele["summaries"][key]
                name, labels = telemetry.parse_metric_key(key)
                labels["replica"] = rid
                lt = tuple(sorted(labels.items()))
                for suffix, v in (("_count", summ.get("count", 0)),
                                  ("_sum", summ.get("sum", 0.0)),
                                  ("_p99", summ.get("p99", 0.0))):
                    lines.append("%s %.17g" % (
                        telemetry._fmt(name + suffix, lt), float(v)))
            except Exception:
                continue
    return "\n".join(lines) + ("\n" if lines else "")


def render_fleet_table(rows: Optional[list] = None) -> str:
    rows = fleet_table() if rows is None else rows
    out = ["%-10s %8s %6s %6s %6s %6s %8s %8s"
           % ("replica", "requests", "ok", "shed", "dead", "conn",
              "p50_ms", "p99_ms")]
    for r in rows:
        shed = sum(r["by_code"].get(c, 0)
                   for c in ("overload", "timeout", "drain"))
        out.append("%-10s %8d %6d %6d %6d %6d %8.2f %8.2f"
                   % (r["replica"], r["requests"],
                      r["by_code"].get("ok", 0), shed,
                      r["by_code"].get("dead", 0),
                      r["by_code"].get("conn", 0),
                      r["p50_ms"], r["p99_ms"]))
    return "\n".join(out)
