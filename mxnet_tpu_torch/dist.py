"""The process group and the fleet's coordination (counterpart of
``mxnet_tpu/dist.py``; ref: 3rdparty/ps-lite's ``DMLC_*`` rendezvous and
tools/launch.py's role assignment).

The process group. Every process is a worker; the reference's
environment contract is kept, so launch scripts port unchanged::

    DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT   the rendezvous address
    DMLC_NUM_WORKER                        the number of processes
    DMLC_WORKER_ID                         this process's rank
    DMLC_ROLE                              must be 'worker'
    MXNET_DIST_CPU_DEVICES=N               N CPU contexts a process

:func:`initialize` (called by ``kvstore.create("dist_*")``) meets the
other ranks on a ``torch.distributed.TCPStore`` that rank 0 serves at
the rendezvous address, retrying with exponential backoff under
``MXNET_DIST_INIT_TIMEOUT`` (``MXNET_DIST_INIT_BACKOFF``,
``MXNET_DIST_INIT_RETRIES``; the ``rendezvous`` fault site), and then
opens the ``torch.distributed`` group on that store. The store is also
the group's small key-value service: :func:`allgather_floats` (the fleet
view's transport) and :func:`fleet_kv`'s third source ride it.
:func:`barrier` runs under the ``MXNET_BARRIER_TIMEOUT`` watchdog (the
``barrier`` fault site).

The backend is decided once, after the store meets and before the group
opens. Every rank publishes its host name, its CUDA device count and
whether its contexts are CPU ones (``MXNET_DIST_CPU_DEVICES``, or no
CUDA). A rank's card is its index among its host's ranks modulo the
host's device count. The group is NCCL when every rank's contexts are
CUDA ones and no host has more ranks than cards; otherwise it is gloo
(CPU contexts, or ranks sharing a card, which NCCL refuses). This is
the port's counterpart of XLA picking the transport from the mesh;
:func:`backend` reads the choice. An NCCL failure raises: nothing retries
on gloo.

The fleet's coordination: a small key-value store over TCP and TTL'd
liveness leases on it (the fleet half of the reference module).

- :class:`LocalKV` (in-process), :class:`KVServer` (a stdlib TCP front
  on one, newline-delimited JSON) and :class:`TcpKV` (its client) share
  the coordination service's client interface, as does the process
  group's store (:class:`StoreKV`); :class:`KV` wraps any of them with
  the ``kv_flap`` fault site, and :func:`fleet_kv` picks one.
- :func:`lease_publish`, :func:`lease_read`, :func:`lease_list`,
  :class:`Lease` (background renewal) and :class:`KVWatcher` (a polled
  lease directory): the replicas' liveness and the routers' view.
- :func:`retry_delay` and :func:`call_with_deadline`: the backoff and
  the watchdog the rendezvous and the kvstore use.
"""
from __future__ import annotations

import threading
from typing import Optional

from .base import MXNetError

__all__ = ["LocalKV", "KVServer", "TcpKV", "StoreKV", "KV", "fleet_kv",
           "lease_publish", "lease_read", "lease_list", "Lease",
           "KVWatcher", "retry_delay", "call_with_deadline", "rank",
           "num_workers", "is_initialized", "initialize",
           "allgather_floats", "barrier", "backend", "local_contexts"]


class _Group:
    """This process's membership of the process group."""

    def __init__(self):
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.backend = None
        self.store = None
        self.card = 0
        self.cpu_devices = 0
        self.wedged = False     # a collective timed out: no clean teardown


_PG = _Group()


def _env(name: str, *alts: str, default: Optional[str] = None) -> Optional[str]:
    from .config import getenv_raw
    for n in (name,) + alts:
        v = getenv_raw(n)
        if v is not None:
            return v
    return default


def is_initialized() -> bool:
    return _PG.initialized


def rank() -> int:
    return _PG.rank if _PG.initialized else 0


def num_workers() -> int:
    return _PG.size if _PG.initialized else 1


def backend() -> Optional[str]:
    """The group's ``torch.distributed`` backend (``"nccl"`` or
    ``"gloo"``), None before :func:`initialize`."""
    return _PG.backend if _PG.initialized else None


def local_contexts():
    """This process's contexts in the group: ``MXNET_DIST_CPU_DEVICES``
    CPU ones, else its card (the counterpart of ``jax.local_devices()``
    in the reference's workers)."""
    from .context import cpu, gpu
    ndev = int(_env("MXNET_DIST_CPU_DEVICES", default="0") or 0)
    if ndev:
        return [cpu(i) for i in range(ndev)]
    return [gpu(_PG.card)]


def _store_timeout(seconds: float):
    import datetime
    return datetime.timedelta(seconds=max(1.0, float(seconds)))


def _tcp_store(host: str, port: int, size: int, rank_: int,
               seconds: float):
    """One rendezvous attempt: rank 0 serves the store, the others
    connect to it (bounded by ``seconds``)."""
    import torch.distributed as tdist
    return tdist.TCPStore(host, int(port), size, rank_ == 0,
                          timeout=_store_timeout(seconds),
                          wait_for_workers=False)


def _decide_backend(store, rank_: int, size: int):
    """The backend rule (module docstring): returns (backend, card)."""
    import socket
    import torch
    cpu_mode = bool(int(_env("MXNET_DIST_CPU_DEVICES", default="0") or 0))
    ncuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    store.set("mx/rdv/%d" % rank_, "%s|%d|%d" % (
        socket.gethostname(), ncuda, 1 if cpu_mode or not ncuda else 0))
    infos = []
    for r in range(size):
        host, n, cpu = store.get("mx/rdv/%d" % r).decode().rsplit("|", 2)
        infos.append((host, int(n), cpu == "1"))
    me = infos[rank_][0]
    local_index = sum(1 for r in range(rank_) if infos[r][0] == me)
    card = local_index % ncuda if ncuda else 0
    per_host = {}
    for host, n, _ in infos:
        per_host.setdefault(host, [0, n])[0] += 1
    nccl = all(not cpu for _, _, cpu in infos) and \
        all(count <= n for count, n in per_host.values())
    return ("nccl" if nccl else "gloo"), card


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout: Optional[float] = None) -> None:
    """Join the process group (idempotent). The arguments default to the
    ``DMLC_*`` contract; a failed rendezvous retries with exponential
    backoff until ``timeout`` (default ``MXNET_DIST_INIT_TIMEOUT``) and
    then raises MXNetError."""
    if _PG.initialized:
        return
    role = _env("DMLC_ROLE", default="worker")
    if role != "worker":
        raise RuntimeError(
            "DMLC_ROLE=%r: there are no server or scheduler processes; "
            "launch every process as a worker (mxnet_tpu_torch.tools."
            "launch does this)" % role)
    if coordinator_address is None:
        uri = _env("DMLC_PS_ROOT_URI", "MXNET_COORDINATOR_URI")
        port = _env("DMLC_PS_ROOT_PORT", "MXNET_COORDINATOR_PORT",
                    default="9091")
        if uri is None:
            raise RuntimeError(
                "multi-process init needs DMLC_PS_ROOT_URI/"
                "DMLC_PS_ROOT_PORT (or pass coordinator_address)")
        coordinator_address = "%s:%s" % (uri, port)
    if num_processes is None:
        num_processes = int(_env("DMLC_NUM_WORKER", "MXNET_NUM_WORKER",
                                 default="1"))
    if process_id is None:
        pid = _env("DMLC_WORKER_ID", "MXNET_WORKER_ID")
        if pid is None:
            raise RuntimeError("multi-process init needs DMLC_WORKER_ID")
        process_id = int(pid)
    if not 0 <= process_id < num_processes:
        # a misassigned rank fails before the rendezvous, which would
        # otherwise wait its whole deadline for a rank that cannot exist
        raise MXNetError(
            "invalid worker rank: DMLC_WORKER_ID=%d must be in "
            "[0, DMLC_NUM_WORKER=%d) — check the launcher's "
            "assignment" % (process_id, num_processes))
    host, _, port = coordinator_address.rpartition(":")

    from . import faultinject
    from .config import get as _cfg
    import logging
    import time
    deadline = _cfg("MXNET_DIST_INIT_TIMEOUT") if timeout is None \
        else float(timeout)
    backoff = max(0.0, _cfg("MXNET_DIST_INIT_BACKOFF"))
    max_attempts = _cfg("MXNET_DIST_INIT_RETRIES")   # 0: unlimited
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        remaining = deadline - (time.monotonic() - start)
        try:
            faultinject.maybe_fail(
                "rendezvous", RuntimeError,
                "injected fault: rendezvous attempt refused")
            store = _tcp_store(host, int(port), num_processes, process_id,
                               max(1.0, remaining))
            break
        except Exception as e:
            elapsed = time.monotonic() - start
            out_of_time = elapsed >= deadline
            out_of_tries = max_attempts > 0 and attempt >= max_attempts
            if out_of_time or out_of_tries:
                raise MXNetError(
                    "dist.initialize: rendezvous at %s failed after %d "
                    "attempt(s) over %.1fs (deadline %.1fs, retry budget "
                    "%s) as rank %d/%d — last error: %s: %s"
                    % (coordinator_address, attempt, elapsed, deadline,
                       max_attempts or "unlimited", process_id,
                       num_processes, type(e).__name__, e)) from e
            delay = retry_delay(attempt, backoff,
                                remaining=deadline - elapsed)
            logging.warning(
                "dist.initialize: rendezvous attempt %d at %s failed "
                "(%s: %s); retrying in %.1fs (%.1fs of %.1fs deadline "
                "left)", attempt, coordinator_address, type(e).__name__,
                e, delay, deadline - elapsed, deadline)
            time.sleep(delay)
    import torch
    import torch.distributed as tdist
    name, card = _decide_backend(store, process_id, num_processes)
    if name == "nccl":
        torch.cuda.set_device(card)
    tdist.init_process_group(
        name, store=store, rank=process_id, world_size=num_processes,
        timeout=_store_timeout(max(deadline, 60.0)))
    _PG.store, _PG.backend, _PG.card = store, name, card
    _PG.rank, _PG.size = process_id, num_processes
    _PG.cpu_devices = int(_env("MXNET_DIST_CPU_DEVICES", default="0") or 0)
    _PG.initialized = True
    import atexit
    atexit.register(_teardown)


def _teardown():
    """Close the group at exit, unless a collective was abandoned (its
    thread still blocks inside the transport)."""
    if not _PG.initialized or _PG.wedged:
        return
    try:
        import torch.distributed as tdist
        if tdist.is_initialized():
            tdist.destroy_process_group()
    except Exception:
        pass


def _coord_client():
    """The group's store, as the coordination-service client interface
    (:class:`StoreKV`); None outside a group."""
    if not _PG.initialized or _PG.store is None:
        return None
    return StoreKV(_PG.store)


_AGF_GEN: dict = {}           # tag -> call generation (collective calls
_AGF_LOCK = threading.Lock()  # happen in lockstep, so counters agree)


def allgather_floats(vec, tag: str = "stats",
                     timeout: Optional[float] = None):
    """One small float vector from every process: an (num_workers,
    len(vec)) numpy array, row r rank r's vector. The fleet view's
    transport. It rides the group's store (each rank publishes its row
    under a per-call generation key, then waits for every peer's), not
    a collective, so a dead rank surfaces as a timeout. The exchange
    runs under the kvstore deadline (``MXNET_KVSTORE_TIMEOUT``, 60 s when
    unset). Every rank calls it with the same ``tag`` sequence. One
    process: the vector as one row."""
    import numpy as np
    arr = np.asarray(vec, np.float32).reshape(-1)
    if not _PG.initialized or num_workers() <= 1:
        return arr.reshape(1, -1)
    if timeout is None:
        from .config import get as _cfg
        timeout = _cfg("MXNET_KVSTORE_TIMEOUT")
    if not timeout or timeout <= 0:
        timeout = 60.0
    with _AGF_LOCK:
        gen = _AGF_GEN[tag] = _AGF_GEN.get(tag, 0) + 1
    me, nw = rank(), num_workers()
    prefix = "mx/agf/%s/%d" % (tag, gen)
    store = _PG.store

    def _exchange():
        # an idempotent publish: a retried attempt sets the same key
        store.set("%s/%d" % (prefix, me),
                  ",".join("%.17g" % v for v in arr))
        keys = ["%s/%d" % (prefix, r) for r in range(nw)]
        store.wait(keys, _store_timeout(timeout))
        return np.asarray([[float(v) for v in
                            store.get(k).decode().split(",")]
                           for k in keys], np.float32)

    return call_with_deadline(_exchange, timeout + 5.0,
                              "allgather_floats(%s)" % tag)


def barrier(tag: str = "mx", timeout: Optional[float] = None) -> None:
    """Block until every process reaches the barrier (ref: kvstore
    barrier). A watchdog (``timeout``, default ``MXNET_BARRIER_TIMEOUT``;
    0 disables) raises MXNetError naming this rank and the tag instead of
    waiting forever when a rank never arrives, and a transport error is
    raised as MXNetError too. A failed barrier ends the group: restart
    the job from its last checkpoint."""
    from . import faultinject
    hang = faultinject.should_fail("barrier")
    if not _PG.initialized and not hang:
        return
    if timeout is None:
        from .config import get as _cfg
        timeout = _cfg("MXNET_BARRIER_TIMEOUT")

    def _sync():
        if hang:
            threading.Event().wait()   # a lost rank: never completes
            return
        import torch.distributed as tdist
        if _PG.backend == "nccl":
            tdist.barrier(device_ids=[_PG.card])
        else:
            tdist.barrier()

    done = threading.Event()
    errs = []

    def _run():
        try:
            _sync()
        except BaseException as e:   # surfaced on the caller's thread
            errs.append(e)
        finally:
            done.set()

    r, n = rank(), num_workers()
    if not timeout or timeout <= 0:
        _run()
    else:
        t = threading.Thread(target=_run, daemon=True,
                             name="mx-barrier-%s" % tag)
        t.start()
        if not done.wait(timeout):
            _PG.wedged = True
            raise MXNetError(
                "barrier %r timed out after %.1fs on rank %d: one of the "
                "other %d rank(s) never arrived (dead or preempted "
                "worker; raise MXNET_BARRIER_TIMEOUT if the job is "
                "legitimately slow)" % (tag, timeout, r, max(0, n - 1)))
    if errs:
        _PG.wedged = True
        raise MXNetError("barrier %r failed on rank %d/%d: %s: %s"
                         % (tag, r, n, type(errs[0]).__name__,
                            errs[0])) from errs[0]


def retry_delay(attempt: int, base: float, cap: float = 30.0,
                remaining: Optional[float] = None) -> float:
    """Exponential-backoff delay for retry `attempt` (1-based). The base
    is floored at 50ms so a zero backoff cannot spin, doubled per
    attempt, capped at `cap` and at the remaining deadline budget."""
    d = min(max(base, 0.05) * (2 ** (max(1, attempt) - 1)), cap)
    if remaining is not None:
        d = min(d, max(0.0, remaining))
    return d


def call_with_deadline(fn, timeout: Optional[float], tag: str,
                       retries: int = 1, backoff: float = 0.1):
    """Run ``fn()`` under a watchdog deadline with a bounded retry.

    The comms-watchdog primitive for dist kvstore calls: a collective
    that never completes (dead rank, wedged transport) times out after
    `timeout` seconds; the call is retried `retries` times (backoff via
    :func:`retry_delay`) and then raises a diagnosable MXNetError naming
    the call, this rank and the budget — instead of hanging the job
    forever. ``timeout`` falsy/<=0 runs `fn` directly (no watchdog
    thread overhead).

    Caveat (same as barrier's): a timed-out attempt's thread stays
    blocked inside the collective. Before re-running `fn`, the backoff
    window gives the stalled attempt a chance to finish late — a late
    completion is harvested instead of retried, so a merely-slow
    collective is not executed twice (a true re-run only happens after
    the attempt stayed wedged through the backoff; for a collective
    that later completes anyway, this rank would participate twice —
    one reason the retry budget defaults to a single attempt). Treat
    the final MXNetError as restart-from-checkpoint, not as
    retryable."""
    if not timeout or timeout <= 0:
        return fn()
    timeout = float(timeout)
    attempts = max(1, int(retries) + 1)
    import logging
    import time
    for attempt in range(1, attempts + 1):
        box = {}
        done = threading.Event()

        def _run():
            try:
                box["result"] = fn()
            except BaseException as e:   # surfaced on the caller thread
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=_run, daemon=True,
                             name="mx-comm-%s" % tag)
        t.start()
        if not done.wait(timeout) and attempt < attempts:
            from . import telemetry
            telemetry.count_event("mx_kvstore_retries_total", call=tag)
            delay = retry_delay(attempt, backoff)
            logging.warning(
                "comm watchdog: %s attempt %d timed out after %.1fs on "
                "rank %d; retrying in %.2fs (%d attempt(s) left)",
                tag, attempt, timeout, rank(), delay, attempts - attempt)
            # the backoff doubles as a grace window: harvest a late
            # completion rather than running the collective twice
            done.wait(delay)
        if done.is_set():
            if "error" in box:
                raise box["error"]
            return box.get("result")
    try:
        from . import guardrails
        # the guard event first: a telemetry failure below must not
        # suppress the watchdog event its listeners subscribe to
        guardrails.emit("watchdog", where="kvstore", wait=tag,
                        deadline=timeout, attempts=attempts)
    except Exception:
        pass
    from . import telemetry
    telemetry.count_event("mx_kvstore_deadline_hits_total", call=tag)
    _PG.wedged = True
    raise MXNetError(
        "kvstore %s timed out on rank %d/%d: %d attempt(s) of %.1fs "
        "each never completed — a peer rank is dead or the transport "
        "is wedged (MXNET_KVSTORE_TIMEOUT; raise it if the collective "
        "is legitimately slow, or restart the job from the last "
        "checkpoint)" % (tag, rank(), num_workers(), attempts, timeout))


class LocalKV:
    """In-process coordination-service-shaped KV store (dict + lock)."""

    def __init__(self):
        self._data: dict = {}
        self._lock = threading.Lock()

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        with self._lock:
            if not allow_overwrite and key in self._data:
                raise MXNetError("key already exists: %r" % key)
            self._data[key] = str(value)

    def key_value_try_get(self, key: str) -> str:
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def key_value_delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def key_value_dir_get(self, prefix: str):
        with self._lock:
            return sorted((k, v) for k, v in self._data.items()
                          if k.startswith(prefix))


class KVServer:
    """Stdlib TCP front on a LocalKV: newline-delimited JSON requests
    ``{"op": "set|get|del|dir", "k": key, "v": value, "ow": bool}``,
    one JSON reply per line, persistent connections, a thread per
    client. Control plane only: the payloads are small JSON leases."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import json
        import socketserver
        store = self.store = LocalKV()

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                        op, key = req.get("op"), req.get("k", "")
                        if op == "set":
                            store.key_value_set(
                                key, req.get("v", ""),
                                allow_overwrite=req.get("ow", True))
                            out = {"ok": True}
                        elif op == "get":
                            try:
                                out = {"ok": True,
                                       "v": store.key_value_try_get(key)}
                            except KeyError:
                                out = {"ok": False, "err": "missing"}
                        elif op == "del":
                            store.key_value_delete(key)
                            out = {"ok": True}
                        elif op == "dir":
                            out = {"ok": True,
                                   "items": store.key_value_dir_get(key)}
                        else:
                            out = {"ok": False, "err": "bad op %r" % op}
                    except Exception as e:
                        out = {"ok": False, "err": "%s: %s"
                               % (type(e).__name__, e)}
                    try:
                        self.wfile.write(
                            (json.dumps(out) + "\n").encode("utf-8"))
                        self.wfile.flush()
                    except OSError:
                        return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Server((host, port), _Handler)
        self.address = "%s:%d" % (host, self._srv.server_address[1])
        self._thread = threading.Thread(
            target=self._srv.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="mx-kv-server")
        self._thread.start()

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except Exception:
            pass


class TcpKV:
    """Client of a KVServer (the coordination service's interface). One
    persistent socket, requests serialised under a lock;
    one transparent reconnect per op so a server restart or a dropped
    connection is not fatal to the fleet."""

    def __init__(self, address: str, timeout: float = 5.0):
        host, _, port = address.rpartition(":")
        self.address = address
        self._addr = (host or "127.0.0.1", int(port))
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = None
        self._rfile = None

    def _connect(self):
        import socket
        self.close()
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        self._rfile = self._sock.makefile("rb")

    def _roundtrip(self, req: dict) -> dict:
        import json
        data = (json.dumps(req) + "\n").encode("utf-8")
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(data)
                    line = self._rfile.readline()
                    if not line:
                        raise ConnectionError("fleet KV closed connection")
                    return json.loads(line)
                except (OSError, ValueError) as e:
                    self.close()
                    if attempt:
                        raise ConnectionError(
                            "fleet KV %s unreachable (%s: %s)"
                            % (self.address, type(e).__name__, e)) from e
        raise AssertionError("unreachable")

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        out = self._roundtrip({"op": "set", "k": key, "v": str(value),
                               "ow": bool(allow_overwrite)})
        if not out.get("ok"):
            raise MXNetError("fleet KV set %r failed: %s"
                             % (key, out.get("err")))

    def key_value_try_get(self, key: str) -> str:
        out = self._roundtrip({"op": "get", "k": key})
        if not out.get("ok"):
            raise KeyError(key)
        return out.get("v", "")

    def key_value_delete(self, key: str) -> None:
        self._roundtrip({"op": "del", "k": key})

    def key_value_dir_get(self, prefix: str):
        out = self._roundtrip({"op": "dir", "k": prefix})
        if not out.get("ok"):
            raise MXNetError("fleet KV dir %r failed: %s"
                             % (prefix, out.get("err")))
        return [(k, v) for k, v in out.get("items", [])]

    def close(self) -> None:
        for attr in ("_rfile", "_sock"):
            obj = getattr(self, attr, None)
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass
            setattr(self, attr, None)


class StoreKV:
    """The process group's store (a ``torch.distributed`` Store) under
    the coordination service's client interface. The store cannot list
    its keys, so every key set through here is also recorded in an
    index (a counter and one entry a key) that ``key_value_dir_get``
    walks."""

    _INDEX = "mx/kvdir"

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()

    def _has(self, key: str) -> bool:
        return self._store.check([key])

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        with self._lock:
            new = not self._has(key)
            if not new and not allow_overwrite:
                raise MXNetError("key already exists: %r" % key)
            self._store.set(key, str(value))
            if new:
                n = self._store.add(self._INDEX + "/n", 1)
                self._store.set("%s/%d" % (self._INDEX, n - 1), key)

    def key_value_try_get(self, key: str) -> str:
        if not self._has(key):
            raise KeyError(key)
        return self._store.get(key).decode()

    def key_value_delete(self, key: str) -> None:
        self._store.delete_key(key)

    def key_value_dir_get(self, prefix: str):
        n = self._store.add(self._INDEX + "/n", 0)
        names = {self._store.get("%s/%d" % (self._INDEX, i)).decode()
                 for i in range(n)}
        out = []
        for k in sorted(names):
            if k.startswith(prefix) and self._has(k):
                out.append((k, self._store.get(k).decode()))
        return out


class KV:
    """One fleet-KV handle over any client of the coordination-service
    shape (``key_value_set``/``try_get``/``delete``/``dir_get``): a
    missing key reads None, every op passes the ``kv_flap`` fault site,
    and transport failures surface as ConnectionError, so callers
    (Router, Lease) tell an unreachable store from an absent key."""

    def __init__(self, client):
        self.client = client

    def _flap(self):
        from . import faultinject
        faultinject.maybe_fail("kv_flap", ConnectionError,
                               "injected fault: kv flap")

    def set(self, key: str, value: str) -> None:
        self._flap()
        self.client.key_value_set(key, value, allow_overwrite=True)

    def try_get(self, key: str) -> Optional[str]:
        self._flap()
        try:
            val = self.client.key_value_try_get(key)
        except KeyError:
            return None
        except Exception as e:
            # a coordination client signals absence with a NOT_FOUND
            # status wrapped in a generic runtime error
            if "NOT_FOUND" in str(e) or "not found" in str(e):
                return None
            raise
        return val.decode() if isinstance(val, bytes) else str(val)

    def delete(self, key: str) -> None:
        self._flap()
        delete = getattr(self.client, "key_value_delete", None)
        if delete is not None:
            delete(key)
        else:                      # a tombstone, as elastic.py writes
            self.client.key_value_set(key, "", allow_overwrite=True)

    def dir_get(self, prefix: str) -> dict:
        self._flap()
        items = self.client.key_value_dir_get(prefix)
        out = {}
        for k, v in items:
            out[k] = v.decode() if isinstance(v, bytes) else str(v)
        return out


def fleet_kv(address: Optional[str] = None) -> KV:
    """The fleet KV handle: ``address`` (or ``MXNET_SERVE_FLEET_KV``)
    gives a :class:`TcpKV`; else the process group's store when this
    process is in one (:class:`StoreKV`); else a fresh in-process
    :class:`LocalKV` (single-process use: every component sharing the
    handle shares the store)."""
    from .config import get as _cfg
    addr = address if address is not None else _cfg("MXNET_SERVE_FLEET_KV")
    if addr:
        return KV(TcpKV(addr))
    client = _coord_client()
    if client is not None:
        return KV(client)
    return KV(LocalKV())


# --- TTL'd liveness leases on the fleet KV -------------------------------

def lease_publish(kv: KV, key: str, payload: dict, ttl_s: float) -> None:
    """Write a lease: JSON ``{"t": now, "ttl": ttl_s, "p": payload}``.
    The KV store has no native TTL, so expiry is the reader's: a lease
    is alive while ``now - t <= ttl``. Clocks are comparable because
    the fleet shares a host (or NTP-synchronised hosts)."""
    import json
    import time
    kv.set(key, json.dumps({"t": time.time(), "ttl": float(ttl_s),
                            "p": payload}))


def _parse_lease(key: str, raw: str) -> Optional[dict]:
    import json
    import time
    if not raw or not raw.strip():         # tombstone
        return None
    try:
        rec = json.loads(raw)
        age = max(0.0, time.time() - float(rec["t"]))
        ttl = float(rec["ttl"])
    except (ValueError, KeyError, TypeError):
        return None                        # malformed lease != dead fleet
    return {"key": key, "payload": rec.get("p") or {}, "age": age,
            "ttl": ttl, "alive": age <= ttl}


def lease_read(kv: KV, key: str) -> Optional[dict]:
    """Read one lease -> {key, payload, age, ttl, alive} or None when
    absent/tombstoned/malformed."""
    raw = kv.try_get(key)
    return None if raw is None else _parse_lease(key, raw)


def lease_list(kv: KV, prefix: str) -> dict:
    """All leases under ``prefix`` -> {key: lease dict} (expired leases
    included with alive=False — the reader decides about ejection)."""
    out = {}
    for key, raw in kv.dir_get(prefix).items():
        rec = _parse_lease(key, raw)
        if rec is not None:
            out[key] = rec
    return out


class Lease:
    """Background lease renewal: re-publishes ``key`` every
    ``period_s`` (default ttl/3) with a fresh payload from
    ``payload_fn``. ``stop(drop=True)`` deletes the key — the
    EXPLICIT leave signal (drain); ``stop(drop=False)`` just stops
    renewing, which is what a crash looks like to readers (lease
    expiry). Renewal failures are counted and retried, never fatal —
    a flapping KV must not take down a healthy replica."""

    def __init__(self, kv: KV, key: str, ttl_s: float, payload_fn,
                 period_s: Optional[float] = None):
        self._kv, self.key, self._ttl = kv, key, float(ttl_s)
        self._payload_fn = payload_fn
        self._period = period_s if period_s else max(0.01, self._ttl / 3.0)
        self._stop = threading.Event()
        self.errors = 0
        self._last_payload = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mx-lease-%s" % key)

    def start(self) -> "Lease":
        self._renew()                       # publish before first serve
        self._thread.start()
        return self

    def _renew(self) -> None:
        # payload_fn and publish fail INDEPENDENTLY: a raising payload
        # field (e.g. a telemetry snapshot mid-reset) falls back to the
        # last good payload so LIVENESS still renews — a health detail
        # must never read as a dead replica. Nothing to fall back on
        # (first publish) skips the round.
        try:
            payload = self._payload_fn()
            self._last_payload = payload
        except Exception as e:
            self.errors += 1
            import logging
            logging.warning("lease %s payload_fn failed (%s: %s); "
                            "re-publishing last payload",
                            self.key, type(e).__name__, e)
            payload = self._last_payload
            if payload is None:
                return
        try:
            lease_publish(self._kv, self.key, payload, self._ttl)
        except Exception as e:
            self.errors += 1
            import logging
            logging.warning("lease %s renewal failed (%s: %s)",
                            self.key, type(e).__name__, e)

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self._renew()

    def renew_now(self) -> None:
        """Re-publish immediately — for payload changes readers must
        see before the next periodic renewal (e.g. a drain flag)."""
        self._renew()

    def stop(self, drop: bool = True) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        if drop:
            try:
                self._kv.delete(self.key)
            except Exception:
                pass


class KVWatcher:
    """Poll a lease directory on a background thread:
    ``on_update({key: lease})`` per successful poll,
    ``on_error(exc)`` per failed one (the caller keeps its
    last-known-good table — the kv_flap degradation seam). Callback
    exceptions are swallowed so the watch loop survives a buggy
    consumer."""

    def __init__(self, kv: KV, prefix: str, period_s: float,
                 on_update, on_error=None):
        self._kv, self._prefix = kv, prefix
        self._period = max(0.01, float(period_s))
        self._on_update, self._on_error = on_update, on_error
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="mx-kv-watch")

    def start(self) -> "KVWatcher":
        self.poll_once()
        self._thread.start()
        return self

    def poll_once(self) -> None:
        try:
            leases = lease_list(self._kv, self._prefix)
        except Exception as e:
            if self._on_error is not None:
                try:
                    self._on_error(e)
                except Exception:
                    pass
            return
        try:
            self._on_update(leases)
        except Exception:
            import logging
            logging.warning("KVWatcher on_update raised", exc_info=True)

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self.poll_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
