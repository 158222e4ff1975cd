"""The serving fleet's coordination: a small key-value store over TCP
and TTL'd liveness leases on it (counterpart of the fleet half of
``mxnet_tpu/dist.py``).

- :class:`LocalKV` (in-process), :class:`KVServer` (a stdlib TCP front
  on one, newline-delimited JSON) and :class:`TcpKV` (its client) share
  the coordination service's client interface; :class:`KV` wraps any of
  them with the ``kv_flap`` fault site, and :func:`fleet_kv` picks one.
- :func:`lease_publish`, :func:`lease_read`, :func:`lease_list`,
  :class:`Lease` (background renewal) and :class:`KVWatcher` (a polled
  lease directory): the replicas' liveness and the routers' view.
- :func:`retry_delay` and :func:`call_with_deadline`: the backoff and
  the watchdog the rendezvous and the kvstore use.

The process group itself (the ``DMLC_*`` rendezvous, :func:`initialize`,
:func:`allgather_floats`, :func:`barrier`) waits with multi-GPU
(ROADMAP.md queue 1, item 11): those raise. Without a process group this
process is rank 0 of 1.
"""
from __future__ import annotations

import threading
from typing import Optional

from .base import MXNetError

__all__ = ["LocalKV", "KVServer", "TcpKV", "KV", "fleet_kv",
           "lease_publish", "lease_read", "lease_list", "Lease",
           "KVWatcher", "retry_delay", "call_with_deadline", "rank",
           "num_workers", "is_initialized", "initialize",
           "allgather_floats", "barrier"]


def _not_ported(what):
    return NotImplementedError("%s is not ported yet (ROADMAP.md queue 1, "
                               "item 11)" % what)


def is_initialized() -> bool:
    return False


def rank() -> int:
    return 0


def num_workers() -> int:
    return 1


def initialize(*args, **kwargs):
    """The ``DMLC_*`` rendezvous: refused."""
    raise _not_ported("dist.initialize (the process-group rendezvous)")


def allgather_floats(*args, **kwargs):
    """A gather across the process group: refused."""
    raise _not_ported("dist.allgather_floats")


def barrier(*args, **kwargs):
    """A barrier across the process group: refused."""
    raise _not_ported("dist.barrier")


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
    gives a :class:`TcpKV`; else a fresh in-process :class:`LocalKV`
    (single-process use: every component sharing the handle shares the
    store). The reference's third source, the process group's
    coordination service, waits with the rendezvous (item 11)."""
    from .config import get as _cfg
    addr = address if address is not None else _cfg("MXNET_SERVE_FLEET_KV")
    if addr:
        return KV(TcpKV(addr))
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
