"""The port's serving fleet (``serve/fleet.py``, the fleet half of
``dist.py``, ``elastic.consume_kv_notice``) against the reference's: wire
frames byte for byte, the typed wire errors, the TCP KV and lease
expiry, the notice tombstones, first-wins futures, the circuit breaker,
retries within the deadline, hedge accounting, failover exactly once
under ``replica_crash``, the last-known-good table under ``kv_flap``,
the drain on SIGTERM, and spawned CPU replicas serving a checkpoint the
reference published, one of them SIGKILLed mid-load.

The fast cases run thread-backed ReplicaServers (the real TCP wire, toy
schedulers, an in-process KV) with 50 ms heartbeats. Every socket binds
127.0.0.1:0.
"""
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from mxnet_tpu.serve import fleet as r_fleet
from mxnet_tpu_torch import dist, elastic, faultinject, telemetry
from mxnet_tpu_torch.serve import fleet
from mxnet_tpu_torch.serve.fleet import ReplicaServer, Router
from mxnet_tpu_torch.serve.tenancy import OverloadError

HB = 0.05
MISS_K = 3
X = np.arange(8, dtype=np.float32).reshape(2, 4)


class ToyFuture:
    def __init__(self, value, delay=0.0):
        self._value, self._delay = value, delay

    def result(self, timeout=None):
        if self._delay:
            time.sleep(self._delay)
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value


class ToyScheduler:
    """The wire and routing layers need only submit/result/stats/close."""

    def __init__(self, delay=0.0, fail=None, depth=0, scale=2.0):
        self.delay, self.fail, self.depth = delay, fail, depth
        self.scale = scale
        self.calls = 0
        self.closed = False

    def submit(self, *arrays, tenant="default"):
        self.calls += 1
        if self.fail is not None:
            return ToyFuture(self.fail, self.delay)
        return ToyFuture(arrays[0] * self.scale, self.delay)

    def stats(self):
        return {"queue_depth": self.depth, "inflight": 0}

    def close(self, drain=None):
        self.closed = True


def _counter(prefix):
    return sum(v for k, v in telemetry.snapshot()["counters"].items()
               if k.startswith(prefix))


@pytest.fixture()
def kv():
    return dist.KV(dist.LocalKV())


@pytest.fixture(autouse=True)
def _no_faults():
    faultinject.clear()
    yield
    faultinject.clear()


def _mk(kv, rid, sched, **kw):
    return ReplicaServer(sched, rid, kv=kv, heartbeat_s=HB, miss_k=MISS_K,
                         **kw)


def _router(kv, **kw):
    kw.setdefault("heartbeat_s", HB)
    kw.setdefault("miss_k", MISS_K)
    r = Router(kv=kv, **kw)
    r.refresh()
    return r


def _wait(cond, timeout=10.0):
    t_dead = time.time() + timeout
    while not cond():
        if time.time() > t_dead:
            raise AssertionError("condition not met within %ss" % timeout)
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# the wire and the KV
# ---------------------------------------------------------------------------
class _Capture:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += bytes(b)


_FRAMES = [
    ({"op": "infer", "id": "abc", "tenant": "paid", "deadline": 12.5},
     [np.arange(6, dtype=np.float32).reshape(2, 3),
      np.array([[True, False]]), np.arange(4, dtype=np.int64),
      np.zeros((0, 3), np.uint8)]),
    ({"ok": True, "single": True, "id": "abc",
      "spans": [{"name": "x", "ts": 1.5}], "tr": [1.0, 2.0]},
     [np.full((1, 2), 7, np.int32)]),
    ({"ok": False, "error": {"code": "drain", "message": "m",
                             "tenant": ""}}, []),
]


@pytest.mark.parametrize("idx", range(len(_FRAMES)))
def test_wire_frames_byte_for_byte(idx):
    header, arrays = _FRAMES[idx]
    a, b = _Capture(), _Capture()
    r_fleet._send_frame(a, header, arrays)
    fleet._send_frame(b, header, arrays)
    assert b.data == a.data
    # a frame the reference sent decodes in the port
    s1, s2 = socket.socketpair()
    try:
        r_fleet._send_frame(s1, header, arrays)
        got_h, got = fleet._recv_frame(s2, deadline=time.time() + 10)
    finally:
        s1.close()
        s2.close()
    assert {k: v for k, v in got_h.items() if k != "arrays"} == header
    assert len(got) == len(arrays)
    for x, y in zip(arrays, got):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_tcp_kv_and_lease_expiry():
    srv = dist.KVServer()
    try:
        assert srv.address.startswith("127.0.0.1:")
        kv = dist.KV(dist.TcpKV(srv.address))
        kv.set("mx/t/a", "1")
        assert kv.try_get("mx/t/a") == "1"
        assert kv.try_get("mx/t/missing") is None
        kv.set("mx/t/b", "2")
        assert kv.dir_get("mx/t/") == {"mx/t/a": "1", "mx/t/b": "2"}
        kv.delete("mx/t/a")
        assert kv.try_get("mx/t/a") is None
        dist.lease_publish(kv, "mx/t/lease", {"addr": "h:1"}, ttl_s=0.1)
        rec = dist.lease_read(kv, "mx/t/lease")
        assert rec["alive"] and rec["payload"]["addr"] == "h:1"
        _wait(lambda: not dist.lease_read(kv, "mx/t/lease")["alive"])
        assert "mx/t/lease" in dist.lease_list(kv, "mx/t/")
        lease = dist.Lease(kv, "mx/t/renewed", 0.1, lambda: {"n": 1}).start()
        time.sleep(0.3)            # renewals keep it alive past a ttl
        assert dist.lease_read(kv, "mx/t/renewed")["alive"]
        lease.stop(drop=True)
        assert dist.lease_read(kv, "mx/t/renewed") is None
        # a server restart: the client reconnects once, transparently
        kv.client.close()
        kv.set("mx/t/c", "3")
        assert kv.try_get("mx/t/c") == "3"
    finally:
        srv.close()
    with pytest.raises(ConnectionError):
        dist.KV(dist.TcpKV(srv.address, timeout=0.5)).set("k", "v")


def test_consume_kv_notice_tombstone_dedup():
    class NoDelete:
        """A client without key_value_delete: consuming tombstones."""

        def __init__(self):
            self._kv = dist.LocalKV()
            self.key_value_try_get = self._kv.key_value_try_get

        def key_value_set(self, key, value, allow_overwrite=False):
            self._kv.key_value_set(key, value,
                                   allow_overwrite=allow_overwrite)

    client = NoDelete()
    client.key_value_set("mx/t/drain", "spec-1")
    dedup = [None]
    assert elastic.consume_kv_notice("mx/t/drain", dedup,
                                     client=client) == "spec-1"
    assert elastic.consume_kv_notice("mx/t/drain", dedup,
                                     client=client) is None
    assert client._kv.key_value_try_get("mx/t/drain") == ""
    client.key_value_set("mx/t/drain", "spec-2", allow_overwrite=True)
    assert elastic.consume_kv_notice("mx/t/drain", dedup,
                                     client=client) == "spec-2"
    assert elastic.consume_kv_notice("mx/t/drain", [None]) is None
    # a client with delete: the key goes
    local = dist.LocalKV()
    local.key_value_set("k", "v")
    assert elastic.consume_kv_notice("k", [None], client=local) == "v"
    with pytest.raises(KeyError):
        local.key_value_try_get("k")


def test_process_group_waits_with_multi_gpu():
    assert (dist.rank(), dist.num_workers(), dist.is_initialized()) == \
        (0, 1, False)
    for fn in (dist.initialize, dist.allgather_floats, dist.barrier):
        with pytest.raises(NotImplementedError, match="item 11"):
            fn()
    assert dist.retry_delay(3, 0.1) == pytest.approx(0.4)
    assert dist.call_with_deadline(lambda: 5, 1.0, "t") == 5


def test_fleet_future_first_wins():
    fut = fleet.FleetFuture("id", "t")
    assert fut._set(1, None, replica="a")
    assert not fut._set(2, None, replica="b")
    assert fut.result(0) == 1 and fut.replica == "a"
    late = fleet.FleetFuture("id2", "t")
    with pytest.raises(OverloadError) as ei:
        late.result(0.01)
    assert ei.value.code == "timeout"


def test_breaker_state_machine_matches_the_reference():
    seq = [False, False, True, False, False, False, None, True, False,
           None, None, True]
    out = []
    for mod in (r_fleet, fleet):
        b = mod._Breaker(threshold=2, base_s=0.02)
        trail = []
        for step in seq:
            if step is None:
                time.sleep(0.025 * (2 ** max(0, b.opens - 1)))
                trail.append(("allow", b.allow(), b.state))
            else:
                trail.append(("record", b.record(step), b.state))
        out.append(trail)
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# routing and the resilience ladder
# ---------------------------------------------------------------------------
def test_router_routes_and_spreads(kv):
    sa, sb = ToyScheduler(), ToyScheduler()
    ra, rb = _mk(kv, "ra", sa), _mk(kv, "rb", sb)
    router = _router(kv)
    try:
        np.testing.assert_array_equal(router.infer(X), X * 2.0)
        futs = [router.submit(X) for _ in range(12)]
        for f in futs:
            np.testing.assert_array_equal(f.result(10), X * 2.0)
        assert sa.calls > 0 and sb.calls > 0
        table = router.table()
        assert table["replicas"]["ra"]["alive"] and not table["stale"]
        rows = {r["replica"]: r for r in fleet.fleet_table()}
        assert rows["ra"]["requests"] + rows["rb"]["requests"] == 13
        assert "replica" in fleet.render_fleet_table().splitlines()[0]
    finally:
        router.close()
        ra.close()
        rb.close()


def test_lease_expiry_ejects(kv):
    sa, sb = ToyScheduler(), ToyScheduler()
    ra, rb = _mk(kv, "ra", sa), _mk(kv, "rb", sb)
    router = _router(kv)
    ej0 = _counter("mx_fleet_ejections_total")
    try:
        ra._lease.stop(drop=False)           # what a SIGKILL looks like
        _wait(lambda: router.refresh() or
              not router.table()["replicas"]["ra"]["alive"])
        assert router.table()["replicas"]["rb"]["alive"]
        assert _counter("mx_fleet_ejections_total") >= ej0 + 1
        before = sb.calls
        for _ in range(4):
            np.testing.assert_array_equal(router.infer(X), X * 2.0)
        assert sb.calls == before + 4
    finally:
        router.close()
        ra.close()
        rb.close()


def test_breaker_open_half_open_close(kv):
    sa = ToyScheduler(fail=RuntimeError("engine boom"))
    ra = _mk(kv, "ra", sa)
    router = _router(kv, retries=0, breaker_fails=3, breaker_ms=60)
    t0 = _counter("mx_fleet_breaker_transitions_total")
    try:
        for _ in range(3):
            with pytest.raises(Exception):
                router.infer(X)
        assert sa.calls == 3
        assert router.table()["replicas"]["ra"]["breaker"] == "open"
        with pytest.raises(OverloadError) as ei:
            router.infer(X)
        assert ei.value.code == "overload" and sa.calls == 3
        sa.fail = None
        time.sleep(0.08)
        np.testing.assert_array_equal(router.infer(X), X * 2.0)
        assert sa.calls == 4
        assert router.table()["replicas"]["ra"]["breaker"] == "closed"
        assert _counter("mx_fleet_breaker_transitions_total") >= t0 + 2
    finally:
        router.close()
        ra.close()


def test_retry_within_the_deadline(kv):
    sa = ToyScheduler(delay=0.3, fail=RuntimeError("slow boom"))
    sb = ToyScheduler(depth=50)
    ra, rb = _mk(kv, "ra", sa), _mk(kv, "rb", sb)
    _wait(lambda: dist.lease_read(
        kv, "mx/fleet/fleet/replicas/rb")["payload"]["queue_depth"] == 50)
    router = _router(kv, retries=2)
    try:
        with pytest.raises(OverloadError) as ei:
            router.infer(X, deadline_ms=120)
        assert ei.value.code == "timeout"
        assert sb.calls == 0                 # never retried past it
        sa.fail, sa.delay = RuntimeError("fast boom"), 0.0
        np.testing.assert_array_equal(router.infer(X, deadline_ms=5000),
                                      X * 2.0)
        assert sb.calls == 1                 # retried within it
        assert _counter('mx_fleet_retries_total{reason="error"}') >= 1
    finally:
        router.close()
        ra.close()
        rb.close()


def test_hedge_accounting(kv):
    sa, sb = ToyScheduler(delay=0.4), ToyScheduler(depth=20)
    ra, rb = _mk(kv, "ra", sa), _mk(kv, "rb", sb)
    _wait(lambda: dist.lease_read(
        kv, "mx/fleet/fleet/replicas/rb")["payload"]["queue_depth"] == 20)
    router = _router(kv, retries=1)
    won0 = _counter('mx_fleet_hedges_total{result="won"}')
    lost0 = _counter('mx_fleet_hedges_total{result="lost"}')
    can0 = _counter("mx_fleet_hedge_cancelled_total")
    try:
        np.testing.assert_array_equal(router.infer(X, hedge_ms=60), X * 2.0)
        assert sb.calls == 1
        assert _counter('mx_fleet_hedges_total{result="won"}') == won0 + 1
        _wait(lambda: _counter("mx_fleet_hedge_cancelled_total") == can0 + 1)
        sa.delay, sb.delay = 0.1, 0.4
        np.testing.assert_array_equal(router.infer(X, hedge_ms=60), X * 2.0)
        assert _counter('mx_fleet_hedges_total{result="lost"}') == lost0 + 1
    finally:
        router.close()
        ra.close()
        rb.close()


def test_replica_crash_fails_over_exactly_once(kv):
    sa, sb = ToyScheduler(), ToyScheduler()
    ra, rb = _mk(kv, "ra", sa), _mk(kv, "rb", sb)
    router = _router(kv, retries=2)
    fo0 = _counter("mx_fleet_failovers_total")
    dup0 = _counter("mx_fleet_discarded_results_total")
    try:
        faultinject.set_fault("replica_crash", 1.0, max_fires=1)
        np.testing.assert_array_equal(router.infer(X), X * 2.0)
        assert ra.crashed != rb.crashed
        crashed, surviving = (sa, sb) if ra.crashed else (sb, sa)
        assert crashed.calls == 1 and surviving.calls == 1
        assert _counter("mx_fleet_failovers_total") == fo0 + 1
        assert _counter("mx_fleet_discarded_results_total") == dup0
    finally:
        router.close()
        ra.close()
        rb.close()


def test_kv_flap_keeps_the_last_known_good_table(kv):
    sa, sb = ToyScheduler(), ToyScheduler()
    ra, rb = _mk(kv, "ra", sa), _mk(kv, "rb", sb)
    router = _router(kv, heartbeat_s=2.0)
    err0 = _counter("mx_fleet_kv_errors_total")
    try:
        faultinject.set_fault("kv_flap", 1.0, max_fires=1)
        router.refresh()
        table = router.table()
        assert table["stale"]
        assert table["replicas"]["ra"]["alive"]
        assert table["replicas"]["rb"]["alive"]
        assert _counter("mx_fleet_kv_errors_total") == err0 + 1
        assert telemetry.snapshot()["gauges"]["mx_fleet_routing_stale"] == 1
        np.testing.assert_array_equal(router.infer(X), X * 2.0)
        router.refresh()
        assert not router.table()["stale"]
    finally:
        router.close()
        ra.close()
        rb.close()


def test_drain_on_sigterm_completes_accepted_work(kv):
    """A real SIGTERM to this process: the handler only flips a flag, the
    drain poll folds it in, every accepted request completes and new
    work is refused."""
    sa = ToyScheduler(delay=0.2)
    ra = _mk(kv, "ra", sa)
    router = _router(kv, retries=0)
    old = signal.getsignal(signal.SIGTERM)
    shed0 = _counter('mx_fleet_shed_total{code="drain"}')
    try:
        futs = [router.submit(X) for _ in range(6)]
        _wait(lambda: sa.calls == 6)
        if threading.current_thread() is threading.main_thread():
            ra.install_sigterm()
            os.kill(os.getpid(), signal.SIGTERM)
        else:                       # no handler off the main thread
            ra._sigterm_flag[0] = True
        for f in futs:
            np.testing.assert_array_equal(f.result(10), X * 2.0)
        assert ra.wait(timeout=10) and sa.closed
        assert _counter('mx_fleet_shed_total{code="drain"}') == shed0
        router.refresh()
        with pytest.raises(OverloadError):
            router.infer(X, deadline_ms=200)
    finally:
        signal.signal(signal.SIGTERM, old)
        router.close()
        ra.close()


class _BigScheduler(ToyScheduler):
    def submit(self, *arrays, tenant="default"):
        self.calls += 1
        return ToyFuture(np.ones((4096, 2048), np.float32))   # 32 MB


@pytest.mark.parametrize("which", ["ref", "port"])
def test_a_large_reply_to_a_slow_reader(which):
    """A reply far larger than the socket buffers, read only after half a
    second: the port's replica sends it under a reply timeout and it
    arrives whole; the reference's sends under its receive loop's 0.1 s
    poll timeout and drops the connection mid-frame (a fault found in
    the reference, not copied)."""
    from mxnet_tpu import dist as r_dist
    mod, kvmod = (fleet, dist) if which == "port" else (r_fleet, r_dist)
    server = mod.ReplicaServer(_BigScheduler(), "big",
                               kv=kvmod.KV(kvmod.LocalKV()), heartbeat_s=HB,
                               miss_k=MISS_K)
    sock = socket.create_connection(server.addr, timeout=5)
    try:
        fleet._send_frame(sock, {"op": "infer", "id": "x", "tenant": "t"},
                          [X])
        time.sleep(0.5)
        if which == "port":
            header, arrays = fleet._recv_frame(sock,
                                               deadline=time.time() + 30)
            assert header["ok"] and arrays[0].shape == (4096, 2048)
            assert float(arrays[0].sum()) == 4096 * 2048
        else:
            with pytest.raises(ConnectionError, match="mid-frame"):
                fleet._recv_frame(sock, deadline=time.time() + 30)
    finally:
        sock.close()
        server.close()


def test_demo_factory_defaults_to_the_card():
    """A deliberate difference: a replica's context is the card unless
    its spec asks for the CPU (the reference's default is the CPU)."""
    assert fleet.spec_context({}).device_type == "gpu"
    assert fleet.spec_context({"ctx": "gpu"}).device_type == "gpu"
    assert fleet.spec_context({"ctx": "cpu"}).device_type == "cpu"
    sched = fleet.demo_factory({"ctx": "cpu", "seed": 3})
    try:
        x = np.ones((2, 8), np.float32)
        assert sched.submit(x).result(30).shape == (2, 4)
        assert sched._session._ctx.device_type == "cpu"
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# spawned replica processes, a checkpoint the reference published, SIGKILL
# ---------------------------------------------------------------------------
MP_LIMIT_S = 150.0


def test_spawned_cpu_replicas_survive_a_sigkill(tmp_path):
    import mxnet_tpu as mx
    from mxnet_tpu import model as r_model

    prefix = str(tmp_path / "ck")
    mx.random.seed(7)
    net = mx.gluon.nn.HybridSequential(prefix="fleetrep_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, in_units=8, activation="relu"),
                mx.gluon.nn.Dense(4, in_units=16))
    net.initialize(init=mx.initializer.Xavier())
    params = {k: p.data() for k, p in net.collect_params().items()}
    r_model.save_checkpoint(prefix, 0, None, params, {}, sync=True)
    x = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    want = net(mx.nd.array(x)).asnumpy()

    mgr = fleet.ReplicaManager(
        n=2, spec={"ckpt_prefix": prefix, "seed": 99, "ctx": "cpu",
                   "heartbeat_s": 0.25, "miss_k": 3})
    router = None
    # the test's own limit: past it every replica is killed, so each
    # wait below fails at its own timeout instead of hanging the suite
    watchdog = threading.Timer(MP_LIMIT_S, lambda: [
        p.kill() for p in list(mgr._procs.values())])
    watchdog.daemon = True
    watchdog.start()
    try:
        mgr.start(timeout=90)
        router = Router(kv=mgr.kv, heartbeat_s=0.25, miss_k=3, retries=2)
        router.refresh()
        np.testing.assert_allclose(router.infer(x), want, rtol=1e-5,
                                   atol=1e-5)
        results, errors = [], []

        def client():
            for _ in range(8):
                try:
                    results.append(router.submit(x).result(30))
                except Exception as e:       # pragma: no cover
                    errors.append(e)
                time.sleep(0.01)

        fo0 = _counter("mx_fleet_failovers_total")
        re0 = _counter("mx_fleet_retries_total")
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        _wait(lambda: len(results) >= 8 or errors, timeout=30)
        mgr.kill("r0")
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert len(results) == 32                   # none dropped
        for out in results:
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        assert (_counter("mx_fleet_failovers_total") - fo0
                + _counter("mx_fleet_retries_total") - re0) >= 1
        mgr.terminate("r1")                         # SIGTERM: drain
        mgr._procs["r1"].join(timeout=15)
        assert mgr._procs["r1"].exitcode == 0
    finally:
        watchdog.cancel()
        if router is not None:
            router.close()
        mgr.stop()
