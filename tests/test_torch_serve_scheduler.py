"""The port's continuous-batching Scheduler (``serve/scheduler.py``) and
tenancy (``serve/tenancy.py``) against the reference's: the same queued
state assembles the same batches, a small BERT served through both
schedulers agrees, sheds carry the same codes and metric labels, the
drain on ``close``, the engine's ``on_done`` accounting, and the SLO
report on the same recorded requests.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import telemetry as r_tele
from mxnet_tpu.serve import Scheduler as RScheduler
from mxnet_tpu.serve import tenancy as r_ten
from mxnet_tpu_torch import engine as p_engine
from mxnet_tpu_torch import telemetry as p_tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import Scheduler as PScheduler
from mxnet_tpu_torch.serve import tenancy as p_ten

from test_torch_bert_serve import TOL, _pair, _tokens

LIBS = {"ref": (mx, RScheduler, r_ten, r_tele),
        "port": (pt, PScheduler, p_ten, p_tele)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_SERVE_BUCKETS", "MXNET_TRACE", "MXNET_TELEMETRY"):
        monkeypatch.delenv(var, raising=False)
    for tele in (r_tele, p_tele):
        tele.refresh()
        tele.reset()
    yield
    monkeypatch.undo()
    for tele in (r_tele, p_tele):
        tele.refresh()
        tele.reset()


@pytest.fixture()
def tele(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    for t in (r_tele, p_tele):
        t.refresh()
        t.reset()


class _BlockingSession:
    """A session stub whose ``infer`` blocks until released, so a
    scheduler's batcher can be held inside a batch while its queues are
    filled."""

    seq_axis = None
    _out_scales = None

    def __init__(self, max_batch=8):
        self.max_batch = max_batch
        self.entered = threading.Event()
        self.release = threading.Event()

    @staticmethod
    def _as_host(x):
        return np.asarray(x)

    def validate_request(self, hosts):
        if not hosts[0].shape[0]:
            raise ValueError("empty")

    def infer(self, *datas):
        self.entered.set()
        assert self.release.wait(30)
        return np.asarray(datas[0]) * 2


_TENANTS = (("a", 2.0), ("b", 1.0), ("c", 1.0), ("d", 4.0))


def _assembly_sequence(Scheduler, ten):
    sess = _BlockingSession()
    sched = Scheduler(sess, max_wait_ms=0, inflight=1,
                      tenants=[ten.TenantConfig(n, weight=w)
                               for n, w in _TENANTS])
    try:
        sched.submit(np.ones((1, 4), np.float32), tenant="a")
        assert sess.entered.wait(30)       # the batcher is held
        rng = np.random.RandomState(0)
        for i in range(48):
            t = _TENANTS[rng.randint(len(_TENANTS))][0]
            rows = 3 if t == "c" else int(rng.randint(1, 4))
            sched.submit(np.full((rows, 4), i, np.float32), tenant=t)
        batches = []
        with sched._cv:
            while True:
                batch = sched._assemble_locked()
                if not batch:
                    break
                batches.append([(r.tenant, r.future.order, r.n)
                                for r in batch])
        return batches
    finally:
        sess.release.set()
        sched.close(drain=0)


def test_same_queued_state_assembles_the_same_batches():
    want = _assembly_sequence(RScheduler, r_ten)
    got = _assembly_sequence(PScheduler, p_ten)
    assert got == want
    assert sum(len(b) for b in got) == 48
    assert all(sum(n for _, _, n in b) <= 8 for b in got)
    # the weight-4 tenant is served ahead of its share at the start
    first = [t for b in got[:2] for t, _, _ in b]
    assert first.count("d") >= first.count("b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_bert_through_both_schedulers(pallas_interpret, dtype):
    """A 2-layer BERT at units 64 and 4 heads, the same weights, two
    tenants, requests of 1-2 rows and lengths 3-16 through each
    package's Scheduler (the port's at inflight 2, on its native
    engine): the outputs agree within the served-BERT tolerance. With one
    batch bucket a scheduled batch and a direct ``infer`` of one of its
    requests run the same program; on the CPU a row's sums may still
    take another order at another position of the batch, so the port's
    outputs are held to its direct ``infer`` within 1e-6 here (the card
    test holds them bit for bit)."""
    ref, port, example = _pair(dtype=dtype)
    ids0, tok0 = example
    rs = ref.serve_session(mx.nd.array(ids0), mx.nd.array(tok0), seq_axis=1,
                           max_batch=4, max_seq=16, buckets="4;8,16")
    ps = port.serve_session(pt.nd.array(ids0, ctx=pt.cpu()),
                            pt.nd.array(tok0, ctx=pt.cpu()), seq_axis=1,
                            max_batch=4, max_seq=16, buckets="4;8,16")
    tenants = lambda ten: [ten.TenantConfig("free", weight=1),  # noqa: E731
                           ten.TenantConfig("paid", weight=4)]
    r_sched = RScheduler(rs, tenants=tenants(r_ten), max_wait_ms=2,
                         inflight=2)
    p_sched = PScheduler(ps, tenants=tenants(p_ten), max_wait_ms=2,
                         inflight=2)
    rng = np.random.RandomState(3)
    reqs = []
    for i in range(12):
        ids, tok = _tokens(rng, int(rng.randint(1, 3)),
                           int(rng.randint(3, 17)))
        reqs.append((ids, tok, "paid" if i % 3 else "free"))
    try:
        r_futs = [r_sched.submit(a, b, tenant=t) for a, b, t in reqs]
        p_futs = [p_sched.submit(a, b, tenant=t) for a, b, t in reqs]
        r_outs = [f.result(120) for f in r_futs]
        p_outs = [f.result(120) for f in p_futs]
    finally:
        r_sched.close()
        p_sched.close()
    for (ids, tok, _), ro, po in zip(reqs, r_outs, p_outs):
        assert len(po) == len(ro) == 4
        assert po[0].shape == (ids.shape[0], ids.shape[1], 64)
        for r, p in zip(ro[:3], po[:3]):
            np.testing.assert_allclose(p, np.asarray(r, np.float32),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        direct = ps.infer(ids, tok)
        for p, d in zip(po[:3], direct[:3]):
            np.testing.assert_allclose(p, d, rtol=1e-6, atol=1e-6)
        # the decoder output (seq, batch, vocab) comes whole to each of
        # the batch's requests: hold the request's own columns
        rows, seq = ids.shape
        p_dec = _own_columns(po[3], direct[3][:seq, :rows], 1e-6)
        r_dec = _own_columns(np.asarray(ro[3], np.float32),
                             np.asarray(rs.infer(ids, tok)[3],
                                        np.float32)[:seq, :rows], 1e-6)
        np.testing.assert_allclose(p_dec, r_dec, rtol=TOL[dtype],
                                   atol=TOL[dtype])


def _own_columns(batch_out, want, tol):
    """The columns of a batch's decoder output (seq, batch, vocab) that
    hold one request's rows: those within ``tol`` of its direct infer's
    ``want`` (seq, rows, vocab)."""
    seq, rows = want.shape[:2]
    for off in range(batch_out.shape[1] - rows + 1):
        got = batch_out[:seq, off:off + rows]
        if np.allclose(got, want, rtol=tol, atol=tol):
            return got
    raise AssertionError("no columns of the batch's decoder output %s hold "
                         "the request's %s" % (batch_out.shape, want.shape))


def _mlp(lib, max_batch=4):
    lib.random.seed(0)
    net = lib.gluon.nn.HybridSequential()
    net.add(lib.gluon.nn.Dense(32, in_units=16, activation="relu"),
            lib.gluon.nn.Dense(8))
    net.initialize(init=lib.initializer.Xavier(), ctx=lib.cpu())
    x = lib.nd.array(np.ones((2, 16), np.float32), ctx=lib.cpu())
    return net.serve_session(x, max_batch=max_batch)


def _serve_counters(tele):
    return {k: v for k, v in tele.snapshot()["counters"].items()
            if k.startswith("mx_serve_requests_total")}


@pytest.mark.parametrize("which", sorted(LIBS))
def test_sheds_carry_the_reference_codes_and_labels(tele, which,
                                                   monkeypatch):
    lib, Scheduler, ten, telem = LIBS[which]
    sess = _mlp(lib)
    real_infer = sess.infer
    gate = threading.Event()

    def slow_infer(*a, **kw):
        gate.wait(30)
        return real_infer(*a, **kw)

    monkeypatch.setattr(sess, "infer", slow_infer)
    sched = Scheduler(sess, max_wait_ms=0, inflight=1, tenants=[
        ten.TenantConfig("t", deadline_ms=40, queue_cap=2)])
    x = np.zeros((1, 16), np.float32)
    try:
        f1 = sched.submit(x, tenant="t")          # dispatched, held
        t_dead = time.time() + 10
        while sched.inflight == 0 and time.time() < t_dead:
            time.sleep(0.005)
        f2 = sched.submit(x, tenant="t")
        f3 = sched.submit(x, tenant="t")
        with pytest.raises(ten.OverloadError) as ei:
            sched.submit(x, tenant="t")           # past queue_cap 2
        assert (ei.value.code, ei.value.tenant) == ("overload", "t")
        time.sleep(0.06)                          # queued past 40 ms
        gate.set()
        assert f1.result(30) is not None
        for f in (f2, f3):
            with pytest.raises(ten.OverloadError) as ei:
                f.result(30)
            assert ei.value.code == "timeout"
    finally:
        gate.set()
        sched.close()
    assert _serve_counters(telem) == {
        'mx_serve_requests_total{code="ok",tenant="t"}': 1,
        'mx_serve_requests_total{code="overload",tenant="t"}': 1,
        'mx_serve_requests_total{code="timeout",tenant="t"}': 2}
    line = telem.heartbeat_line()
    assert " serve=reqs:4,shed:3,qdepth:0," in line


def test_drain_on_close_serves_the_queue_then_sheds():
    sess = _mlp(pt)
    sched = PScheduler(sess, max_wait_ms=50)
    x = np.zeros((1, 16), np.float32)
    futs = [sched.submit(x) for _ in range(3)]
    sched.close(drain=20)
    for f in futs:
        assert f.result(5).shape == (1, 8)
    with pytest.raises(p_ten.OverloadError) as ei:
        sched.submit(x)
    assert ei.value.code == "drain"


def test_drain_deadline_fails_the_leftovers(monkeypatch):
    sess = _mlp(pt, max_batch=1)
    real_infer = sess.infer

    def slow_infer(*a, **kw):
        time.sleep(0.1)
        return real_infer(*a, **kw)

    monkeypatch.setattr(sess, "infer", slow_infer)
    sched = PScheduler(sess, max_wait_ms=0, inflight=1)
    futs = [sched.submit(np.zeros((1, 16), np.float32)) for _ in range(6)]
    sched.close(drain=0.15)
    outcomes = []
    for f in futs:
        try:
            f.result(10)
            outcomes.append("ok")
        except p_ten.OverloadError as e:
            outcomes.append(e.code)
    assert "ok" in outcomes and "drain" in outcomes
    assert set(outcomes) <= {"ok", "drain"}


def test_on_done_accounting_through_the_native_engine():
    eng = p_engine.native_engine()
    done, lock = [], threading.Lock()

    def hook(tag):
        def on_done(failed):
            with lock:
                done.append((tag, failed))
            raise RuntimeError("a failing hook is swallowed")
        return on_done

    def boom():
        raise ValueError("op failed")

    var = eng.new_var()
    eng.push_async(lambda: None, label="ok", on_done=hook("ok"))
    eng.push_async(boom, write_vars=(var,), label="boom",
                   on_done=hook("boom"))
    with pytest.raises(ValueError, match="op failed"):
        eng.wait_for_var(var)
    eng.wait_for_all()
    assert sorted(done) == [("boom", True), ("ok", False)]
    # a collective push runs as any other, its descriptor kept
    ran = []
    eng.push_async(lambda: ran.append(1), label="coll", write_vars=(var,),
                   collective={"program": "x", "lock": 7})
    eng.wait_for_var(var)
    assert ran == [1]
    assert eng.collective_pushes()[-1] == ("coll", {"program": "x",
                                                    "lock": 7})


def test_an_engine_op_cannot_drain_its_engine():
    """A capture drains the engine first; inside an engine op the drain
    would wait for the op itself, so it raises there (the Scheduler runs
    a bucket's first batch, its capture, on its own thread)."""
    eng = p_engine.native_engine()
    var = eng.new_var()
    eng.push_async(p_engine.native_drain, write_vars=(var,), label="drain")
    with pytest.raises(MXNetError, match="wait for itself"):
        eng.wait_for_var(var)
    p_engine.native_drain()     # outside an op it waits and returns


def test_inflight_slots_return_after_engine_batches():
    sess = _mlp(pt)
    sched = PScheduler(sess, max_wait_ms=0, inflight=2)
    try:
        futs = [sched.submit(np.full((1, 16), i, np.float32))
                for i in range(20)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(
                f.result(30), sess.infer(np.full((1, 16), i, np.float32)),
                rtol=1e-6, atol=1e-6)
        t_dead = time.time() + 10
        while sched.inflight and time.time() < t_dead:
            time.sleep(0.005)
        assert sched.inflight == 0
        assert sched.stats() == {"queue_depth": 0, "inflight": 0,
                                 "tenants": ["default"]}
    finally:
        sched.close()


def test_a_failed_engine_build_raises_and_inflight_one_bypasses(
        monkeypatch):
    """Pinned differences: from an in-flight cap of 2 batches of a
    captured bucket need the engine, and a failed build fails the batch
    (the reference falls back to running it synchronously); a bucket's
    first batch, whose capture drains the engine, runs on the batcher's
    thread; at a cap of 1 batches run on the batcher's thread and never
    touch the engine, as the reference's do."""
    def no_engine():
        raise MXNetError("engine library failed to build")

    monkeypatch.setattr(p_engine, "native_engine", no_engine)
    sess = _mlp(pt)
    x = np.ones((1, 16), np.float32)
    sched = PScheduler(sess, max_wait_ms=0, inflight=2)
    try:
        np.testing.assert_array_equal(sched.submit(x).result(30),
                                      sess.infer(x))
        with pytest.raises(MXNetError, match="failed to build"):
            sched.submit(x).result(30)
        assert sched.inflight == 0
    finally:
        sched.close()
    sched = PScheduler(sess, max_wait_ms=0, inflight=1)
    try:
        np.testing.assert_array_equal(sched.submit(x).result(30),
                                      sess.infer(x))
    finally:
        sched.close()


def test_slo_report_rows_equal_the_reference(tele):
    rng = np.random.RandomState(5)
    events = []
    for i in range(40):
        tenant = ("free", "paid", "batch")[i % 3]
        code = ("ok", "ok", "ok", "timeout", "overload")[rng.randint(5)]
        events.append((tenant, code, float(rng.uniform(1e-3, 0.4)),
                       float(rng.uniform(0, 5e-2)), float(rng.randint(1, 64))))
    rows = []
    for _, _, ten, _ in LIBS.values():
        for tenant, code, lat, q, tok in events:
            ten.record_request(tenant, code, latency_s=lat, queue_s=q,
                               tokens=tok, deadline_ms=200.0)
        ten.set_queue_depth("free", 3)
        cfg = [ten.TenantConfig("free", deadline_ms=200.0),
               ten.TenantConfig("paid", weight=4)]
        rows.append(ten.slo_report(cfg))
    # tokens_per_s is a rate over each run's own clock
    strip = [[{k: v for k, v in r.items() if k != "tokens_per_s"}
              for r in got] for got in rows]
    assert strip[1] == strip[0]
    assert [r["tenant"] for r in rows[1]][0] in ("free", "paid", "batch")
    assert sum(r["slo_violations"] for r in rows[1]) > 0
    text = p_ten.render_slo_report(rows[1])
    assert text.splitlines()[0].split()[:4] == ["tenant", "requests", "ok",
                                               "shed"]


def test_wire_errors_equal_the_reference():
    cases = [r_ten.OverloadError("queue full", code="overload",
                                 tenant="paid"),
             r_ten.OverloadError("late", code="timeout", tenant="free"),
             r_ten.OverloadError("leaving", code="drain"),
             ValueError("boom"), RuntimeError("kernel exploded")]
    port_cases = [p_ten.OverloadError(str(e), code=e.code, tenant=e.tenant)
                  if isinstance(e, r_ten.OverloadError) else e
                  for e in cases]
    for r, p in zip(cases, port_cases):
        rw, pw = r_ten.to_wire_error(r), p_ten.to_wire_error(p)
        assert pw == rw
        rb, pb = r_ten.from_wire_error(rw), p_ten.from_wire_error(pw)
        assert type(pb).__name__ == type(rb).__name__
        assert getattr(pb, "code", None) == getattr(rb, "code", None)
        assert str(pb) == str(rb)
    for code in ("overload", "timeout", "drain", "error", "ok", "x"):
        assert p_ten.http_status(code) == r_ten.http_status(code)
    with pytest.raises(MXNetError):
        p_ten.TenantConfig("t", weight=0)
    assert repr(p_ten.TenantConfig("t", 2, 50)) == \
        repr(r_ten.TenantConfig("t", 2, 50))


def test_session_telemetry_and_compile_accounting(tele):
    """A miss counts in mx_serve_bucket_miss_total{bucket}; a warm
    bucket's forward lands in mx_serve_batch_seconds{bucket}, a cold
    one's (its capture) is cancelled and recorded by compilewatch as a
    program; under a sampled context the forward is a serve::forward
    span; the same counters as the reference's session."""
    from mxnet_tpu_torch import compilewatch, tracing
    got = {}
    for which, (lib, _, _, telem) in LIBS.items():
        sess = _mlp(lib)
        x = np.ones((3, 16), np.float32)
        sess.infer(x)                      # cold b4: a miss
        sess.infer(x)                      # warm
        sess.infer(np.ones((1, 16), np.float32))   # cold b1
        snap = telem.snapshot()
        got[which] = (
            {k: v for k, v in snap["counters"].items()
             if k.startswith("mx_serve_bucket_miss_total")},
            {k: v["count"] for k, v in snap["histograms"].items()
             if k.startswith("mx_serve_batch_seconds")})
    assert got["port"] == got["ref"]
    assert got["port"][0] == {'mx_serve_bucket_miss_total{bucket="b1"}': 1,
                              'mx_serve_bucket_miss_total{bucket="b4"}': 1}
    assert got["port"][1] == {'mx_serve_batch_seconds{bucket="b4"}': 1}
    assert compilewatch.programs(), "no capture-site program recorded"
    tracing.enable(True, sample=1.0)
    try:
        sess = _mlp(pt)
        ctx = tracing.mint()
        with tracing.bind(ctx):
            sess.infer(np.ones((2, 16), np.float32))
        spans = tracing.take_for(ctx.trace_id)
        assert [s["name"] for s in spans] == ["serve::forward"]
        assert spans[0]["args"] == {"bucket": "b2", "warm": False}
    finally:
        tracing.enable(False)
        tracing.reset()
