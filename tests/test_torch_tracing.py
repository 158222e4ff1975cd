"""The port's distributed request tracing (``mxnet_tpu_torch/tracing.py``
with its telemetry wiring) against the reference's: the bounded span
ring with counted drops, clock skew, the critical path of the
reference's own span fixture, TraceStore's skew and dedup, the
heartbeat's ``trace=`` section, ``traces.json`` in the crash bundle,
and the spans a real port Scheduler records under a sampled context.
Both packages run every scenario on the same inputs where the result
does not depend on timing.
"""
import json
import os
import threading
import types

import numpy as np
import pytest

import mxnet_tpu_torch as pt
from mxnet_tpu import telemetry as r_tele
from mxnet_tpu import tracing as r_trc
from mxnet_tpu_torch import telemetry as p_tele
from mxnet_tpu_torch import tracing as p_trc

PKGS = {"ref": types.SimpleNamespace(tracing=r_trc, telemetry=r_tele),
        "port": types.SimpleNamespace(tracing=p_trc, telemetry=p_tele)}
TRACE_VARS = ("MXNET_TRACE", "MXNET_TRACE_SAMPLE", "MXNET_TRACE_RING",
              "MXNET_TRACE_EXEMPLARS")


def _reset_all():
    for ns in PKGS.values():
        ns.tracing.refresh()
        ns.tracing.reset()
        ns.telemetry.refresh()
        ns.telemetry.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in TRACE_VARS + ("MXNET_TELEMETRY",):
        monkeypatch.delenv(var, raising=False)
    _reset_all()
    yield
    for ns in PKGS.values():
        ns.tracing.enable(False)
    monkeypatch.undo()
    _reset_all()


@pytest.fixture(params=sorted(PKGS))
def lib(request):
    return PKGS[request.param]


# the reference's critical-path fixture (tests/test_tracing.py)
SPANS = [
    {"cat": "fleet", "dur": 100e3, "args": {}},
    {"cat": "attempt", "dur": 40e3, "args": {"outcome": "conn",
                                             "error": "boom"}},
    {"cat": "attempt", "dur": 50e3, "args": {"outcome": "ok"}},
    {"cat": "attempt", "dur": 45e3, "args": {"outcome": "superseded"}},
    {"cat": "assembly", "dur": 5e3, "args": {}},
    {"cat": "sched", "dur": 10e3, "args": {}},
    {"cat": "engine", "dur": 30e3, "args": {}},
    {"cat": "serve", "dur": 29e3, "args": {}},
    {"cat": "wire", "dur": 2e3, "args": {}},
    {"cat": "hedge", "dur": 8e3, "args": {}},
]


def test_ring_bound_with_counted_drops(lib, monkeypatch):
    monkeypatch.setenv("MXNET_TRACE", "1")
    monkeypatch.setenv("MXNET_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("MXNET_TRACE_RING", "8")
    lib.tracing.refresh()
    ctx = lib.tracing.mint()
    for i in range(50):
        lib.tracing.record_span("s%d" % i, "replica", 0.0, 0.001, ctx=ctx)
    st = lib.tracing.stats()
    assert (st["buffered"], st["dropped"], st["recorded"],
            st["sampled"]) == (8, 42, 50, 1)
    spans = lib.tracing.publish_drain(64)
    assert [s["name"] for s in spans] == ["s%d" % i for i in range(42, 50)]
    assert lib.tracing.stats()["buffered"] == 0


def test_ring_stays_bounded_under_concurrent_writers(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE", "1")
    monkeypatch.setenv("MXNET_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("MXNET_TRACE_RING", "32")
    p_trc.refresh()
    stop = threading.Event()
    seen = []

    def writer():
        ctx = p_trc.mint()
        while not stop.is_set():
            p_trc.record_span("w", "replica", 0.0, 0.001, ctx=ctx)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        while not seen or p_trc.stats()["dropped"] < 1000:
            seen.append(p_trc.stats()["buffered"])
    finally:
        stop.set()
        for t in threads:
            t.join()
    st = p_trc.stats()
    assert max(seen) <= 32 and st["buffered"] <= 32
    assert st["recorded"] == st["dropped"] + st["buffered"]


def test_clock_skew_agrees():
    args = dict(t_send=100.000, t_recv=100.040, tr_in=110.005,
                tr_out=110.035)
    assert p_trc.clock_skew(**args) == r_trc.clock_skew(**args)
    assert abs(p_trc.clock_skew(**args) - 10.0) < 1e-6


def test_critical_path_of_the_reference_fixture():
    want = r_trc.critical_path([dict(s) for s in SPANS])
    got = p_trc.critical_path([dict(s) for s in SPANS])
    assert got == want
    assert got["dominant"] == "retry" and got["total_us"] == 100e3
    phases = dict(got["phases"])
    assert phases["execute"] == 30e3        # the serve span nests inside
    assert p_trc.render_critical_path(got, "abcd") == \
        r_trc.render_critical_path(want, "abcd")


def test_trace_store_applies_skew_and_drops_duplicates(lib):
    store = lib.tracing.TraceStore(cap=4, exemplars=2)
    span = {"name": "replica::handle", "cat": "replica", "ts": 50e6,
            "dur": 1e3, "tid": "t1", "sid": "s1", "psid": "p1", "args": {}}
    store.ingest([dict(span)], replica="r0", skew_s=10.0)
    store.ingest([dict(span)], replica="r0", skew_s=10.0)
    got = store.get("t1")["spans"]
    assert len(got) == 1 and got[0]["replica"] == "r0"
    assert abs(got[0]["ts"] - 40e6) < 1.0
    # eviction past the cap forgets the oldest trace and its span ids
    for i in range(5):
        store.add({"name": "x", "cat": "fleet", "ts": 0.0, "dur": 1.0,
                   "tid": "e%d" % i, "sid": "z%d" % i, "args": {}})
    assert store.get("t1") is None


def test_store_exemplars_and_explain_agree():
    out = []
    for trc in (r_trc, p_trc):
        store = trc.TraceStore(cap=8, exemplars=2)
        for i, dur in enumerate((5e3, 50e3, 1e3, 20e3)):
            root = {"name": "fleet::request", "cat": "fleet", "ts": 0.0,
                    "dur": dur, "tid": "t%d" % i, "sid": "s%d" % i,
                    "psid": None, "args": {"outcome": "ok"}}
            store.add(dict(root))
            store.finish("t%d" % i, "req%d" % i, root)
        out.append(([e["trace_id"] for e in store.exemplars()],
                    store.explain("req1"), store.chrome("t3")[0]["name"]))
    assert out[0] == out[1]
    assert out[1][0] == ["t1", "t3"]


def test_context_header_wire_and_edge_sampling():
    p_trc.enable(True, sample=1.0)
    ctx = p_trc.mint(deadline=123.0)
    back = p_trc.from_header(ctx.to_header(), deadline=123.0)
    assert (back.trace_id, back.span_id, back.sampled, back.deadline) == \
        (ctx.trace_id, ctx.span_id, True, 123.0)
    assert p_trc.from_wire(ctx.to_wire()).trace_id == ctx.trace_id
    for bad in ("", "nodash", "a-", "-b-1", None):
        assert p_trc.from_header(bad) is None
    p_trc.enable(True, sample=0.0)
    assert not p_trc.mint().sampled
    assert p_trc.from_header("aa-bb-1").sampled
    assert not p_trc.from_header("aa-bb-0").sampled
    p_trc.enable(False)
    assert p_trc.mint() is None
    assert p_trc.record_span("x", "fleet", 0.0, 1.0) is None
    # the header forms agree with the reference's
    r_trc.enable(True, sample=1.0)
    r = r_trc.from_header("feed-beef-1")
    assert r.to_header() == p_trc.TraceContext("feed", "beef",
                                               True).to_header()


def test_heartbeat_trace_section_present_with_activity(lib):
    assert " trace=" not in lib.telemetry.heartbeat_line()
    lib.tracing.enable(True, sample=1.0)
    ctx = lib.tracing.mint()
    lib.tracing.record_span("x", "replica", 0.0, 0.001, ctx=ctx)
    line = lib.telemetry.heartbeat_line()
    section = line[line.index(" trace="):].split()[0]
    assert section == " trace=sampled:1,spans:1,dropped:0,exemplars:0"[1:]


def test_telemetry_refresh_and_reset_reach_tracing(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE", "1")
    p_tele.refresh()
    assert p_trc.active()
    monkeypatch.setenv("MXNET_TRACE", "0")
    assert p_trc.active()                  # cached
    p_tele.refresh()
    assert not p_trc.active()
    p_trc.enable(True, sample=1.0)
    p_trc.record_span("x", "replica", 0.0, 0.001, ctx=p_trc.mint())
    p_tele.reset()
    assert p_trc.stats()["recorded"] == 0


def test_traces_json_in_the_crash_bundle(tmp_path):
    p_trc.enable(True, sample=1.0)
    store = p_trc.TraceStore(cap=8, exemplars=2)
    for i, dur in enumerate((5e3, 50e3, 1e3, 20e3)):
        root = {"name": "fleet::request", "cat": "fleet", "ts": 0.0,
                "dur": dur, "tid": "t%d" % i, "sid": "s%d" % i,
                "psid": None, "args": {"outcome": "ok"}}
        store.add(dict(root))
        store.finish("t%d" % i, "req%d" % i, root)
    path = p_tele.crash_bundle(reason="test", dirpath=str(tmp_path))
    with open(os.path.join(path, "traces.json")) as f:
        doc = json.load(f)
    assert doc["stats"]["exemplars"] == 2
    assert [e["trace_id"] for e in doc["exemplars"]] == ["t1", "t3"]
    assert doc["exemplars"][0]["dominant"] == "other"


def test_dump_chrome_mirrors_into_the_profiler(tmp_path):
    p_trc.enable(True, sample=1.0)
    pt.profiler.set_state("run")
    try:
        store = p_trc.TraceStore(cap=4, exemplars=0)
        store.add({"name": "attempt::solo", "cat": "attempt", "ts": 1.0,
                   "dur": 2.0, "tid": "t", "sid": "a", "psid": "r",
                   "args": {"replica": "r0"}})
        events = json.loads(pt.profiler.dumps())["traceEvents"]
    finally:
        pt.profiler.set_state("stop")
    assert any(e["name"] == "attempt::solo" and e["args"]["trace"] == "t"
               for e in events)
    path = str(tmp_path / "t.json")
    p_trc.dump_chrome(path, store)
    with open(path) as f:
        assert json.load(f)["traceEvents"][0]["args"]["parent"] == "r"


def test_port_scheduler_records_queue_batch_execute_spans():
    """The replica-side spans of a real port Scheduler on its native
    engine: sched::queue, sched::batch and engine::serve.batch in
    disjoint windows, and the session's serve::forward, all under the
    ambient trace."""
    p_trc.enable(True, sample=1.0)
    pt.random.seed(0)
    net = pt.gluon.nn.HybridSequential()
    net.add(pt.gluon.nn.Dense(8, in_units=16))
    net.initialize(init=pt.initializer.Xavier(), ctx=pt.cpu())
    sess = net.serve_session(pt.nd.ones((2, 16), ctx=pt.cpu()), max_batch=4)
    sched = pt.serve.Scheduler(sess, max_wait_ms=0, inflight=2)
    try:
        x = np.ones((2, 16), dtype=np.float32)
        sched.submit(x).result(30)
        ctx = p_trc.mint()
        with p_trc.bind(ctx):
            sched.submit(x).result(30)
        spans = p_trc.take_for(ctx.trace_id)
    finally:
        sched.close()
    by_cat = {s["cat"]: s for s in spans}
    assert set(by_cat) == {"assembly", "sched", "engine", "serve"}
    q, b, e = by_cat["assembly"], by_cat["sched"], by_cat["engine"]
    assert q["ts"] + q["dur"] <= b["ts"] + 1.0
    assert b["ts"] + b["dur"] <= e["ts"] + 1.0
    assert all(s["tid"] == ctx.trace_id for s in spans)
    assert by_cat["serve"]["args"]["warm"] is True
