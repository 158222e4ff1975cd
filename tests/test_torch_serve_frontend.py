"""The port's HTTP Frontend (``serve/frontend.py``) against the
reference's, each on its own package's Router and a thread-backed
replica: ``/v1/infer`` plain and streamed, ``/v1/health``, ``/v1/fleet``,
``/metrics`` with the replicas' ``replica=`` series, ``/v1/trace/<id>``
(and its 404), the ``x-mxnet-trace`` header, and typed sheds answered
429, 504 and 503 with ``Retry-After`` and the reference's JSON error
body. Every socket binds 127.0.0.1:0.
"""
import http.client
import json
import time
import types

import numpy as np
import pytest

import mxnet_tpu_torch as pt
from mxnet_tpu import dist as r_dist
from mxnet_tpu import faultinject as r_fi
from mxnet_tpu import telemetry as r_tele
from mxnet_tpu import tracing as r_trc
from mxnet_tpu.serve import fleet as r_fleet
from mxnet_tpu.serve import frontend as r_front
from mxnet_tpu.serve import tenancy as r_ten
from mxnet_tpu_torch import dist as p_dist
from mxnet_tpu_torch import faultinject as p_fi
from mxnet_tpu_torch import telemetry as p_tele
from mxnet_tpu_torch import tracing as p_trc
from mxnet_tpu_torch.serve import fleet as p_fleet
from mxnet_tpu_torch.serve import frontend as p_front
from mxnet_tpu_torch.serve import tenancy as p_ten

from test_torch_serve_fleet import HB, MISS_K, X, ToyScheduler

PKGS = {
    "ref": types.SimpleNamespace(dist=r_dist, fi=r_fi, tele=r_tele,
                                 trc=r_trc, fleet=r_fleet, front=r_front,
                                 ten=r_ten),
    "port": types.SimpleNamespace(dist=p_dist, fi=p_fi, tele=p_tele,
                                  trc=p_trc, fleet=p_fleet, front=p_front,
                                  ten=p_ten),
}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("MXNET_TRACE", "MXNET_TRACE_SAMPLE", "MXNET_TELEMETRY"):
        monkeypatch.delenv(var, raising=False)
    for ns in PKGS.values():
        ns.fi.clear()
        ns.trc.refresh()
        ns.trc.reset()
    yield
    for ns in PKGS.values():
        ns.fi.clear()
        ns.trc.enable(False)
        ns.trc.reset()
        ns.tele.refresh()


class _Stack:
    def __init__(self, ns, sched=None):
        self.ns = ns
        kv = ns.dist.KV(ns.dist.LocalKV())
        self.sched = sched or ToyScheduler()
        self.server = ns.fleet.ReplicaServer(self.sched, "r0", kv=kv,
                                             heartbeat_s=HB, miss_k=MISS_K)
        self.router = ns.fleet.Router(kv=kv, heartbeat_s=HB, miss_k=MISS_K,
                                      retries=0)
        self.router.refresh()
        self.fe = ns.front.Frontend(self.router).serve_in_thread()
        assert self.fe.addr[0] == "127.0.0.1"
        self.conn = http.client.HTTPConnection(*self.fe.addr, timeout=10)

    def post(self, body, headers=None, path="/v1/infer"):
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        self.conn.request("POST", path, json.dumps(body), hdrs)
        resp = self.conn.getresponse()
        return resp, resp.read()

    def get(self, path):
        self.conn.request("GET", path)
        resp = self.conn.getresponse()
        return resp, resp.read()

    def close(self):
        self.conn.close()
        self.fe.stop()
        self.router.close()
        self.server.close()


@pytest.fixture()
def stack():
    s = _Stack(PKGS["port"])
    yield s
    s.close()


@pytest.fixture()
def both():
    stacks = {k: _Stack(ns) for k, ns in PKGS.items()}
    yield stacks
    for s in stacks.values():
        s.close()


def test_infer_plain(stack):
    resp, raw = stack.post({"inputs": [X.tolist()], "tenant": "paid"})
    body = json.loads(raw)
    assert resp.status == 200
    np.testing.assert_array_equal(body["outputs"][0], (X * 2.0).tolist())
    assert body["replica"] == "r0" and body["id"]
    assert "trace_id" not in body


def test_infer_streamed(stack):
    resp, raw = stack.post({"inputs": [X.tolist()], "stream": True})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "application/x-ndjson"
    assert resp.getheader("Transfer-Encoding") == "chunked"
    lines = [json.loads(ln) for ln in raw.decode().strip().splitlines()]
    assert lines[-1] == {"done": True}
    np.testing.assert_array_equal(lines[0]["outputs"][0],
                                  (X * 2.0).tolist())
    assert lines[0]["replica"] == "r0"


def test_health_fleet_and_metrics_with_replica_labels(stack, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    p_tele.refresh()
    stack.post({"inputs": [X.tolist()]})
    resp, raw = stack.get("/v1/health")
    health = json.loads(raw)
    assert resp.status == 200
    assert health == {"ok": True, "replicas_live": 1, "stale": False}
    resp, raw = stack.get("/v1/fleet")
    table = json.loads(raw)
    assert table["replicas"]["r0"]["alive"]
    assert table["replicas"]["r0"]["breaker"] == "closed"
    t_dead = time.time() + 10
    while True:
        resp, raw = stack.get("/metrics")
        text = raw.decode()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/plain")
        if 'replica="r0"' in text and "mx_fleet_requests_total" in text:
            break
        assert time.time() < t_dead, text
        time.sleep(0.05)
    assert 'mx_fleet_replica_liveness{replica="r0"} 1' in text


def test_metrics_fall_back_to_the_router_series(stack, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    p_tele.refresh()

    def broken(router):
        raise ConnectionError("aggregation broke")

    monkeypatch.setattr(p_fleet, "render_replica_metrics", broken)
    p_fi.set_fault("kv_flap", 1.0, max_fires=1)
    stack.router.refresh()
    resp, raw = stack.get("/metrics")
    assert resp.status == 200
    assert "mx_fleet_routing_stale 1" in raw.decode()


def test_trace_endpoint_header_and_404(stack):
    p_trc.enable(True, sample=1.0)
    resp, raw = stack.post({"inputs": [X.tolist()]},
                           {"x-mxnet-trace": "feedc0de" * 2 + "-12345678-1"})
    body = json.loads(raw)
    assert resp.status == 200 and body["trace_id"] == "feedc0de" * 2
    echo = resp.getheader("x-mxnet-trace")
    assert echo.startswith("feedc0de" * 2 + "-") and echo.endswith("-1")
    t_dead = time.time() + 10
    while True:
        resp, raw = stack.get("/v1/trace/" + body["id"])
        if resp.status == 200 and json.loads(raw)["complete"]:
            break
        assert time.time() < t_dead
        time.sleep(0.02)
    doc = json.loads(raw)
    assert doc["trace_id"] == "feedc0de" * 2
    cats = {s["cat"] for s in doc["spans"]}
    assert {"fleet", "attempt", "wire", "replica"} <= cats
    assert doc["critical_path"]["dominant"] != "none"
    resp, raw = stack.get("/v1/trace/unknown123")
    assert resp.status == 404
    assert json.loads(raw)["error"]["code"] == "error"
    # an unsampled caller stays unsampled
    resp, raw = stack.post({"inputs": [X.tolist()]},
                           {"x-mxnet-trace": "aa-bb-0"})
    assert resp.status == 200 and "trace_id" not in json.loads(raw)
    assert resp.getheader("x-mxnet-trace") == "aa-bb-0"


@pytest.mark.parametrize("code,status,retry_after", [
    ("overload", 429, "1"), ("drain", 503, "1"), ("timeout", 504, None)])
def test_typed_sheds_as_the_reference_answers_them(both, code, status,
                                                  retry_after):
    seen = {}
    for name, s in both.items():
        s.sched.fail = s.ns.ten.OverloadError("shed " + code, code=code,
                                              tenant="paid")
        resp, raw = s.post({"inputs": [X.tolist()], "tenant": "paid"})
        seen[name] = (resp.status, resp.getheader("Retry-After"),
                      resp.getheader("Content-Type"), json.loads(raw))
    assert seen["port"] == seen["ref"]
    st, retry, _, body = seen["port"]
    assert (st, retry) == (status, retry_after)
    assert body == {"error": {"code": code, "message": "shed " + code,
                              "tenant": "paid"}}


def test_untyped_errors_and_bad_requests_as_the_reference(both):
    seen = {}
    for name, s in both.items():
        s.sched.fail = RuntimeError("kernel exploded")
        out = []
        resp, raw = s.post({"inputs": [X.tolist()]})
        out.append((resp.status, json.loads(raw)))
        resp, raw = s.post({"not_inputs": 1})
        out.append((resp.status, json.loads(raw)["error"]["code"]))
        resp, raw = s.get("/nope")
        out.append((resp.status, json.loads(raw)))
        seen[name] = out
    assert seen["port"] == seen["ref"]
    assert seen["port"][0][0] == 500 and seen["port"][1][0] == 400
    assert "kernel exploded" in seen["port"][0][1]["error"]["message"]


def test_served_bert_through_the_frontend(monkeypatch):
    """A small port BERT behind a real Scheduler, a replica, the Router
    and the Frontend: the HTTP answer equals the Router's."""
    from test_torch_bert_serve import KW
    pt.random.seed(0)
    net = pt.gluon.model_zoo.bert.BERTModel(dropout=0.0, **KW)
    net.initialize(ctx=pt.cpu())
    ids = np.random.RandomState(1).randint(0, 100, (1, 8)).astype(np.float32)
    tok = np.zeros_like(ids)
    sess = net.serve_session(pt.nd.array(ids, ctx=pt.cpu()),
                             pt.nd.array(tok, ctx=pt.cpu()), seq_axis=1,
                             max_batch=2, max_seq=16)
    sched = pt.serve.Scheduler(sess, max_wait_ms=1, inflight=2)
    s = _Stack(PKGS["port"], sched=sched)
    try:
        direct = s.router.infer(ids, tok)
        resp, raw = s.post({"inputs": [ids.tolist(), tok.tolist()]})
        body = json.loads(raw)
        assert resp.status == 200 and len(body["outputs"]) == 4
        for got, want in zip(body["outputs"], direct):
            np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    finally:
        s.close()
        sched.close()
