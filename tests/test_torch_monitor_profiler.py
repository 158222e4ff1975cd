"""``Monitor`` and ``profiler`` in the port against the reference's.

Monitor: the per-op statistics of an eager MLP's forward (the op names,
their order and ``mean(|x|)`` of each output within 1e-5 relative, f32),
the ``mx_monitor_stat`` gauges, the guard events in the queue, the
modelwatch mode's rows, and a failing statistic uninstalling the spy.

Profiler: the chrome-trace dump's schema (the keys of every event kind,
``dumps``/``dump`` with ``reset``, the atomic write), the trace counter
and marker, and the merge of a device trace: kernel events moved to the
host clock's origin by the ``cudaEventRecord`` anchor, under a pid of
their own.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

from test_torch_telemetry import _Null, _both, _mlp, _reset_all, _weights


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    _reset_all()
    yield
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    _reset_all()


def _x(lib, seed=0):
    a = np.random.RandomState(seed).randn(3, 8).astype(np.float32)
    return lib.nd.array(a, ctx=lib.cpu()) if lib is pt else lib.nd.array(a)


def _eager_mlp(lib):
    scope = pt.cpu() if lib is pt else _Null()
    with scope:
        net = _mlp(lib, _weights())
    net.hybridize(active=False)
    return net


def test_monitor_per_op_stats_match_reference():
    def run(lib):
        net = _eager_mlp(lib)
        mon = lib.monitor.Monitor(pattern="FullyConnected|Activation")
        with mon:
            net(_x(lib))
            rows = list(mon.queue)
        gauges = {k: v for k, v in lib.telemetry.snapshot()["gauges"].items()
                  if k.startswith("mx_monitor_stat")}
        return rows, gauges
    ref, got = _both(run)
    assert [(s, n) for s, n, _ in got[0]] == [(s, n) for s, n, _ in ref[0]]
    assert [n for _, n, _ in got[0]] == [
        "FullyConnected_output0", "Activation_output0",
        "FullyConnected_output0"]
    np.testing.assert_allclose([v for _, _, v in got[0]],
                               [v for _, _, v in ref[0]], rtol=1e-5)
    assert sorted(got[1]) == sorted(ref[1])


def test_monitor_tic_toc_interval_and_guard_tap():
    def run(lib):
        net = _eager_mlp(lib)
        mon = lib.monitor.Monitor(interval=2, pattern="FullyConnected",
                                  sort=True)
        mon.install()
        out = []
        try:
            for _ in range(3):
                mon.tic()
                net(_x(lib))
                lib.guardrails.emit("clip", norm=1.0)
                out.append([(s, n) for s, n, _ in mon.toc()])
        finally:
            mon.uninstall()
        return out
    ref, got = _both(run)
    assert got == ref
    assert got[1] == [] and ("guard_clip" in [n for _, n in got[0]])


def test_monitor_failing_stat_restores_invoke():
    from mxnet_tpu_torch.ndarray import ndarray as nd_impl
    orig = nd_impl.invoke
    net = _eager_mlp(pt)

    def bad(x):
        raise RuntimeError("stat failed")
    mon = pt.monitor.Monitor(stat_func=bad)
    mon.install()
    mon.tic()
    with pytest.raises(RuntimeError, match="stat failed"):
        net(_x(pt))
    assert nd_impl.invoke is orig


def test_monitor_modelwatch_mode(monkeypatch):
    monkeypatch.setenv("MXNET_MODELWATCH", "1")
    from test_torch_modelwatch import _train

    def run(lib):
        mon = lib.monitor.Monitor(modelwatch=True, pattern=".*dense1.*")
        mon.install()
        mon.tic()
        _train(lib, steps=2)
        rows = mon.toc()
        mon.uninstall()
        return rows
    ref, got = _both(run)
    assert [n for _, n, _ in got] == [n for _, n, _ in ref]
    assert "mw_mlp_dense1_weight_grad_norm" in [n for _, n, _ in got]
    np.testing.assert_allclose([v for _, _, v in got],
                               [v for _, _, v in ref], rtol=1e-5)


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------
def _events(lib):
    lib.profiler.set_state("run")
    with lib.profiler.scope("user_region"):
        pass
    t = lib.profiler.Task("task_a")
    t.start()
    t.stop()
    c = lib.profiler.Counter("ctr", value=1)
    c.increment(2)
    c.decrement()
    c.set_value(7)
    lib.profiler.Marker("mark").mark()
    lib.profiler.record_event("ev", "cat", 1.0, 2.0, {"a": 1})
    lib.profiler.set_state("stop")
    lib.profiler.record_event("after_stop", "cat", 1.0, 2.0)
    return json.loads(lib.profiler.dumps())["traceEvents"]


def test_dump_schema_matches_reference():
    ref, got = _both(_events)
    key = lambda evs: [(e["name"], e["ph"], sorted(e)) for e in evs]
    assert key(got) == key(ref)
    assert [e["args"]["value"] for e in got if e["ph"] == "C"] == \
        [3, 2, 7]
    assert got[-1]["args"] == {"a": 1}


def test_dump_atomic_with_reset(tmp_path):
    def run(lib):
        path = str(tmp_path / ("%s.json" % lib.__name__))
        lib.profiler.set_config(filename=path)
        _events(lib)
        lib.profiler.dump(reset=True)
        with open(path) as f:
            first = json.load(f)
        assert json.loads(lib.profiler.dumps()) == {"traceEvents": []}
        leftovers = [n for n in os.listdir(tmp_path) if ".tmp." in n]
        return sorted(first), len(first["traceEvents"]), leftovers
    ref, got = _both(run)
    assert got == ref
    assert got[2] == []


class _FakeProf:
    """Stands in for torch.profiler.profile: exports a trace whose clock
    starts at 1000 us, with the anchor's runtime call and two kernels."""

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": [
                {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventRecord",
                 "ts": 1000.0, "dur": 2.0, "pid": 1, "tid": 1},
                {"ph": "X", "cat": "kernel", "name": "layer_norm_fwd_k",
                 "ts": 1010.0, "dur": 5.0, "pid": 0, "tid": 7,
                 "args": {"stream": 7, "correlation": 5}},
                {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
                 "ts": 1020.0, "dur": 1.0, "pid": 0, "tid": 7,
                 "args": {"stream": 7}},
                {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": 1012.0, "dur": 1.0, "pid": 1, "tid": 1,
                 "args": {"correlation": 5}}]}, f)


def test_device_trace_merges_on_the_host_clock():
    """The anchor (the end of the cudaEventRecord call, 1002 us on the
    trace's clock) moves the trace onto the host clock; the kernel that
    the trace has starting 2 us before its launch call moves every
    device event 2 us later."""
    prof = pt.profiler
    prof.set_state("run")
    prof._DEVICE["prof"], prof._DEVICE["anchor"] = _FakeProf(), 5000.0
    prof.set_state("stop")
    dev = prof.device_events()
    assert prof.device_clock_shift() == 2.0
    assert [(e["name"], e["cat"], e["ts"], e["dur"]) for e in dev] == [
        ("layer_norm_fwd_k", "device::kernel", 5010.0, 5.0),
        ("Memcpy HtoD", "device::gpu_memcpy", 5020.0, 1.0)]
    assert {e["pid"] for e in dev} == {os.getpid() + 1}
    assert all("clock" not in e["args"] for e in dev)
    prof.dumps(reset=True)
