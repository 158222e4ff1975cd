"""The eager half of commwatch (``mxnet_tpu_torch/commwatch.py``) against
the reference's ``mxnet_tpu/commwatch.py`` on the same ``record`` and
``comm_span`` calls: the gates, the bus factors, the metric series and
their labels, ``report``, ``report_key``, ``comm_totals`` and
``render_report``. With the seconds given, every number is
deterministic and must agree exactly; a ``comm_span`` times itself, so
its rows agree in everything but the seconds.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

LIBS = (mx, pt)


@pytest.fixture(autouse=True)
def _telemetry(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    for lib in LIBS:
        lib.telemetry.refresh()
        lib.telemetry.reset()
    yield monkeypatch
    monkeypatch.delenv("MXNET_TELEMETRY")
    for lib in LIBS:
        lib.telemetry.refresh()
        lib.telemetry.reset()


def _both(fn):
    return fn(mx), fn(pt)


def _series(lib):
    snap = lib.telemetry.snapshot()
    out = {}
    for kind in ("counters", "gauges"):
        for k, v in snap[kind].items():
            if k.startswith("mx_comm_"):
                out[k] = v
    for k, h in snap["histograms"].items():
        if k.startswith("mx_comm_"):
            out[k] = (h["count"], h["sum"])
    return out


def _calls(lib):
    cw = lib.commwatch
    cw.record("allreduce", "kv", 4096, 4, seconds=0.002, exposed=True)
    cw.record("allreduce", "kv.dcn", 1 << 20, 2, seconds=0.01)
    with cw.exposed_region():
        cw.record("allreduce", "kv.dcn", 1 << 20, 2, seconds=0.02)
    cw.record("allgather", ("dp", "tp"), 300, 8, seconds=0.001,
              exposed=False, count=3)
    cw.record("reduce_scatter", "dp", 512, 8)
    cw.record("all_to_all", "ep", 64, 4, seconds=0.5, dtype="int8")


@pytest.mark.parametrize("n", [1, 2, 3, 8, 256])
def test_bus_factors(n):
    assert sorted(pt.commwatch.BUS_FACTORS) == \
        sorted(mx.commwatch.BUS_FACTORS)
    for op, f in mx.commwatch.BUS_FACTORS.items():
        assert pt.commwatch.BUS_FACTORS[op](n) == f(n)


def test_record_series_and_labels_match():
    _both(_calls)
    ref, port = _series(mx), _series(pt)
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k], v, rtol=1e-12, err_msg=k)


def test_report_totals_and_render_match():
    _both(_calls)
    ref, port = mx.commwatch.report(), pt.commwatch.report()
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    for p, r in zip(port, ref):
        for k, v in r.items():
            if isinstance(v, float):
                np.testing.assert_allclose(p[k], v, rtol=1e-12, err_msg=k)
            else:
                assert p[k] == v, k
    assert [pt.commwatch.report_key(r) for r in port] == \
        [mx.commwatch.report_key(r) for r in ref]
    assert pt.commwatch.comm_totals() == pytest.approx(
        mx.commwatch.comm_totals(), rel=1e-12)
    assert pt.commwatch.render_report(ref) == mx.commwatch.render_report(ref)
    assert pt.commwatch.render_report().splitlines()[0] == \
        mx.commwatch.render_report().splitlines()[0]


def test_comm_span_records_like_the_reference():
    def run(lib):
        with lib.commwatch.comm_span("allreduce", "kv", 1000, 2,
                                     key="3 keys"):
            pass
        with lib.commwatch.exposed_region():
            with lib.commwatch.comm_span("allreduce", "kv.dcn", 10, 2):
                pass
        return [{k: r[k] for k in ("op", "axis", "ops", "bytes",
                                   "bus_bytes")}
                for r in lib.commwatch.report()], \
            sorted(k for k in _series(lib))
    ref, port = _both(run)
    assert port == ref
    rows = {r["axis"]: r for r in pt.commwatch.report()}
    assert rows["kv.dcn"]["exposed_s"] > 0
    assert rows["kv"]["overlapped_s"] > 0 and rows["kv"]["exposed_s"] == 0


def test_gates(monkeypatch):
    for lib in LIBS:
        assert lib.commwatch.enabled()
    monkeypatch.setenv("MXNET_COMMWATCH", "0")
    for lib in LIBS:
        assert lib.commwatch.enabled()          # cached until refresh
        lib.telemetry.refresh()
        assert not lib.commwatch.enabled()
        lib.commwatch.record("allreduce", "kv", 8, 2, seconds=1.0)
        assert lib.commwatch.report() == []
    monkeypatch.setenv("MXNET_COMMWATCH", "1")
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    for lib in LIBS:
        lib.telemetry.refresh()
        assert not lib.commwatch.enabled()


@pytest.mark.parametrize("dtype", ["int8", "uint8", "float8_e4m3fn",
                                   "float32", "bfloat16", None])
def test_wire_dtype_label(dtype):
    assert pt.commwatch.wire_dtype_label(dtype) == \
        mx.commwatch.wire_dtype_label(dtype)


def test_fleet_stats_carry_the_comm_totals():
    _both(_calls)
    ref = mx.telemetry.local_fleet_stats()
    port = pt.telemetry.local_fleet_stats()
    for k in ("comm_seconds", "exposed_comm_seconds", "comm_bytes"):
        assert port[k] == pytest.approx(ref[k], rel=1e-12)
    assert port["comm_bytes"] > 0
