"""``mxnet_tpu_torch.perfwatch``, its bench-JSON schema
(``mxnet_tpu_torch/tools/bench_json.py``) and its command line
(``mxnet_tpu_torch/tools/perfwatch.py``) against the reference's
``tests/test_perfwatch.py``.

Both packages get the same records, written by the test into
``tmp_path``, and must give the same fingerprints, verdicts, change
points, metric directions, schema answers, corpus files and rendered
trend rows. The port's device kind is the card's name on the card and
``"cpu"`` here; a record carrying its own fingerprint keeps its kind, so
a TPU record never joins an H100 series.
"""
import glob
import json
import os

import pytest

from mxnet_tpu import perfwatch as rpw
from mxnet_tpu import telemetry as rtele
from mxnet_tpu_torch import dist, perfwatch, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_FILES = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json")))
H100 = "NVIDIA H100 80GB HBM3"
H100_DIR = "NVIDIA_H100_80GB_HBM3"        # its directory in the store


@pytest.fixture(autouse=True)
def _clean_perfwatch(monkeypatch):
    for var in ("MXNET_PERF_DB", "MXNET_PERFWATCH", "MXNET_PERFWATCH_TOL",
                "MXNET_PERFWATCH_TOL_OVERRIDES", "MXNET_PERFWATCH_MAD_K",
                "MXNET_PERFWATCH_WINDOW"):
        monkeypatch.delenv(var, raising=False)
    for pw, tele in ((perfwatch, telemetry), (rpw, rtele)):
        pw.refresh()
        tele.reset()
    yield
    for pw, tele in ((perfwatch, telemetry), (rpw, rtele)):
        pw.refresh()
        tele.reset()


def _env(kind="tpu_v4", rev="abc123"):
    return {"device_kind": kind, "git_rev": rev, "flags": {}}


def _rec(value, metric="t_train_throughput", unit="images/sec",
         **extra):
    rec = {"metric": metric, "value": value, "unit": unit}
    rec.update(extra)
    return rec


def _strip(rows):
    """Envelopes without their ingest time (the only field that differs
    between two stores fed the same records)."""
    return [{k: v for k, v in r.items() if k != "ingested_at"}
            for r in rows]


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------
def test_store_roundtrip_atomic_and_idempotent(tmp_path):
    dbs = {}
    for name, mod in (("port", perfwatch), ("ref", rpw)):
        db = mod.PerfDB(str(tmp_path / name))
        fp = db.ingest(_rec(100.0, vs_baseline=0.5), source="t", round=1,
                       env=_env())
        assert fp
        assert db.ingest(_rec(100.0, vs_baseline=0.5), source="t",
                         round=1, env=_env()) is None
        assert db.ingest(_rec(101.0, vs_baseline=0.51), source="t",
                         round=2, env=_env())
        dbs[name] = mod.PerfDB(db.root)      # a fresh handle reads files
    db = dbs["port"]
    assert db.device_kinds() == ["tpu_v4"]
    assert db.metrics("tpu_v4") == ["t_train_throughput"]
    rows = db.records("tpu_v4", "t_train_throughput")
    assert [r["value"] for r in rows] == [100.0, 101.0]
    assert rows[0]["record"]["vs_baseline"] == 0.5
    assert _strip(rows) == _strip(dbs["ref"].records("tpu_v4",
                                                     "t_train_throughput"))
    assert [p for p in glob.glob(os.path.join(db.root, "*", "*"))
            if ".tmp." in p] == []
    path = os.path.join(db.root, "tpu_v4", "t_train_throughput.jsonl")
    with open(path) as f:
        assert len([json.loads(ln) for ln in f if ln.strip()]) == 2
    assert db.series("tpu_v4", "t_train_throughput")[
        "t_train_throughput.vs_baseline"][0][0] == 0.5


def test_fingerprint_partitioning_keeps_kinds_apart(tmp_path):
    """Each device kind is its own series: a TPU record never joins an
    H100 series, whatever its value."""
    scans = []
    for name, mod in (("port", perfwatch), ("ref", rpw)):
        db = mod.PerfDB(str(tmp_path / name))
        for i, v in enumerate([100.0, 101.0, 99.0, 100.5]):
            db.ingest(_rec(v), round=i, env=_env(H100))
        db.ingest(_rec(60.0), round=9, env=_env("TPU v4"))
        assert sorted(db.device_kinds()) == sorted(["TPU_v4",
                                                    H100_DIR])
        rows = mod.scan(db)
        by_kind = {r["device_kind"]: r for r in rows
                   if r["metric"] == "t_train_throughput"}
        assert by_kind[H100_DIR]["n"] == 4
        assert by_kind["TPU_v4"]["n"] == 1
        assert {r["verdict"] for r in by_kind.values()} == {"flat"}
        scans.append(rows)
    assert scans[0] == scans[1]
    # the envelope keeps the kind as it was stamped
    db = perfwatch.PerfDB(str(tmp_path / "port"))
    assert db.records(H100_DIR, "t_train_throughput")[0][
        "env"]["device_kind"] == H100


def test_ingest_file_wrapper_and_glob_idempotent(tmp_path):
    out = {}
    for name, mod in (("port", perfwatch), ("ref", rpw)):
        db = mod.PerfDB(str(tmp_path / name))
        got = db.ingest_glob(os.path.join(REPO, "BENCH_r*.json"))
        assert len(got) == len(BENCH_FILES) >= 5
        assert all(len(fps) == 1 for fps in got.values())
        again = db.ingest_glob(os.path.join(REPO, "BENCH_r*.json"))
        assert all(fps == [] for fps in again.values())
        out[name] = got
    assert out["port"] == out["ref"]
    db = perfwatch.PerfDB(str(tmp_path / "port"))
    kind = db.device_kinds()[0]
    rows = db.records(kind, "resnet50_v1_train_throughput")
    assert [r["round"] for r in rows] == list(range(1, len(BENCH_FILES) + 1))


# ---------------------------------------------------------------------------
# verdicts, change points, directions
# ---------------------------------------------------------------------------
def _judge(values, direction, metric="t"):
    got = perfwatch.judge_series(values, direction, metric=metric)
    assert got == rpw.judge_series(values, direction, metric=metric)
    return got


def test_flat_noise_series_stays_green():
    assert _judge([100.0, 100.5, 99.8, 100.2, 100.1, 99.9], +1)[
        "verdict"] == "flat"
    assert _judge([100, 108, 93, 107, 94, 106, 95, 92.0], +1)[
        "verdict"] == "flat"


def test_regression_and_improvement_verdicts():
    base = [100.0, 100.5, 99.8, 100.2, 100.1]
    down = _judge(base + [90.0], +1)
    assert down["verdict"] == "regressed" and down["delta_rel"] < -0.05
    assert _judge(base + [110.0], +1)["verdict"] == "improved"
    assert _judge(base + [110.0], -1, "t_ms")["verdict"] == "regressed"
    assert _judge([100.0, 100.01, 99.99, 100.0, 98.0], +1)[
        "verdict"] == "flat"
    assert _judge(base + [50.0], 0, "mystery")["verdict"] == "flat"


def test_per_metric_tolerance_overrides(monkeypatch):
    vals = [100.0, 100.5, 99.8, 100.2, 100.1, 93.0]
    assert _judge(vals, +1)["verdict"] == "regressed"
    monkeypatch.setenv("MXNET_PERFWATCH_TOL_OVERRIDES", "t=0.10")
    assert _judge(vals, +1)["verdict"] == "flat"
    assert _judge(vals, +1, "t.vs_baseline")["verdict"] == "flat"
    monkeypatch.setenv("MXNET_PERFWATCH_TOL_OVERRIDES",
                       "t=0.10,t.vs_baseline=0.01")
    assert _judge(vals, +1, "t.vs_baseline")["verdict"] == "regressed"
    monkeypatch.setenv("MXNET_PERFWATCH_MAD_K", "50")
    monkeypatch.setenv("MXNET_PERFWATCH_WINDOW", "3")
    assert _judge(vals, +1, "t.vs_baseline")["verdict"] == "flat"


def test_change_point_localization():
    cases = [([10.0] * 4 + [8.5] * 4, -1), ([10.0] * 4 + [8.5] * 4, +1),
             ([10.0, 10.1, 9.9, 10.05, 9.95, 10.0], +1),
             ([2337.52, 2752.49, 2846.83, 2780.09, 2789.14], +1),
             ([1.0, 2.0, 3.0], +1), ([5.0, 5.0, 9.0, 9.0, 5.0, 5.0], 0)]
    got = [perfwatch.change_point(v, d) for v, d in cases]
    assert got == [rpw.change_point(v, d) for v, d in cases]
    assert got[0]["index"] == 4 and got[0]["kind"] == "improvement"
    assert got[1]["kind"] == "regression"
    assert got[2] is None and got[4] is None
    assert got[3]["index"] == 1 and got[3]["kind"] == "improvement"


def test_metric_direction_rules():
    cases = [("t", "images/sec/chip"), ("serve_throughput", "req/s"),
             ("kernel_micro_worst_paired_median_ratio", "candidate/twin"),
             ("comm_micro_disabled_overhead", "disabled/stripped"),
             ("x.p99_ms", ""), ("x.mfu", ""), ("x.steady_recompiles", ""),
             ("x.grad_noise_scale", ""), ("autotune_layer_norm_fwd", "ms"),
             ("phase27.kernels.dropout.tuned_ms", ""), ("tflops", "")]
    got = [perfwatch.metric_direction(n, u) for n, u in cases]
    assert got == [rpw.metric_direction(n, u) for n, u in cases]
    assert got[:8] == [1, 1, -1, -1, -1, 1, -1, 0]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def _cli_rows(out):
    """The trend table's rows (the header names the store's root)."""
    return [ln for ln in out.splitlines()[1:] if ln.strip()]


def test_report_renders_like_the_reference(capsys):
    """Over the same files both command lines gate green and render the
    same rows, the r01 -> r02 shift localized."""
    import mxnet_tpu_torch.tools.perfwatch as ppw
    import tools.perfwatch as rcli
    assert ppw.main(["report", "--gate"] + BENCH_FILES) == 0
    port = capsys.readouterr().out
    assert rcli.main(["report", "--gate"] + BENCH_FILES) == 0
    ref = capsys.readouterr().out
    assert "PERFWATCH_GATE_OK" in port and "improvement@r02" in port
    assert _cli_rows(port) == _cli_rows(ref)
    # with no store and no files the port's report is an empty table
    assert ppw.main(["report", "--gate"]) == 0
    assert "empty store" in capsys.readouterr().out


def test_gate_trips_on_injected_regression(tmp_path, capsys):
    import mxnet_tpu_torch.tools.perfwatch as ppw
    for p in BENCH_FILES:
        with open(p) as f:
            w = json.load(f)
        with open(tmp_path / os.path.basename(p), "w") as f:
            json.dump(w, f)
    with open(BENCH_FILES[-1]) as f:
        w = json.load(f)
    parsed = dict(w["parsed"])
    parsed["value"] = round(parsed["value"] * 0.9, 2)
    parsed.pop("sharded_train_step_img_s", None)
    with open(tmp_path / "BENCH_r99.json", "w") as f:
        json.dump({"n": len(BENCH_FILES) + 1, "cmd": w["cmd"], "rc": 0,
                   "tail": "", "parsed": parsed}, f)
    rc = ppw.main(["report", "--gate", str(tmp_path / "BENCH_r*.json")])
    out = capsys.readouterr().out
    assert rc == 1
    assert "PERFWATCH REGRESSION: resnet50_v1_train_throughput" in out
    snap = telemetry.snapshot()
    assert any(k.startswith("mx_perf_regressions_total")
               and "resnet50_v1_train_throughput" in k
               for k in snap["counters"])
    assert "perf=" in telemetry.heartbeat_line()


def test_ingest_and_report_persistent_store(tmp_path, capsys):
    import mxnet_tpu_torch.tools.perfwatch as ppw
    db_dir = str(tmp_path / "db")
    assert ppw.main(["ingest", os.path.join(REPO, "BENCH_r*.json"),
                     "--db", db_dir]) == 0
    assert ppw.main(["report", "--gate", "--db", db_dir, "--json"]) == 0
    out = capsys.readouterr().out
    assert "PERFWATCH_GATE_OK" in out
    rows = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("[")][0])
    assert {r["verdict"] for r in rows} <= {"flat", "improved"}
    assert ppw.main(["ingest", "nothing*.json"]) == 2     # no store


# ---------------------------------------------------------------------------
# the emit seam
# ---------------------------------------------------------------------------
def test_maybe_record_seam_gating(tmp_path, monkeypatch):
    rec = _rec(100.0, env=_env())
    assert perfwatch.maybe_record(rec) is None
    monkeypatch.setenv("MXNET_PERF_DB", str(tmp_path))
    perfwatch.refresh()
    assert perfwatch.maybe_record(rec, source="t")
    monkeypatch.setenv("MXNET_PERFWATCH", "0")
    perfwatch.refresh()
    assert perfwatch.maybe_record(_rec(101.0, env=_env())) is None
    # cached until refresh; telemetry.refresh() chains to it
    monkeypatch.setenv("MXNET_PERFWATCH", "1")
    assert perfwatch.maybe_record(_rec(102.0, env=_env())) is None
    telemetry.refresh()
    assert perfwatch.maybe_record(_rec(102.0, env=_env()))


def test_emit_records_and_prints_one_line(tmp_path, monkeypatch, capsys):
    from mxnet_tpu_torch.tools import bench_json
    monkeypatch.setenv("MXNET_PERF_DB", str(tmp_path))
    perfwatch.refresh()
    out_rec = bench_json.emit(_rec(123.0), source="t")
    line = capsys.readouterr().out.strip()
    assert json.loads(line) == out_rec
    assert out_rec["env"]["device_kind"] == "cpu"
    db = perfwatch.PerfDB(str(tmp_path))
    assert db.device_kinds() == ["cpu"]
    assert db.records("cpu", "t_train_throughput")[0]["value"] == 123.0


def test_environment_fingerprint_matches_the_references(monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    monkeypatch.setenv("MXNET_PERF_DB", "/nowhere")
    fp = perfwatch.environment_fingerprint()
    ref = rpw.environment_fingerprint()
    assert set(fp) == set(ref) == {"device_kind", "git_rev", "flags"}
    assert fp["device_kind"] == ref["device_kind"] == "cpu"
    assert fp["git_rev"] == ref["git_rev"]
    assert fp["flags"] == ref["flags"]
    assert fp["flags"]["MXNET_AUTOTUNE"] == "cost"
    assert not any(k.startswith("MXNET_PERF") for k in fp["flags"])


# ---------------------------------------------------------------------------
# the bench-JSON schema
# ---------------------------------------------------------------------------
def test_bench_json_schema_accepts_and_rejects():
    from mxnet_tpu_torch.tools import bench_json
    import tools.bench_json as rbj
    cases = [_rec(1.0), {"metric": "x"}, _rec(float("nan")), _rec(True),
             _rec(1.0, metric="Bad-Name"), _rec(1.0, unit=""),
             _rec(1.0, env={"nope": 1}), [1, 2], _rec(1, extra={1, 2})]
    got = [bench_json.validate(c) for c in cases]
    assert got == [rbj.validate(c) for c in cases]
    assert got[0] == [] and all(got[1:])
    with pytest.raises(ValueError, match="schema violation"):
        bench_json.check({"metric": "x"})
    with pytest.raises(ValueError):
        bench_json.emit({"metric": "x"})


def test_checked_in_history_validates_and_parses_clean():
    from mxnet_tpu_torch.tools import bench_json
    assert len(BENCH_FILES) >= 5
    for p in BENCH_FILES:
        with open(p) as f:
            w = json.load(f)
        assert bench_json.validate(w["parsed"]) == [], p
        tail_rec = bench_json.last_json_line(w.get("tail", ""))
        if tail_rec is not None:
            assert tail_rec["metric"] == w["parsed"]["metric"]
            assert tail_rec["value"] == w["parsed"]["value"]
    assert bench_json.last_json_line('x\n{"a": 1}\nnot {json}\n{"b": 2}') \
        == {"b": 2}


def test_port_emitters_use_the_schema():
    """The port's tools that print a record do it through its own
    bench_json, and their headline records are gateable ratios."""
    from mxnet_tpu_torch.tools import bench_json
    src = open(os.path.join(REPO, "mxnet_tpu_torch", "tools",
                            "perfwatch.py")).read()
    assert "bench_json.emit" in src
    for rec in ({"metric": "perfwatch_micro_disabled_overhead",
                 "value": 1.01, "unit": "disabled/stripped"},
                {"metric": "autotune_paired_median_ratio", "value": 0.97,
                 "unit": "tuned/default"}):
        assert bench_json.validate(rec) == []
        assert perfwatch.metric_direction(rec["metric"], rec["unit"]) == -1


# ---------------------------------------------------------------------------
# the autotune corpus
# ---------------------------------------------------------------------------
PHASE_REC = {
    "metric": "autotune_paired_median_ratio", "value": 0.98,
    "unit": "tuned/default",
    "kernels": {
        "layer_norm_fwd": {"candidate_ms": 0.0123, "default_ms": 0.0126},
        "bias_gelu_bwd": {"candidate_ms": 0.041, "default_ms": 0.043}},
    "autotune": "measure",
    "autotune_table": {
        H100 + "|layer_norm_fwd|C=768,M=4096,aligned=1,esize=2":
            {"blocks": 264},
        H100 + "|bias_gelu_bwd|C=3072,M=4096,aligned=1,esize=2":
            {"strips": 132}},
}


def test_autotune_corpus_export_shape(tmp_path):
    out = {}
    for name, mod in (("port", perfwatch), ("ref", rpw)):
        db = mod.PerfDB(str(tmp_path / name))
        db.ingest(PHASE_REC, source="chip_smoke", round=1, env=_env(H100))
        exported = mod.export_autotune_corpus(db)
        assert list(exported) == [H100_DIR]
        path, n = exported[H100_DIR]
        assert n == 2
        with open(path) as f:
            out[name] = json.load(f)
    assert out["port"] == out["ref"]
    entry = out["port"][H100 + "|layer_norm_fwd|C=768,M=4096,aligned=1,"
                               "esize=2"]
    assert entry["params"] == {"blocks": 264}
    assert entry["features"] == {"C": 768, "M": 4096, "aligned": 1,
                                 "esize": 2}
    assert entry["measured_ms"] == 0.0123
    assert entry["mode"] == "measure"


def test_autotune_loads_corpus_unmodified(tmp_path, monkeypatch):
    from mxnet_tpu_torch import autotune
    db = perfwatch.PerfDB(str(tmp_path / "db"))
    db.ingest(PHASE_REC, source="chip_smoke", round=1, env=_env(H100))
    path, _ = perfwatch.export_autotune_corpus(db)[H100_DIR]
    with open(path) as f:
        corpus = json.load(f)
    cache = tmp_path / "cache.json"
    with open(cache, "w") as f:
        json.dump({k.replace(H100, "cpu"): v for k, v in corpus.items()}, f)
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", str(cache))
    autotune.clear()
    try:
        key = {"M": 4096, "C": 3072, "esize": 2, "aligned": 1}
        assert autotune.lookup("bias_gelu_bwd", key, {"strips": 44}) == \
            {"strips": 132}
        assert autotune.lookup("bias_gelu_bwd", key, {"strips": 44},
                               validate=lambda p: False) == {"strips": 44}
    finally:
        autotune.clear()


# ---------------------------------------------------------------------------
# fleet sharing and the heartbeat
# ---------------------------------------------------------------------------
def test_fleet_publish_and_merge_idempotent(tmp_path):
    db = perfwatch.PerfDB(str(tmp_path / "a"))
    for i, v in enumerate([100.0, 101.0]):
        db.ingest(_rec(v), round=i, env=_env(H100))
    kv = dist.KV(dist.LocalKV())
    assert perfwatch.publish_fleet(db, kv) == 1
    assert list(kv.dir_get("mx/perf/")) == [
        "mx/perf/%s/t_train_throughput" % H100_DIR]
    other = perfwatch.PerfDB(str(tmp_path / "b"))
    assert perfwatch.merge_fleet(other, kv) == 1
    assert perfwatch.merge_fleet(other, kv) == 0
    rows = other.records(H100_DIR, "t_train_throughput")
    assert len(rows) == 1 and rows[0]["value"] == 101.0
    assert rows[0]["env"]["device_kind"] == H100


def test_heartbeat_perf_section_read_only(tmp_path, monkeypatch):
    before = len(telemetry.snapshot()["counters"])
    assert "perf=" not in telemetry.heartbeat_line()
    assert len(telemetry.snapshot()["counters"]) == before
    monkeypatch.setenv("MXNET_PERF_DB", str(tmp_path))
    perfwatch.refresh()
    perfwatch.maybe_record(_rec(100.0, env=_env()), source="t")
    assert "perf=ingested:1,regressions:0" in telemetry.heartbeat_line()
