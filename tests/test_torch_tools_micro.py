"""The port's observability tools (``mxnet_tpu_torch/tools``:
``telemetry_micro``, ``compile_micro``, ``modelwatch_micro``,
``trace_summary``, ``compile_report`` and ``perfwatch``) run at toy sizes
on the CPU, each with the reference tool's flags, and print their
reference-shaped output. Thresholds are off (``--threshold 0``): no
test reads a timing."""
import json
import os
import re

import numpy as np
import pytest

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import telemetry


@pytest.fixture(autouse=True)
def _restore_env(monkeypatch):
    for var in ("MXNET_TELEMETRY", "MXNET_MODELWATCH", "MXNET_PERF_DB",
                "MXNET_PERFWATCH"):
        monkeypatch.delenv(var, raising=False)
    telemetry.refresh()
    yield
    telemetry.refresh()
    telemetry.reset()


def _variant_rows(out, unit):
    rows = {}
    for ln in out.splitlines():
        m = re.match(r"^(stripped|disabled|enabled)\s+([\d.]+)\s+([\d.]+)"
                     r"\s+([+-][\d.]+)%$", ln)
        if m:
            rows[m.group(1)] = [float(m.group(i)) for i in (2, 3, 4)]
    assert set(rows) == {"stripped", "disabled", "enabled"}, out
    assert rows["stripped"][2] == 0.0
    assert "%-10s %12s %14s %12s" % ("variant", "total ms", unit,
                                     "vs stripped") in out
    return rows


def test_telemetry_micro(capsys):
    from mxnet_tpu_torch.tools import telemetry_micro
    assert telemetry_micro.main(["--ops", "200", "--repeats", "2",
                                 "--threshold", "0"]) == 0
    out = capsys.readouterr().out
    _variant_rows(out, "us/op")
    assert re.search(r"disabled-path overhead: -?[\d.]+% median of 2 paired "
                     r"rounds \(threshold off\)", out)
    assert out.rstrip().endswith("TELEMETRY_MICRO_OK")
    assert not telemetry.enabled()


def test_compile_micro(capsys):
    from mxnet_tpu_torch.tools import compile_micro
    assert compile_micro.main(["--ops", "20", "--repeats", "2",
                               "--threshold", "0", "--steps", "2",
                               "--warmup", "2", "--cpu"]) == 0
    out = capsys.readouterr().out
    _variant_rows(out, "us/call")
    assert "hybridize steady state: 0 compiles / 0 recompiles over 2 " \
        "post-warmup steps" in out
    assert out.rstrip().endswith("COMPILE_MICRO_OK")


def test_modelwatch_micro(capsys):
    from mxnet_tpu_torch.tools import modelwatch_micro
    assert modelwatch_micro.main(["--steps", "4", "--repeats", "1",
                                  "--threshold", "0", "--width", "16",
                                  "--cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"modelwatch disabled-path overhead: [+-][\d.]+% "
                     r"\(paired median of 1 rounds\)", out)
    assert "mw only      1.00 read(s)/step (every step sampled: True)" in out
    assert "mw + guard   1.00 read(s)/step (every step sampled: True)" in out
    assert out.rstrip().endswith("MODELWATCH_MICRO_OK")


def test_compile_report(capsys):
    from mxnet_tpu_torch.tools import compile_report
    assert compile_report.main(["--batch", "8", "--steps", "2", "--warmup",
                                "2", "--hidden", "16", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "compile report: 2 warmup + 2 steady steps, batch=8" in out
    assert re.search(r"cached_op\s+CachedOp\.fwd_vjp\s+\d+\s+0\s", out)
    assert out.rstrip().endswith("COMPILE_REPORT_OK")
    assert compile_report.main(["--batch", "8", "--steps", "1", "--warmup",
                                "2", "--hidden", "16", "--cpu",
                                "--json"]) == 0
    doc = json.loads(capsys.readouterr().out.splitlines()[0])
    assert doc["steady_recompiles"] == doc["steady_recaptures"] == 0
    assert {r["fn"] for r in doc["rows"]} >= {"CachedOp.fwd_vjp"}


def test_trace_summary(tmp_path, capsys):
    """A profiled hybridized step dumped by the port's profiler, then
    summarized: the category and event tables, and the compile
    breakdown of compilewatch's spans."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.tools import compile_report, trace_summary
    path = str(tmp_path / "profile.json")
    profiler.set_config(profile_all=True, filename=path)
    os.environ["MXNET_TELEMETRY"] = "1"
    telemetry.refresh()
    profiler.set_state("run")
    try:
        step = compile_report.build_step(8, 16, pt.cpu())
        for _ in range(2):
            step().wait_to_read()
    finally:
        profiler.set_state("stop")
        profiler.dump(reset=True)
        profiler.set_config(profile_all=False, filename="profile.json")
    assert trace_summary.main([path, "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["category", "count", "total",
                                           "mean", "max"]
    assert re.search(r"^event\s+count\s+total\s+mean\s+max$", out, re.M)
    assert "compile time" in out and "of traced time" in out
    # an empty trace is refused
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert trace_summary.main([str(empty)]) == 1


def test_trace_summary_tables_from_events(tmp_path, capsys):
    from mxnet_tpu_torch.tools import trace_summary
    ev = [{"ph": "X", "name": "comm::all_reduce", "cat": "comm", "dur": 50.0,
           "args": {"axis": "dp", "bytes": 4096, "exposed": True}},
          {"ph": "X", "name": "step::forward", "cat": "step", "dur": 200.0},
          {"ph": "i", "name": "marker", "cat": "user"},
          {"ph": "X", "name": "modelwatch::sample", "cat": "modelwatch",
           "dur": 1.0, "args": {"layers": {"dense0": {"g": 0.5, "r": 1e-3}},
                                "anomalies": [], "noise_scale": 12.0}},
          {"ph": "X", "name": "fleet", "cat": "fleet", "dur": 300.0,
           "args": {"trace": "t1"}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(ev))
    assert trace_summary.main([str(path), "--by", "category"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^comm\s+1\s+50us", out, re.M)
    assert "collective" in out and "dp" in out
    assert "gradient noise scale (last reading): 12" in out
    assert "distributed traces: 1 in file" in out


def test_perfwatch_tool(tmp_path, capsys):
    """ingest, report --gate --json, --export-autotune-corpus and micro
    on records written by the test."""
    from mxnet_tpu_torch.tools import perfwatch as cli
    recs = tmp_path / "run.jsonl"
    kind = "NVIDIA H100 80GB HBM3"
    lines = []
    for i, v in enumerate([10.0, 10.1, 9.9, 10.05, 10.0]):
        lines.append(json.dumps({
            "metric": "autotune_paired_median_ratio", "value": v,
            "unit": "tuned/default", "round": i,
            "env": {"device_kind": kind, "git_rev": None, "flags": {}},
            "autotune": "measure",
            "kernels": {"layer_norm_fwd": {"candidate_ms": 0.01 * v}},
            "autotune_table": {"%s|layer_norm_fwd|C=768,M=4096" % kind:
                               {"blocks": 264}}}))
    recs.write_text("noise\n" + "\n".join(lines) + "\n")
    db = str(tmp_path / "db")
    assert cli.main(["ingest", str(recs), "--db", db]) == 0
    out = capsys.readouterr().out
    assert "ingested run.jsonl" in out and "5 new records" in out
    assert cli.main(["report", "--gate", "--json", "--db", db,
                     "--export-autotune-corpus", str(tmp_path / "corpus")]
                    ) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[1].split()[:4] == ["device", "metric", "n",
                                               "latest"]
    assert "NVIDIA_H100" in out and "PERFWATCH_GATE_OK" in out
    rows = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("[")][0])
    assert rows and all(r["verdict"] == "flat" for r in rows)
    assert "exported 1 corpus entry for NVIDIA_H100_80GB_HBM3" in out
    assert cli.main(["micro", "--iters", "20", "--repeats", "2",
                     "--threshold", "100", "--json"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^stripped\s+[\d.]+\s+[\d.]+\s+\+0\.0%$", out, re.M)
    rec = json.loads(out.strip().splitlines()[-2])
    assert rec["metric"] == "perfwatch_micro_disabled_overhead"
    assert rec["unit"] == "disabled/stripped"
    assert rec["env"]["device_kind"] == "cpu"
    assert out.rstrip().endswith("PERFWATCH_MICRO_OK")
    assert np.isfinite(rec["value"])
