"""compilewatch in the port (``mxnet_tpu_torch/compilewatch.py`` and the
capture sites of ``cached_op.py`` and ``scan.py``) against the
reference's attribution cases (``tests/test_compilewatch.py``), each run
in both packages on the same inputs: one program a CachedOp signature, a
hit for the same signature, one recompile naming the data input whose
shape changed and its shapes, train and eval as two programs and not a
storm, the storm guard warning or raising with the diff history, no
program recorded in a hybridized Trainer loop's steady state.

On the CPU the port runs each program eagerly: its records carry the
warm-up stage and the FLOPs ``FlopCounterMode`` counts over it; the
capture stage and the graph memory come on the card
(``tests/test_torch_cuda.py``). Eager registry ops compile nothing in
the port, a gap pinned here.
"""
import logging

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


def _x(lib, shape, seed=0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return lib.nd.array(a, ctx=lib.cpu()) if lib is pt else lib.nd.array(a)


def _net(lib):
    scope = pt.cpu() if lib is pt else _Null()
    with scope:
        return _mlp(lib, _weights())


def _fwd_records(lib):
    return [r for r in lib.compilewatch.programs()
            if r["fn"] == "CachedOp.forward"]


def _count(lib, name, fn):
    return lib.telemetry.counter(name, fn=fn).get()


def test_cachedop_same_shape_is_cache_hit():
    def run(lib):
        net = _net(lib)
        x = _x(lib, (3, 8))
        net(x)
        compiles = len(_fwd_records(lib))
        hits = _count(lib, "mx_compile_cache_hits_total", "CachedOp.forward")
        net(x * 2)
        return (compiles, len(_fwd_records(lib)),
                _count(lib, "mx_compile_cache_hits_total",
                       "CachedOp.forward") - hits)
    ref, got = _both(run)
    assert got == ref == (1, 1, 1)


def test_cachedop_batch_change_is_one_attributed_recompile():
    def run(lib):
        net = _net(lib)
        net(_x(lib, (3, 8)))
        before = _count(lib, "mx_recompiles_total", "CachedOp.forward")
        net(_x(lib, (7, 8)))
        net(_x(lib, (7, 8), seed=1))
        after = _count(lib, "mx_recompiles_total", "CachedOp.forward")
        log = lib.compilewatch.recompile_log("CachedOp.forward")
        shape = [c for c in log[-1]["changed"] if c["field"] == "shape"]
        return after - before, len(log), shape
    ref, got = _both(run)
    assert got == ref
    assert got[2] == [{"arg": "data0", "field": "shape", "from": (3, 8),
                       "to": (7, 8)}]


def test_cachedop_train_eval_flip_is_second_program_not_storm():
    def run(lib):
        net = _net(lib)
        x = _x(lib, (3, 8))
        net(x)
        with lib.autograd.train_mode():
            net(x)
        records = _fwd_records(lib)
        n = len(records)
        for _ in range(3):
            net(x)
            with lib.autograd.train_mode():
                net(x)
        return (sorted(r["instance"].rsplit("/", 1)[1] for r in records),
                [r["kind"] for r in records], len(_fwd_records(lib)) - n,
                _count(lib, "mx_recompiles_total", "CachedOp.forward"))
    ref, got = _both(run)
    assert got == ref == (["eval", "train"], ["compile", "compile"], 0, 0)


def test_record_fields_and_warmup_stage():
    net = _net(pt)
    net(_x(pt, (3, 8)))
    rec = _fwd_records(pt)[-1]
    ref_keys = {"site", "fn", "instance", "kind", "stages", "flops",
                "bytes", "signature", "changed", "time"}
    assert ref_keys <= set(rec)
    assert rec["site"] == "cached_op"
    assert set(rec["stages"]) == {"warmup"}
    # 2 * rows * (8 * 16 + 16 * 4): the two matrix products
    assert rec["flops"] == 2 * 3 * (8 * 16 + 16 * 4)
    assert rec["signature"][0] == "f32[3,8]"
    snap = pt.telemetry.snapshot()
    assert snap["counters"]['mx_compile_flops{fn="CachedOp.forward"}'] == \
        rec["flops"]
    assert 'mx_compile_seconds{fn="CachedOp.forward",stage="warmup"}' in \
        snap["histograms"]


def test_executed_flops_count_every_run():
    net = _net(pt)
    for _ in range(3):
        net(_x(pt, (3, 8)))
    flops = 2 * 3 * (8 * 16 + 16 * 4)
    assert pt.telemetry.counter("mx_executed_flops_total").get() == 3 * flops


def test_compile_span_reaches_the_trace():
    def run(lib):
        lib.profiler.set_state("run")
        _net(lib)(_x(lib, (5, 8)))
        lib.profiler.set_state("stop")
        import json
        events = json.loads(lib.profiler.dumps(reset=True))["traceEvents"]
        ev = [e for e in events if e["name"] == "compile::CachedOp.forward"]
        return ev[0]["args"]["kind"], ev[0]["cat"], \
            bool(ev[0]["args"]["signature"])
    ref, got = _both(run)
    assert got == ref == ("compile", "compile", True)


# ---------------------------------------------------------------------------
# the storm guard
# ---------------------------------------------------------------------------
def _storm(lib, n):
    """The MLP called at batch 1..n: n - 1 recompiles of its eval
    program; returns the recompile count."""
    net = _net(lib)
    for i in range(n):
        net(_x(lib, (i + 1, 8)))
    return int(_count(lib, "mx_recompiles_total", "CachedOp.forward"))


def test_storm_guard_warns_with_diff_history(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_COMPILE_WARN_N", "2")

    def run(lib):
        logger = "mxnet_tpu.compilewatch" if lib is mx \
            else "mxnet_tpu_torch.compilewatch"
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            n = _storm(lib, 5)
        warnings = [r.message for r in caplog.records
                    if "recompile storm" in r.message]
        return n, len(warnings), warnings[0].split(
            "last signature diffs: ")[1]
    ref, got = _both(run)
    assert got == ref
    assert got == (4, 1, "data0.shape (1, 8)->(2, 8); data0.shape "
                   "(2, 8)->(3, 8); data0.shape (3, 8)->(4, 8)")


def test_storm_guard_strict_raises(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_WARN_N", "1")
    monkeypatch.setenv("MXNET_COMPILE_STRICT", "1")
    for lib in (mx, pt):
        with pytest.raises(lib.base.MXNetError, match="recompile storm"):
            _storm(lib, 5)


def test_storm_guard_off_by_zero(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_COMPILE_WARN_N", "0")
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.compilewatch"):
        assert _storm(pt, 6) == 5
    assert not [r for r in caplog.records if "recompile storm" in r.message]


# ---------------------------------------------------------------------------
# the steady state of a hybridized Trainer loop, and the report
# ---------------------------------------------------------------------------
def test_hybridize_trainer_zero_steady_state_recompiles():
    def run(lib):
        scope = pt.cpu() if lib is pt else _Null()
        with scope:
            net = _mlp(lib, _weights())
            loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
            loss_fn.hybridize()
            tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05})
            x = _x(lib, (8, 8))
            y = lib.nd.array(np.arange(8) % 4)

            def step():
                with lib.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(8)
            for _ in range(3):
                step()
            warm = len(lib.compilewatch.programs())
            for _ in range(4):
                step()
            steady = lib.compilewatch.programs()[warm:]
        rows = lib.compilewatch.report()
        fused = [r for r in rows if r["fn"] in ("autograd.fused_step",
                                                "autograd.fused_backward")]
        return ([(r["fn"], r["kind"]) for r in steady],
                sorted((r["fn"], r["recompiles"]) for r in fused),
                lib.compilewatch.render_report(rows))
    ref, got = _both(run)
    assert got[0] == ref[0] == []
    assert got[1] == ref[1] == [("autograd.fused_backward", 0),
                                ("autograd.fused_step", 0)]
    assert "autograd.fused_step" in got[2]
    rows = pt.compilewatch.report()
    assert sum(r["flops"] for r in rows) > 0


def test_jit_cache_surfaces_in_snapshot_and_heartbeat():
    _net(pt)(_x(pt, (3, 8)))
    snap = pt.telemetry.snapshot()
    assert snap["jit_cache"]["watched_fns"] >= 1
    assert snap["jit_cache"]["watched_programs"] >= 1
    assert snap["gauges"]["mx_jit_cache_entries"] >= 1
    line = pt.telemetry.heartbeat_line()
    for field in ("jit_cache=", "compiles=1", "recompiles=0"):
        assert field in line, line


def test_eager_ops_are_not_watched_a_pinned_gap():
    """The reference records a program per eager op signature
    (``ops._jit_cache``); the port's eager ops compile nothing. The
    shapes are this test's own: a signature another test ran in the
    process is in the reference's cache already, and whether the first
    program is a compile or a recompile depends on what ran before."""
    def run(lib):
        a, b = _x(lib, (5, 17, 23)), _x(lib, (6, 17, 23))
        lib.nd.elemwise_add(a, a)
        lib.nd.elemwise_add(b, b)
        return len([r for r in lib.compilewatch.programs()
                    if r["fn"] == "elemwise_add"])
    ref, got = _both(run)
    assert ref == 2 and got == 0


def test_disabled_gate_records_nothing(monkeypatch):
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    pt.telemetry.refresh()
    _net(pt)(_x(pt, (3, 8)))
    assert pt.compilewatch.programs() == []
    assert pt.telemetry.snapshot()["counters"] == {}


def test_scan_chunk_is_one_program(monkeypatch):
    """Under MXNET_SCAN_STEPS=2 the chunk function is one program
    (``scan.fused_chunk``): one compile, then hits."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "2")
    with pt.cpu():
        net = _mlp(pt, _weights())
        loss_fn = pt.gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize()
        tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        x = _x(pt, (8, 8))
        y = pt.nd.array(np.arange(8) % 4)
        for _ in range(7):
            with pt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
    recs = [r for r in pt.compilewatch.programs()
            if r["fn"] == "scan.fused_chunk"]
    assert [r["kind"] for r in recs] == ["compile"]
    assert recs[0]["instance"] == "tape[2 nodes]x2 steps"
    assert recs[0]["flops"] > 0
    assert pt.telemetry.snapshot()["counters"][
        'mx_compile_cache_hits_total{fn="scan.fused_chunk"}'] == 2
    assert pt.telemetry.snapshot()["counters"]["mx_steps_total"] == 7
    tr._scan_flush()


def test_reset_keeps_sites_drops_history():
    net = _net(pt)
    for b in (1, 2, 3):
        net(_x(pt, (b, 8)))
    watch = net._cached_op._watches[(False, False)]
    assert watch.recompiles == 2
    pt.compilewatch.reset()
    assert pt.compilewatch.programs() == [] and watch.recompiles == 0
    assert pt.compilewatch.compile_seconds_total() == 0.0
    net(_x(pt, (3, 8)))                       # a known signature: a hit
    assert pt.compilewatch.programs() == []
