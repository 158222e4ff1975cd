"""The grad guard and fault injection in the port
(``mxnet_tpu_torch/guardrails.py``, ``mxnet_tpu_torch/faultinject.py``):
19 of the reference's ``tests/test_guardrails.py`` contracts, each run
in both packages on the same numpy inputs, the port's results held to
the reference's (flags, counters, events, exceptions exactly; norms and
values within f32 tolerance), and the fault registry's spec parser and
seeded draw against the reference's.

The reference's comm-deadline and kv tests wait for the modules they
test (ROADMAP.md queue 1, item 11); its monitor and estimator contracts
are held in ``test_torch_monitor_profiler.py`` and
``test_torch_estimator.py``. Guard events reach the ``on_event``
subscribers and the telemetry registry's ``mx_guard_events_total``.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_ag

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import autograd as ag

LIBS = (mx, pt)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    for lib in LIBS:
        lib.faultinject.reset()
    yield
    for lib in LIBS:
        lib.faultinject.reset()
    for a in (ag, ref_ag):
        a.disarm_fused_update()
        a.flush_pending_step()


def _nd(lib, a):
    a = np.asarray(a, np.float32)
    return lib.nd.array(a, ctx=lib.cpu()) if lib is pt else lib.nd.array(a)


def _both(fn):
    """fn(lib) in both packages: (reference's, port's)."""
    return fn(mx), fn(pt)


def _count_reads(lib, fn):
    calls = []
    orig = lib.nd.NDArray.asnumpy
    lib.nd.NDArray.asnumpy = lambda self: (calls.append(1), orig(self))[1]
    try:
        out = fn()
    finally:
        lib.nd.NDArray.asnumpy = orig
    return out, len(calls)


# -- the fused reduction (reference :27, :40, :52) ---------------------------
def test_finite_report_flags_and_norm():
    def run(lib):
        a = _nd(lib, [3.0, 4.0])
        b = _nd(lib, [np.nan, 1.0])
        c = _nd(lib, [[1.0, 2.0]])
        return (lib.guardrails.finite_report([a, b, c]),
                lib.guardrails.finite_report([a, c]))
    ref, got = _both(run)
    (flags, norm), (flags2, n2) = got
    assert flags == ref[0][0] == [True, False, True]
    assert not np.isfinite(norm) and not np.isfinite(ref[0][1])
    assert flags2 == ref[1][0] == [True, True]
    np.testing.assert_allclose(n2, np.sqrt(9 + 16 + 1 + 4), rtol=1e-6)
    np.testing.assert_allclose(n2, ref[1][1], rtol=1e-7)


def test_finite_report_norm_no_float32_overflow():
    def run(lib):
        big = [_nd(lib, np.ones(64)) * 1e18 for _ in range(8)]
        return lib.guardrails.finite_report(big)
    (rf, rn), (flags, norm) = _both(run)
    assert all(flags) and flags == rf
    assert np.isfinite(norm)
    np.testing.assert_allclose(norm, 1e18 * np.sqrt(64 * 8), rtol=1e-4)
    np.testing.assert_allclose(norm, rn, rtol=1e-6)


def test_all_finite_single_sync():
    def run(lib):
        grads = [_nd(lib, np.ones(4)) for _ in range(10)]
        return _count_reads(lib, lambda: lib.guardrails.all_finite(grads))
    assert _both(run) == ((True, 1), (True, 1))


# -- the policies and the clip (reference :67 to :171) -----------------------
def test_guard_zero_policy_zeros_only_bad_grads():
    def run(lib):
        g_bad, g_ok = _nd(lib, [np.nan, 1.0]), _nd(lib, np.ones(2))
        guard = lib.guardrails.GradGuard(nonfinite="zero")
        ok = guard.check([("w", g_bad), ("b", g_ok)])
        return (ok, g_bad.asnumpy().tolist(), g_ok.asnumpy().tolist(),
                guard.zeroed_steps, guard.nonfinite_steps)
    ref, got = _both(run)
    assert got == ref == (True, [0.0, 0.0], [1.0, 1.0], 1, 1)


def test_guard_raise_names_offending_param():
    for lib in LIBS:
        guard = lib.guardrails.GradGuard(nonfinite="raise")
        with pytest.raises(lib.guardrails.NonFiniteGradientError,
                           match="poison_me"):
            guard.check([("fine", _nd(lib, np.ones(2))),
                         ("poison_me", _nd(lib, [np.inf]))])
    assert issubclass(pt.guardrails.NonFiniteGradientError, pt.MXNetError)


def test_guard_skip_step_policy():
    def run(lib):
        guard = lib.guardrails.GradGuard(nonfinite="skip_step")
        a = guard.check([("a", _nd(lib, np.ones(3)))])
        b = guard.check([("a", _nd(lib, [np.nan]))])
        return a, b, guard.skipped_steps, guard.stats()["skipped"]
    ref, got = _both(run)
    assert got == ref == (True, False, 1, 1)


def test_guard_clip_global_norm():
    def run(lib):
        g1, g2 = _nd(lib, [3.0]), _nd(lib, [4.0])
        guard = lib.guardrails.GradGuard(clip_norm=1.0)
        ok = guard.check([("a", g1), ("b", g2)])
        first = (ok, guard.clipped_steps, guard.last_norm,
                 g1.asnumpy()[0], g2.asnumpy()[0])
        g3 = _nd(lib, [0.5])
        guard.check([("c", g3)])
        return first, g3.asnumpy()[0], guard.clipped_steps
    ref, got = _both(run)
    (ok, clipped, norm, v1, v2), v3, clipped2 = got
    assert ok and clipped == 1 and clipped2 == 1
    np.testing.assert_allclose(norm, 5.0, rtol=1e-5)
    np.testing.assert_allclose([v1, v2], [0.6, 0.8], rtol=1e-4)
    np.testing.assert_allclose(v3, 0.5, rtol=1e-6)
    np.testing.assert_allclose([norm, v1, v2, v3],
                               [ref[0][2], ref[0][3], ref[0][4], ref[1]],
                               rtol=1e-6)


def test_guard_clip_uses_effective_rescaled_norm():
    def run(lib):
        guard = lib.guardrails.GradGuard(clip_norm=1.0)
        g = _nd(lib, [24.0, 32.0])
        guard.check([("a", g)], rescale=1.0 / 8)
        first = (guard.clipped_steps, guard.last_norm, g.asnumpy() / 8)
        g2 = _nd(lib, [3.0, 4.0])
        guard.check([("b", g2)], rescale=1.0 / 8)
        return first, guard.clipped_steps, g2.asnumpy()
    ref, got = _both(run)
    (clipped, norm, scaled), clipped2, g2 = got
    assert clipped == clipped2 == 1
    np.testing.assert_allclose(norm, 5.0, rtol=1e-5)
    np.testing.assert_allclose(scaled, [0.6, 0.8], rtol=1e-4)
    np.testing.assert_allclose(g2, [3.0, 4.0], rtol=1e-6)
    np.testing.assert_allclose(scaled, ref[0][2], rtol=1e-6)


def test_guard_clip_only_observes_nonfinite_without_zeroing():
    def run(lib):
        g_bad = _nd(lib, [np.nan, 1.0])
        guard = lib.guardrails.GradGuard(nonfinite="off", clip_norm=1.0)
        ok = guard.check([("w", g_bad)])
        got = g_bad.asnumpy()
        return (guard.enabled, ok, bool(np.isnan(got[0])), float(got[1]),
                guard.nonfinite_steps, guard.zeroed_steps)
    ref, got = _both(run)
    assert got == ref == (True, True, True, 1.0, 1, 0)


# -- one host read a step, the spike detector (reference :201, :216) ---------
def test_guard_check_is_one_sync_per_step():
    def run(lib):
        guard = lib.guardrails.GradGuard(nonfinite="skip_step",
                                         clip_norm=10.0)
        grads = [("p%d" % i, _nd(lib, np.ones(8))) for i in range(16)]
        _, reads = _count_reads(lib, lambda: guard.check(grads))
        return reads, guard.sync_count
    assert _both(run) == ((1, 1), (1, 1))


def test_guard_loss_spike_detector():
    def run(lib):
        guard = lib.guardrails.GradGuard(spike_factor=2.0, spike_window=10)
        events = []
        unsub = lib.guardrails.on_event(events.append)
        try:
            seen = [guard.observe_loss(1.0) for _ in range(5)]
            seen.append(guard.observe_loss(5.0))
        finally:
            unsub()
        return seen, guard.spikes, [(e["kind"], e["loss"], e["factor"])
                                    for e in events]
    ref, got = _both(run)
    assert got == ref
    assert got[0] == [False] * 5 + [True] and got[1] == 1
    assert got[2] == [("loss_spike", 5.0, 2.0)]


# -- the loss scaler (reference :127, :230, :242) ----------------------------
def _trainer(lib, seed):
    rng = np.random.RandomState(seed)
    net = lib.gluon.nn.Dense(1, in_units=4, prefix="d_")
    if lib is pt:
        net.initialize(ctx=pt.cpu())
    else:
        net.initialize()
    params = net.collect_params()
    for name in sorted(params):
        p = params[name]
        p.set_data(_nd(lib, rng.rand(*p.shape)))
    trainer = lib.gluon.Trainer(params, "sgd", {"learning_rate": 0.1},
                                kvstore=None)
    return net, trainer


def _batches(lib, n=3):
    rng = np.random.RandomState(42)
    return [(_nd(lib, rng.rand(8, 4)), _nd(lib, rng.rand(8, 1)))
            for _ in range(n)]


def _params_np(net):
    params = net.collect_params()
    return {i: params[k].data().asnumpy()
            for i, k in enumerate(sorted(params))}


def test_amp_unscale_with_guard_drives_scaler_once():
    """amp.unscale beside a step-time guard divides only: the scaler
    advances once a step, in both packages; the port's unscale also
    restores the Trainer's scale (queue 3), which the step then applies
    to the unscaled gradients."""
    def run(lib):
        amp = lib.contrib.amp
        net, trainer = _trainer(lib, 21)
        amp.init(target_dtype="float16")
        try:
            amp.init_trainer(trainer)
            scaler = trainer._amp_loss_scaler
            guard = lib.guardrails.GradGuard(nonfinite="skip_step",
                                             scaler=scaler)
            trainer.grad_guard = guard
            assert guard.scaler is scaler
            X, Y = _batches(lib, 1)[0]
            before = scaler._unskipped
            with lib.autograd.record():
                l = lib.gluon.loss.L2Loss()(net(X), Y)
            l.backward()
            amp.unscale(trainer)
            trainer.step(X.shape[0])
            return scaler._unskipped - before, guard.steps
        finally:
            amp.reset()
    assert _both(run) == ((1, 1), (1, 1))


def test_guard_drives_loss_scaler_backoff_and_growth():
    def run(lib):
        scaler = lib.contrib.amp.LossScaler(init_scale=256.0, dynamic=True,
                                            scale_window=2)
        guard = lib.guardrails.GradGuard(nonfinite="skip_step",
                                         scaler=scaler)
        out = [guard.check([("a", _nd(lib, [np.inf]))]), scaler.loss_scale,
               scaler.last_overflow]
        out += [guard.check([("a", _nd(lib, np.ones(2)))])
                for _ in range(2)]
        return out + [scaler.loss_scale, scaler.last_overflow]
    ref, got = _both(run)
    assert got == ref == [False, 128.0, True, True, True, 256.0, False]


def test_loss_scaler_fused_single_sync():
    def run(lib):
        scaler = lib.contrib.amp.LossScaler(init_scale=2.0, dynamic=True)
        grads = [_nd(lib, np.ones(3)) * 2.0 for _ in range(7)]
        ok, reads = _count_reads(lib,
                                 lambda: scaler.unscale_and_check(grads))
        return ok, reads, [g.asnumpy().tolist() for g in grads]
    ref, got = _both(run)
    assert got == ref
    assert got[:2] == (True, 1) and got[2] == [[1.0] * 3] * 7


# -- the environment (reference :260, :339, :584) ----------------------------
def test_from_env(monkeypatch):
    for lib in LIBS:
        assert lib.guardrails.from_env() is None
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", "skip_step")
    monkeypatch.setenv("MXNET_GUARD_CLIP_NORM", "2.5")
    for lib in LIBS:
        guard = lib.guardrails.from_env()
        assert guard is not None and guard.enabled
        assert guard.nonfinite == "skip_step" and guard.clip_norm == 2.5
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", "bogus")
    for lib in LIBS:
        with pytest.raises(ValueError, match="bogus"):
            lib.guardrails.from_env()


def test_trainer_guard_from_env(monkeypatch):
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", "skip_step")

    def run(lib):
        net, trainer = _trainer(lib, 3)
        before = _params_np(net)
        X, Y = _batches(lib, 1)[0]
        lib.faultinject.set_fault("nan_grad", 1.0, max_fires=1)
        with lib.autograd.record():
            l = lib.gluon.loss.L2Loss()(net(X), Y)
        l.backward()
        trainer.step(X.shape[0])
        after = _params_np(net)
        assert trainer.grad_guard is not None
        return trainer.grad_guard.skipped_steps, all(
            before[k].tobytes() == after[k].tobytes() for k in before)
    assert _both(run) == ((1, True), (1, True))


def test_guard_env_vars_declared():
    for lib in LIBS:
        cfg = lib.config
        assert cfg.get("MXNET_GUARD_NONFINITE") == "off"
        assert cfg.get("MXNET_GUARD_CLIP_NORM") == 0.0
        assert cfg.get("MXNET_GUARD_LOSS_SPIKE") == 0.0
        assert cfg.get("MXNET_GUARD_LOSS_WINDOW") == 50
        assert cfg.get("MXNET_GUARD_COMM_VOTE") is False
        assert cfg.get("MXNET_FAULT_INJECT") == ""
        assert cfg.get("MXNET_FAULT_INJECT_SEED") == 0
        assert cfg.get("MXNET_SCAN_STEPS") == 1
    for name in ("MXNET_GUARD_NONFINITE", "MXNET_GUARD_CLIP_NORM",
                 "MXNET_GUARD_LOSS_SPIKE", "MXNET_GUARD_LOSS_WINDOW",
                 "MXNET_GUARD_COMM_VOTE", "MXNET_FAULT_INJECT",
                 "MXNET_FAULT_INJECT_SEED", "MXNET_SCAN_STEPS"):
        assert pt.config.VARS[name].default == mx.config.VARS[name].default


def test_comm_vote_refused(monkeypatch):
    """The kv finite vote is the dist kvstore's (tests/test_torch_dist.py
    holds it across ranks): it refuses nothing on a Trainer without a
    dist store, which steps as without it, in both packages."""
    monkeypatch.setenv("MXNET_GUARD_COMM_VOTE", "1")

    def run(lib):
        net, trainer = _trainer(lib, 3)
        loss_fn = lib.gluon.loss.L2Loss()
        x, y = _batches(lib, 1)[0]
        with lib.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(1)
        return _params_np(net)
    ref, port = _both(run)
    for n, v in ref.items():
        np.testing.assert_allclose(port[n], v, rtol=1e-5, atol=1e-6)


# -- the skipped step bit for bit (reference :303) ---------------------------
def test_skip_step_bit_identical_to_manual_skip():
    def run(lib):
        loss_fn = lib.gluon.loss.L2Loss()
        batches = _batches(lib, 3)
        net_a, tr_a = _trainer(lib, 7)
        tr_a.grad_guard = lib.guardrails.GradGuard(nonfinite="skip_step")
        events = []
        unsub = lib.guardrails.on_event(events.append)
        try:
            for i, (X, Y) in enumerate(batches):
                with lib.autograd.record():
                    l = loss_fn(net_a(X), Y)
                l.backward()
                if i == 1:
                    lib.faultinject.set_fault("nan_grad", 1.0, max_fires=1)
                tr_a.step(X.shape[0])
        finally:
            unsub()
            lib.faultinject.reset()
        net_b, tr_b = _trainer(lib, 7)
        for i, (X, Y) in enumerate(batches):
            with lib.autograd.record():
                l = loss_fn(net_b(X), Y)
            l.backward()
            if i != 1:
                tr_b.step(X.shape[0])
        pa, pb = _params_np(net_a), _params_np(net_b)
        for k in pa:
            assert np.isfinite(pa[k]).all()
            assert pa[k].tobytes() == pb[k].tobytes(), k
        return (tr_a.grad_guard.skipped_steps,
                [(e["kind"], [n.split("_")[-1] for n in e["params"]],
                  e["step"]) for e in events], pa)
    ref, got = _both(run)
    assert got[:2] == ref[:2]
    assert got[0] == 1
    for k in got[2]:
        np.testing.assert_allclose(got[2][k], ref[2][k], rtol=1e-5,
                                   atol=1e-6)


def test_guard_events_reach_subscribers_and_the_counter(monkeypatch):
    """Guard events go to on_event subscribers and, with telemetry on,
    count in mx_guard_events_total{kind}, as the reference's do."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    counts = []
    for lib in LIBS:
        lib.telemetry.refresh()
        lib.telemetry.reset()
        seen = []
        unsub = lib.guardrails.on_event(seen.append)
        bad = lib.guardrails.on_event(lambda e: 1 / 0)  # failing subscriber
        try:
            ev = lib.guardrails.emit("skip", params=["w"], step=3)
            lib.guardrails.emit("clip", norm=2.0)
            lib.guardrails.emit("skip", params=["v"], step=4)
        finally:
            unsub()
            bad()
        assert [e["kind"] for e in seen] == ["skip", "clip", "skip"]
        assert seen[0] is ev and ev["step"] == 3 and "time" in ev
        counts.append({k: v for k, v in
                       lib.telemetry.snapshot()["counters"].items()
                       if k.startswith("mx_guard_events_total")})
        monkeypatch.delenv("MXNET_TELEMETRY")
        lib.telemetry.refresh()
        lib.guardrails.emit("skip")              # off: counts nothing
        assert lib.telemetry.counter("mx_guard_events_total",
                                     kind="skip").get() == 2
        monkeypatch.setenv("MXNET_TELEMETRY", "1")
        lib.telemetry.refresh()
        lib.telemetry.reset()
    assert counts[1] == counts[0] == {
        'mx_guard_events_total{kind="skip"}': 2,
        'mx_guard_events_total{kind="clip"}': 1}
    monkeypatch.delenv("MXNET_TELEMETRY")
    for lib in LIBS:
        lib.telemetry.refresh()


# -- the fault registry -------------------------------------------------------
@pytest.mark.parametrize("spec", ["nan_grad", "nan_grad:0.5",
                                  "nan_grad:1:2,scaled_grad:0.25:1",
                                  " ckpt_write : 0.5 , ,dl_worker:1"])
def test_faultinject_spec_parser(spec):
    assert pt.faultinject._parse(spec) == mx.faultinject._parse(spec)
    assert set(pt.faultinject.SITES) == set(mx.faultinject.SITES)


def test_faultinject_malformed_spec_refused():
    for lib in LIBS:
        with pytest.raises(ValueError, match="site:prob"):
            lib.faultinject._parse("nan_grad:often")


def test_faultinject_seeded_draw(monkeypatch):
    """The env spec with a seed: the same fires in the same draws in
    both packages, a budget stops them, and a changed spec restarts the
    stream; set_fault takes precedence and clear drops it."""
    monkeypatch.setenv("MXNET_FAULT_INJECT", "nan_grad:0.3,scaled_grad:1:2")
    monkeypatch.setenv("MXNET_FAULT_INJECT_SEED", "11")

    def run(lib):
        fi = lib.faultinject
        fi.reset()
        draws = [fi.should_fail("nan_grad") for _ in range(40)]
        budget = [fi.should_fail("scaled_grad") for _ in range(4)]
        out = (draws, budget, fi.fires("nan_grad"), fi.active())
        fi.set_fault("nan_grad", 0.0)
        out += (fi.should_fail("nan_grad"),)
        fi.clear("nan_grad")
        with pytest.raises(lib.base.MXNetError, match="injected fault"):
            fi.set_fault("kv_hang")
            fi.maybe_fail("kv_hang")
        fi.reset()
        return out
    ref, got = _both(run)
    assert got == ref
    assert got[1] == [True, True, False, False]
    assert 0 < got[2] < 40 and got[3] is True and got[4] is False
