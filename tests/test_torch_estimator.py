"""``gluon.contrib.estimator.Estimator.fit`` in the port against the
reference's on the same numpy data and weights: a hybridized MLP trained
through SGD with momentum (the fused step), 4 batches an epoch, a
checkpoint an epoch. Losses and parameters within 1e-5 (relative, 1e-6
absolute; f32, the packages sum in other orders) over 2 epochs, and for
runs resumed from a checkpoint (the newest, and past a truncated one);
the port's resumed run equals its uninterrupted run bit for bit. The
phases (data, forward, backward) are counted as the reference counts
them, the epoch's exhausted probe excluded; guard events fired during
``fit`` are collected.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

from test_torch_telemetry import _both, _reset_all, fit_mlp

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    _reset_all()
    yield
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    _reset_all()


def _dir(tmp_path, lib, name):
    d = tmp_path / ("%s_%s" % (lib.__name__, name))
    d.mkdir()
    return str(d)


def _hold(got, ref):
    assert len(got[0]) == len(ref[0])
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_fit_matches_reference(tmp_path, momentum):
    ref, got = _both(lambda lib: fit_mlp(
        lib, _dir(tmp_path, lib, "a"), momentum=momentum))
    _hold(got, ref)
    assert len(got[0]) == 8
    phases = {k: v["count"] for k, v in
              pt.telemetry.snapshot()["histograms"].items()
              if k.startswith("mx_step_phase_seconds")}
    assert phases['mx_step_phase_seconds{phase="data"}'] == 8
    assert phases['mx_step_phase_seconds{phase="forward"}'] == 8
    assert phases['mx_step_phase_seconds{phase="backward"}'] == 8


def _resumed(lib, d, truncate=False):
    """One epoch, then a fresh net and trainer resumed for the second."""
    fit_mlp(lib, d, epochs=1)
    if truncate:
        fit_mlp(lib, d, epochs=2, resume=True)     # writes epoch 2
        path = os.path.join(d, "run-0002.params")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        return fit_mlp(lib, d, epochs=2, resume=True)
    return fit_mlp(lib, d, epochs=2, resume=True)


@pytest.mark.parametrize("truncate", [False, True])
def test_resumed_fit_matches_reference_and_the_uninterrupted_run(
        tmp_path, truncate):
    ref, got = _both(lambda lib: _resumed(lib, _dir(tmp_path, lib, "r"),
                                          truncate))
    _hold(got, ref)
    assert len(got[0]) == 4          # the second epoch only
    full = fit_mlp(pt, _dir(tmp_path, pt, "full"))
    for k, v in full[1].items():
        assert got[1][k].tobytes() == v.tobytes(), k
    for g, f in zip(got[0], full[0][4:]):
        assert g.tobytes() == f.tobytes()


def test_resume_from_an_empty_prefix_starts_at_zero(tmp_path):
    losses, _, est, _ = fit_mlp(pt, _dir(tmp_path, pt, "e"), epochs=1,
                                resume=True)
    assert len(losses) == 4
    with pytest.raises(ValueError, match="ckpt_prefix"):
        est.fit([], epochs=1, resume=True)


def test_guard_events_are_collected(tmp_path):
    def run(lib):
        _, _, est, tr = fit_mlp(lib, _dir(tmp_path, lib, "g"), epochs=1,
                                guard="skip_step",
                                fault=("nan_grad", 1.0, 1))
        return ([(e["kind"], e.get("step")) for e in est.guard_events],
                tr.grad_guard.skipped_steps)
    ref, got = _both(run)
    assert got == ref == ([("nonfinite", 1), ("skip", 1)], 1)


def test_elastic_waits_for_item_11(tmp_path, monkeypatch):
    """MXNET_ELASTIC is ported (item 11): with no notice the polling fit
    trains the same bits as a fit without it, and its checkpoints carry
    the sharding section (tests/test_torch_elastic.py drives the
    transitions)."""
    plain = fit_mlp(pt, _dir(tmp_path, pt, "pl"), epochs=1)
    monkeypatch.setenv("MXNET_ELASTIC", "1")
    d = _dir(tmp_path, pt, "el")
    el = fit_mlp(pt, d, epochs=1)
    for a, b in zip(el[0], plain[0]):
        assert a.tobytes() == b.tobytes()
    for k in plain[1]:
        assert el[1][k].tobytes() == plain[1][k].tobytes()
    sec = pt.model.checkpoint_sharding(os.path.join(d, "run"), 1)
    assert sec["layout"] == "replicated" and sec["n_devices"] == 1


def test_callbacks_match_reference(tmp_path, caplog):
    import logging
    for lib in (mx, pt):
        with pytest.raises(NotImplementedError if lib is pt else
                           AttributeError):
            cb = lib.callback.module_checkpoint(object(), "p")
            cb(0)
    rows = []
    for lib in (mx, pt):
        def arr(a):
            return lib.nd.array(a, ctx=lib.cpu()) if lib is pt \
                else lib.nd.array(a)
        m = lib.metric.Accuracy()
        m.update([arr(np.array([1.0, 0.0]))],
                 [arr(np.array([[0.1, 0.9], [0.2, 0.8]]))])
        param = lib.model.BatchEndParam(epoch=0, nbatch=4, eval_metric=m,
                                        locals=None)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            lib.callback.log_train_metric(2)(param)
            lib.callback.LogValidationMetricsCallback()(param)
            lib.callback.ProgressBar(8, length=10)(param)
            sp = lib.callback.Speedometer(2, frequent=2)
            sp(param)
            sp(param)
        rows.append([r.getMessage().split("Speed")[0] for r in caplog.records])
        d = tmp_path / lib.__name__
        d.mkdir()
        arg = {"w": arr(np.ones((2, 2), np.float32))}
        lib.callback.do_checkpoint(str(d / "cb"), period=2)(1, None, arg, {})
        lib.model.wait_checkpoints()
        rows.append(sorted(os.listdir(d)))
    assert rows[2:] == rows[:2]
    assert rows[1] == ["cb-0002.params", "cb-manifest.json"]
