"""modelwatch in the port (``mxnet_tpu_torch/modelwatch.py`` and its
wiring in ``Trainer.step``) against the reference's on the same numpy
inputs and weights: a hybridized MLP trained with MXNET_TELEMETRY and
MXNET_MODELWATCH on, on the classic update path (the update norms of a
sampled step read at the next sampled step) and on the fused SGD path
(read in the same step, after its update).

Tolerance: the per-parameter gradient, weight and update norms and the
update ratios within 1e-5 relative (f32; the two packages sum in other
orders), step for step; anomalies (exploding, dead) named the same, at
the same steps. Each sampled step makes one host read, shared with the
guard.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

from test_torch_telemetry import (_Null, _both, _data, _mlp,
                                  _reset_all, _weights)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_MODELWATCH", "1")
    _reset_all()
    yield
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    _reset_all()


def _train(lib, steps=6, lr=0.1, momentum=0.9, guard=None, fault_at=None,
           fault="scaled_grad"):
    """The MLP trained ``steps`` steps on 8-row batches; returns the
    ring, the anomaly records, the Trainer and the gauges."""
    X, Y = _data(n=8 * steps)
    scope = pt.cpu() if lib is pt else _Null()
    with scope:
        net = _mlp(lib, _weights())
        loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
        loss_fn.hybridize()
        tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": lr, "momentum": momentum})
        if guard is not None:
            tr.grad_guard = lib.guardrails.GradGuard(nonfinite=guard)
        for i in range(steps):
            if fault_at is not None and i == fault_at:
                lib.faultinject.set_fault(fault, 1.0, max_fires=1)
            x = lib.nd.array(X[8 * i:8 * i + 8])
            y = lib.nd.array(Y[8 * i:8 * i + 8])
            with lib.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            tr.step(8)
        lib.faultinject.clear()
    return (lib.modelwatch.ring(), lib.modelwatch.recent_anomalies(), tr,
            lib.telemetry.snapshot()["gauges"])


def _close(got, ref):
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)


def _hold(ref_ring, got_ring):
    assert len(got_ring) == len(ref_ring)
    for r, g in zip(ref_ring, got_ring):
        assert g["step"] == r["step"]
        assert g["names"] == r["names"]
        _close(g["grad_norms"], r["grad_norms"])
        _close(g["param_norms"], r["param_norms"])
        _close(g["update_ratios"], r["update_ratios"])
        assert [a["param"] for a in g["anomalies"]] == \
            [a["param"] for a in r["anomalies"]]


@pytest.mark.parametrize("path", ["classic", "fused"])
def test_layer_statistics_match_reference(monkeypatch, path):
    if path == "classic":
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "0")
    ref, got = _both(lambda lib: _train(lib))
    _hold(ref[0], got[0])
    assert got[0][-1]["update_ratios"][0] is not None
    # the gauges the last sample set
    for key, v in ref[3].items():
        if key.startswith(("mx_layer_", "mx_block_")):
            np.testing.assert_allclose(got[3][key], v, rtol=RTOL)
    assert sorted(k for k in got[3] if k.startswith(("mx_layer_",
                                                     "mx_block_"))) == \
        sorted(k for k in ref[3] if k.startswith(("mx_layer_", "mx_block_")))
    assert got[2].modelwatch.stats() == ref[2].modelwatch.stats()


def test_one_host_read_a_sampled_step(monkeypatch):
    """Guard and modelwatch on (the classic path): each step reads the
    card once, and both keep their counters from that one read."""
    reads = []
    orig = pt.nd.NDArray.asnumpy
    monkeypatch.setattr(pt.nd.NDArray, "asnumpy",
                        lambda self: (reads.append(1), orig(self))[1])
    import torch
    orig_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (reads.append(1),
                                               orig_cpu(self, *a, **k))[1])
    ring, _, tr, _ = _train(pt, steps=5, guard="skip_step")
    assert len(reads) == 5
    assert tr.modelwatch.sync_count == 5
    assert tr.grad_guard.sync_count == 5
    assert len(ring) == 5


def test_sampling_every_n(monkeypatch):
    monkeypatch.setenv("MXNET_MODELWATCH_EVERY", "2")
    ref, got = _both(lambda lib: _train(lib, steps=6))
    assert [e["step"] for e in got[0]] == [e["step"] for e in ref[0]] \
        == [1, 3, 5]
    _hold(ref[0], got[0])


def test_exploding_layer_is_named_like_the_reference(monkeypatch):
    """``scaled_grad`` multiplies the last gradient by 1e4 at step 10:
    the z-score names that layer in both packages."""
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "0")
    ref, got = _both(lambda lib: _train(lib, steps=11, fault_at=10))
    names = [(a["kind"], a["param"], a["step"]) for a in got[1]]
    assert names == [(a["kind"], a["param"], a["step"]) for a in ref[1]]
    assert names == [("exploding", "mlp_dense1_weight", 11)]
    counters = pt.telemetry.snapshot()["counters"]
    assert counters['mx_modelwatch_anomalies_total{kind="exploding",'
                    'param="mlp_dense1_weight"}'] == 1
    assert counters['mx_guard_events_total{kind="layer_anomaly"}'] == 1
    assert counters['mx_fault_injections_total{site="scaled_grad"}'] == 1
    assert pt.modelwatch.suspects()[0]["param"] == "mlp_dense1_weight"


def test_dead_layers_are_named_like_the_reference(monkeypatch):
    """At lr 0 no weight moves: every layer is dead after three
    samples, in both packages."""
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "0")
    ref, got = _both(lambda lib: _train(lib, steps=6, lr=0.0,
                                        momentum=0.0))
    key = lambda recs: sorted((a["kind"], a["param"], a["step"])
                              for a in recs)
    assert key(got[1]) == key(ref[1])
    assert {a["kind"] for a in got[1]} == {"dead"}
    assert len(got[1]) == 4


def test_listener_suspects_and_block_of():
    seen = []
    unsub = pt.modelwatch.on_stats(seen.append)
    try:
        _train(pt, steps=2)
    finally:
        unsub()
    assert [e["step"] for e in seen] == [1, 2]
    for name in ("bertencoder0_ffn1_weight", "dense0_bias", "plain",
                 "bn_moving_var", "a_b_c"):
        assert pt.modelwatch.block_of(name) == mx.modelwatch.block_of(name)
    assert pt.modelwatch.RING_STEPS == mx.modelwatch.RING_STEPS


def test_noise_scale_absent_on_one_device():
    ring, _, tr, gauges = _train(pt, steps=3)
    assert all(e["noise_scale"] is None for e in ring)
    assert "mx_grad_noise_scale" not in gauges
    assert not tr.modelwatch.want_noise()


def test_modelwatch_off_without_telemetry(monkeypatch):
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    pt.telemetry.refresh()
    _, _, tr, _ = _train(pt, steps=2)
    assert tr.modelwatch is None
    assert pt.modelwatch.ring() == []


def test_scan_boundary_report(monkeypatch):
    """Under MXNET_SCAN_STEPS=2 the chunk is sampled at its boundary: one
    read a chunk, the update norms over the chunk's two steps."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "2")
    ring, _, tr, _ = _train(pt, steps=7)
    # step 1 classic (it arms; its backward is the template), then
    # chunks of two retired at steps 3, 5 and 7
    assert tr._scan is not None and tr._scan.retired_chunks == 3
    assert [e["step"] for e in ring] == [1, 3, 5, 7]
    assert tr.modelwatch.sync_count == 4
    assert all(r is not None for r in ring[-1]["update_ratios"])
    tr._scan_flush()


def _noise_run(lib, ctxs, steps=3):
    """A Dense(4) on 4 replicas through the device kvstore, squared-sum
    loss a replica; returns the noise scale after each step, the
    per-replica gradients before the first step's all-reduce and the
    Trainer."""
    lib.random.seed(0)
    net = lib.gluon.nn.Dense(4, in_units=4, prefix="noise_")
    net.initialize(lib.initializer.Zero(), ctx=ctxs)
    for p in net.collect_params().values():
        p.set_data(lib.nd.array(np.full(p.shape, 0.25, np.float32)))
    tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device")
    rs = np.random.RandomState(3)
    scales, first = [], None
    for i in range(steps):
        x = rs.randn(8, 4).astype(np.float32)
        y = rs.randn(8, 4).astype(np.float32)
        xs = lib.gluon.utils.split_and_load(lib.nd.array(x), ctxs)
        ys = lib.gluon.utils.split_and_load(lib.nd.array(y), ctxs)
        with lib.autograd.record():
            losses = [((net(a) - b) ** 2).sum() for a, b in zip(xs, ys)]
        for loss in losses:
            loss.backward()
        if i == 0:
            first = [[p.list_grad()[r].asnumpy().astype(np.float64)
                      for p in tr._params] for r in range(len(ctxs))]
        tr.step(8)
        scales.append(tr.modelwatch.noise_scale)
    return scales, first, tr


def test_noise_scale_dp4_matches_reference():
    """B_simple over 4 replicas: the reference's after each of 3 steps
    (its EMA), within 1e-4; the first against the formula over the
    replicas' gradients read on the host; the gauge, the suggested
    batch and the heartbeat's fields."""
    import math
    ref, _, _ = _noise_run(mx, [mx.tpu(i) for i in range(4)])
    with pt.cpu():
        got, per_replica, tr = _noise_run(pt, [pt.cpu(i) for i in range(4)])
    assert all(v is not None and math.isfinite(v) and v > 0 for v in got)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    nrep, B = 4, 8.0
    b = B / nrep
    small_sq = sum(float(np.float32(np.linalg.norm(g))) ** 2
                   for rep in per_replica for g in rep)
    summed = [sum(rep[i] for rep in per_replica)
              for i in range(len(per_replica[0]))]
    big_sq = sum(float(np.float32(np.linalg.norm(g))) ** 2 for g in summed)
    g_small = (small_sq / nrep) / (b * b)
    g_big = big_sq / (B * B)
    expect = ((g_small - g_big) / (1 / b - 1 / B)) \
        / ((B * g_big - b * g_small) / (B - b))
    np.testing.assert_allclose(got[0], expect, rtol=1e-4)
    mw = tr.modelwatch
    gauges = pt.telemetry.snapshot()["gauges"]
    np.testing.assert_allclose(gauges["mx_grad_noise_scale"], mw.noise_scale)
    assert mw.suggested_batch() == max(1, int(round(mw.noise_scale)))
    hb = pt.telemetry.heartbeat_line()
    assert "noise_scale=" in hb and "suggest_batch=" in hb
    assert pt.modelwatch.ring()[-1]["noise_scale"] == mw.noise_scale
    # one read a sampled step: the replicas' norms ride it
    assert mw.sync_count == 3


def test_noise_scale_under_zero_matches_the_replicated(monkeypatch):
    """The ZeRO step stages the same replica norms and publishes its
    report at the next sampled step: its noise scales are the
    replicated Trainer's, one step later."""
    with pt.cpu():
        rep, _, _ = _noise_run(pt, [pt.cpu(i) for i in range(4)], steps=4)
        monkeypatch.setenv("MXNET_ZERO", "1")
        _reset_all()
        zero, _, tr = _noise_run(pt, [pt.cpu(i) for i in range(4)],
                                 steps=4)
    assert tr._zero
    assert zero[0] is None
    np.testing.assert_allclose(zero[1:], rep[:-1], rtol=1e-5)


def test_replica_norms_are_accurate_on_large_cpu_tensors():
    """The norms the noise scale folds are the reference's within f32
    rounding on a BERT-sized gradient (2^24 elements), where an f32
    running sum drifts."""
    rng = np.random.RandomState(5)
    big = (rng.randn(1 << 24) * 1e-3).astype(np.float32)
    small = rng.randn(37).astype(np.float32)
    want = [np.linalg.norm(a.astype(np.float64)) for a in (big, small)]
    port = pt.nd.multi_l2_norm(pt.nd.array(big, ctx=pt.cpu()),
                               pt.nd.array(small, ctx=pt.cpu()),
                               num_arrays=2).asnumpy()
    ref = mx.nd.multi_l2_norm(mx.nd.array(big), mx.nd.array(small),
                              num_arrays=2).asnumpy()
    np.testing.assert_allclose(port, want, rtol=2e-7)
    np.testing.assert_allclose(port, ref, rtol=1e-6)
