"""ZeRO weight-update sharding in the port (``mxnet_tpu_torch/gluon/zero.py``)
against the reference's replicated multi-context Trainer and the port's
own, on the reference's ``tests/test_zero.py`` cases.

The reference's ZeRO programs cannot run on this JAX (shard_map cannot
infer the replication their ``out_specs`` ask for), so its replicated
Trainer is the oracle: the same numpy weights and batches through both
packages, ``MXNET_ZERO=1`` in the port, ``MXNET_ZERO=0`` in the
reference, within the reference's ``_assert_parity`` tolerance (rtol
1e-5, atol 1e-6). The port's ZeRO takes the same steps as its own
replicated Trainer bit for bit (the same ordered sums, the same update
ops), and its replicas are bit for bit after every step. The replicas
are ``cpu(0)``, ``cpu(1)``, ... (distinct mesh devices in the port).
"""
import logging
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon import zero as zero_mod

_VARS = ("MXNET_ZERO", "MXNET_ZERO_DCN", "MXNET_ZERO_MIN_SIZE",
         "MXNET_GUARD_NONFINITE", "MXNET_GUARD_CLIP_NORM",
         "MXNET_KVSTORE_QUANTIZE", "MXNET_SCAN_STEPS", "MXNET_TELEMETRY",
         "MXNET_FAULT_INJECT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    for lib in (mx, pt):
        lib.telemetry.refresh()
    yield
    for var in _VARS:
        os.environ.pop(var, None)
    for lib in (mx, pt):
        lib.telemetry.refresh()
        lib.telemetry.reset()
        lib.commwatch.reset()


def _ctxs(lib, n):
    if lib is pt:
        return [pt.cpu(i) for i in range(n)]
    import jax
    if jax.device_count() < n:
        pytest.skip("needs %d devices" % n)
    return [mx.tpu(i) for i in range(n)]


def _weights(seed=5):
    rng = np.random.RandomState(seed)
    # sizes 35, 5, 15, 3: none divisible by 4 or 8 replicas, and the
    # 3-element bias is smaller than the replica count (most replicas
    # own pure padding for it)
    return [rng.randn(5, 7).astype(np.float32) * 0.3,
            rng.randn(5).astype(np.float32) * 0.1,
            rng.randn(3, 5).astype(np.float32) * 0.3,
            rng.randn(3).astype(np.float32) * 0.1]


def build(lib, zero, ndev=4, opt="sgd", opt_kw=None, seed=5, dcn=0,
          prefix="z_", kvstore="device", compression_params=None):
    os.environ["MXNET_ZERO"] = "1" if zero else "0"
    if dcn:
        os.environ["MXNET_ZERO_DCN"] = str(dcn)
    else:
        os.environ.pop("MXNET_ZERO_DCN", None)
    ctxs = _ctxs(lib, ndev)
    net = lib.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(5, in_units=7),
                lib.gluon.nn.Dense(3, in_units=5))
    net.initialize(ctx=ctxs)
    for p, w in zip(net.collect_params().values(), _weights(seed)):
        p.set_data(lib.nd.array(w, ctx=ctxs[0]) if lib is pt
                   else lib.nd.array(w))
    kw = {} if compression_params is None else \
        {"compression_params": compression_params}
    tr = lib.gluon.Trainer(net.collect_params(), opt,
                           dict(opt_kw or {"learning_rate": 0.05}),
                           kvstore=kvstore, **kw)
    return net, tr, ctxs


def run(lib, net, tr, ctxs, steps, seed=11, poison_step=None, check=None):
    rng = np.random.RandomState(seed)
    for s in range(steps):
        x = rng.rand(8, 7).astype(np.float32)
        y = rng.rand(8, 3).astype(np.float32)
        xs = lib.gluon.utils.split_and_load(
            lib.nd.array(x, ctx=ctxs[0]) if lib is pt else lib.nd.array(x),
            ctxs)
        ys = lib.gluon.utils.split_and_load(
            lib.nd.array(y, ctx=ctxs[0]) if lib is pt else lib.nd.array(y),
            ctxs)
        with lib.autograd.record():
            losses = [((net(a) - b) ** 2).sum() for a, b in zip(xs, ys)]
        for l in losses:
            l.backward()
        if s == poison_step:
            for g in list(net.collect_params().values())[0].list_grad():
                g[:] = float("nan")
        tr.step(8)
        if check is not None:
            check(s)


def weights(net, ctx):
    return [p.data(ctx).asnumpy() for p in net.collect_params().values()]


def assert_parity(net_a, ctx_a, net_b, ctx_b, rtol=1e-5, atol=1e-6):
    for a, b in zip(weights(net_a, ctx_a), weights(net_b, ctx_b)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def assert_bits(net_a, ctx_a, net_b, ctx_b):
    for a, b in zip(weights(net_a, ctx_a), weights(net_b, ctx_b)):
        assert a.tobytes() == b.tobytes()


def replicas_equal(net, ctxs):
    for p in net.collect_params().values():
        ref = p.data(ctxs[0]).asnumpy().tobytes()
        for c in ctxs[1:]:
            assert p.data(c).asnumpy().tobytes() == ref, (p.name, c)


_OPTS = [("sgd", {"learning_rate": 0.05}),
         ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
         ("adam", {"learning_rate": 0.01})]
_IDS = ["sgd", "sgd_momentum", "adam"]


# ---------------------------------------------------------------------------
# on/off parity: the acceptance suite
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("opt,kw", _OPTS, ids=_IDS)
def test_zero_on_off_parity(opt, kw, ndev):
    net_z, tr_z, ctx_z = build(pt, True, ndev=ndev, opt=opt, opt_kw=kw)
    run(pt, net_z, tr_z, ctx_z, 4,
        check=lambda s: replicas_equal(net_z, ctx_z))
    assert isinstance(tr_z._zero, zero_mod.ZeroEngine)
    net_p, tr_p, ctx_p = build(pt, False, ndev=ndev, opt=opt, opt_kw=kw,
                               prefix="p_")
    run(pt, net_p, tr_p, ctx_p, 4)
    assert tr_p._zero is False
    net_r, tr_r, ctx_r = build(mx, False, ndev=ndev, opt=opt, opt_kw=kw)
    run(mx, net_r, tr_r, ctx_r, 4)
    # the port's own replicated Trainer: the same bits
    assert_bits(net_z, ctx_z[0], net_p, ctx_p[0])
    # the reference's replicated Trainer: its tolerance
    assert_parity(net_z, ctx_z[0], net_r, ctx_r[0])
    # the update counters advance once a step on every path
    assert tr_z._optimizer.num_update == tr_r._optimizer.num_update == 4


@pytest.mark.parametrize("aggregate", [0, 4096], ids=["single", "multi"])
def test_zero_fragment_ops_follow_the_replicated_update(aggregate,
                                                         monkeypatch):
    """With aggregation off (MXNET_OPTIMIZER_AGGREGATION_SIZE=0, the
    one-tensor ops) and on (the multi-tensor ops), ZeRO takes the
    replicated Trainer's steps bit for bit."""
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", str(aggregate))
    for opt, kw in _OPTS:
        net_z, tr_z, ctx_z = build(pt, True, opt=opt, opt_kw=kw)
        run(pt, net_z, tr_z, ctx_z, 3)
        net_p, tr_p, ctx_p = build(pt, False, opt=opt, opt_kw=kw,
                                   prefix="p_")
        run(pt, net_p, tr_p, ctx_p, 3)
        assert tr_z._zero._hyper_key[0].endswith("_multi") == \
            (aggregate > 1)
        assert_bits(net_z, ctx_z[0], net_p, ctx_p[0])


def test_zero_grads_stay_local_documented_divergence():
    """After a sharded step each replica's gradient arrays keep their
    LOCAL values (the summed gradients exist only scattered)."""
    net, tr, ctxs = build(pt, True)
    rng = np.random.RandomState(0)
    x = pt.nd.array(rng.rand(8, 7).astype(np.float32), ctx=ctxs[0])
    y = pt.nd.array(rng.rand(8, 3).astype(np.float32), ctx=ctxs[0])
    xs = pt.gluon.utils.split_and_load(x, ctxs)
    ys = pt.gluon.utils.split_and_load(y, ctxs)
    with pt.autograd.record():
        losses = [((net(a) - b) ** 2).sum() for a, b in zip(xs, ys)]
    for l in losses:
        l.backward()
    pre = [g.asnumpy() for g in
           list(net.collect_params().values())[0].list_grad()]
    tr.step(8)
    assert isinstance(tr._zero, zero_mod.ZeroEngine)
    post = [g.asnumpy() for g in
            list(net.collect_params().values())[0].list_grad()]
    for a, b in zip(pre, post):
        assert a.tobytes() == b.tobytes()
    # and they differ from replica to replica (not the summed value)
    assert pre[0].tobytes() != pre[1].tobytes()


# ---------------------------------------------------------------------------
# the grad guard on the scattered fragments
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["skip_step", "zero"])
@pytest.mark.parametrize("opt,kw", [_OPTS[1], _OPTS[2]],
                         ids=["sgd_momentum", "adam"])
def test_zero_guard_policy_parity(policy, opt, kw, monkeypatch):
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", policy)
    net_z, tr_z, ctx_z = build(pt, True, opt=opt, opt_kw=kw)
    run(pt, net_z, tr_z, ctx_z, 3, poison_step=1)
    assert isinstance(tr_z._zero, zero_mod.ZeroEngine)
    net_p, tr_p, ctx_p = build(pt, False, opt=opt, opt_kw=kw, prefix="p_")
    run(pt, net_p, tr_p, ctx_p, 3, poison_step=1)
    net_r, tr_r, ctx_r = build(mx, False, opt=opt, opt_kw=kw)
    run(mx, net_r, tr_r, ctx_r, 3, poison_step=1)
    assert_parity(net_z, ctx_z[0], net_r, ctx_r[0])
    assert_parity(net_z, ctx_z[0], net_p, ctx_p[0], rtol=0, atol=0)
    assert tr_z._optimizer.num_update == tr_r._optimizer.num_update
    gz, gr = tr_z.grad_guard, tr_r.grad_guard
    assert gz.nonfinite_steps == gr.nonfinite_steps == 1
    if policy == "skip_step":
        assert gz.skipped_steps == gr.skipped_steps == 1
    else:
        assert gz.zeroed_steps == gr.zeroed_steps == 1
    # exactly one host read a guarded step on both paths
    assert gz.sync_count == gr.sync_count == 3


def test_zero_guard_clip_parity(monkeypatch):
    monkeypatch.setenv("MXNET_GUARD_CLIP_NORM", "0.5")
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    net_z, tr_z, ctx_z = build(pt, True, opt="sgd", opt_kw=kw)
    run(pt, net_z, tr_z, ctx_z, 3)
    net_r, tr_r, ctx_r = build(mx, False, opt="sgd", opt_kw=kw)
    run(mx, net_r, tr_r, ctx_r, 3)
    assert_parity(net_z, ctx_z[0], net_r, ctx_r[0])
    assert tr_z.grad_guard.clipped_steps == \
        tr_r.grad_guard.clipped_steps > 0
    assert np.isclose(tr_z.grad_guard.last_norm, tr_r.grad_guard.last_norm,
                      rtol=1e-4)
    assert tr_z.grad_guard.sync_count == 3


# ---------------------------------------------------------------------------
# topology-free checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt,kw", _OPTS, ids=_IDS)
def test_zero_save_states_is_the_replicated_file(opt, kw, tmp_path):
    """After the same steps ZeRO's states file is byte for byte the port's
    replicated Trainer's, and the reference's Trainer.load_states reads
    it (the same arrays as its own replicated run's, within its
    tolerance)."""
    net_z, tr_z, ctx_z = build(pt, True, opt=opt, opt_kw=kw)
    run(pt, net_z, tr_z, ctx_z, 3)
    net_p, tr_p, ctx_p = build(pt, False, opt=opt, opt_kw=kw, prefix="p_")
    run(pt, net_p, tr_p, ctx_p, 3)
    fz, fp = str(tmp_path / "z.st"), str(tmp_path / "p.st")
    tr_z.save_states(fz)
    tr_p.save_states(fp)
    assert open(fz, "rb").read() == open(fp, "rb").read()
    net_r, tr_r, ctx_r = build(mx, False, opt=opt, opt_kw=kw)
    run(mx, net_r, tr_r, ctx_r, 3)
    fr = str(tmp_path / "r.st")
    tr_r.save_states(fr)
    sr = pickle.load(open(fr, "rb"))
    tr_r.load_states(fz)
    got = tr_r._updaters[0].states
    assert set(got) == set(sr)
    for k in sr:
        a = got[k] if isinstance(got[k], tuple) else (got[k],)
        b = sr[k] if isinstance(sr[k], tuple) else (sr[k],)
        for u, v in zip(a, b):
            if u is None:
                assert v is None
                continue
            np.testing.assert_allclose(u.asnumpy(), v.asnumpy(), rtol=1e-5,
                                       atol=1e-7)


def test_zero_checkpoint_round_trips_4_2_1_4(tmp_path):
    """Adam sharded over 4 -> saved -> loaded sharded over 2 -> saved ->
    loaded replicated on 1 -> saved -> loaded sharded over 4: every hop
    continues as a replicated Trainer that loads the same file, bit for
    bit, and the last file equals the first run's gathered state."""
    kw = {"learning_rate": 0.01}
    net, tr, ctxs = build(pt, True, ndev=4, opt="adam", opt_kw=kw)
    run(pt, net, tr, ctxs, 2)
    ck = str(tmp_path / "s0")
    tr.save_states(ck)
    w = weights(net, ctxs[0])
    for hop, ndev in enumerate((2, 1, 4)):
        zero = ndev > 1
        net_a, tr_a, ctx_a = build(pt, zero, ndev=ndev, opt="adam",
                                   opt_kw=kw, prefix="a%d_" % hop)
        net_b, tr_b, ctx_b = build(pt, False, ndev=ndev, opt="adam",
                                   opt_kw=kw, prefix="b%d_" % hop)
        # MXNET_ZERO is read when a Trainer first resolves its engine
        for n_, t_, c_, flag in ((net_a, tr_a, ctx_a, zero),
                                 (net_b, tr_b, ctx_b, False)):
            os.environ["MXNET_ZERO"] = "1" if flag else "0"
            for p, a in zip(n_.collect_params().values(), w):
                p.set_data(pt.nd.array(a, ctx=pt.cpu()))
            t_.load_states(ck)
            run(pt, n_, t_, c_, 2, seed=17 + hop)
        assert isinstance(tr_a._zero, zero_mod.ZeroEngine) == zero
        assert_bits(net_a, ctx_a[0], net_b, ctx_b[0])
        ck = str(tmp_path / ("s%d" % (hop + 1)))
        tr_a.save_states(ck)
        other = str(tmp_path / ("o%d" % (hop + 1)))
        tr_b.save_states(other)
        assert open(ck, "rb").read() == open(other, "rb").read()
        w = weights(net_a, ctx_a[0])


def test_zero_loads_step0_checkpoint(tmp_path):
    kw = {"learning_rate": 0.01}
    net_r, tr_r, ctx_r = build(pt, False, opt="adam", opt_kw=kw,
                               prefix="p_")
    ck = str(tmp_path / "step0")
    tr_r.save_states(ck)
    net_z, tr_z, ctx_z = build(pt, True, opt="adam", opt_kw=kw)
    tr_z.load_states(ck)
    run(pt, net_z, tr_z, ctx_z, 2)
    run(pt, net_r, tr_r, ctx_r, 2)
    assert_bits(net_z, ctx_z[0], net_r, ctx_r[0])


def test_zero_hierarchical_dcn_parity_and_permutation(tmp_path,
                                                     monkeypatch):
    """MXNET_ZERO_DCN=2 over 4 replicas: the ownership permutation, RS and
    AG on both tiers, parity with the reference's replicated Trainer,
    and a checkpoint equal to the replicated one."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    pt.commwatch.reset()
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    net_z, tr_z, ctx_z = build(pt, True, opt="sgd", opt_kw=kw, dcn=2)
    run(pt, net_z, tr_z, ctx_z, 3,
        check=lambda s: replicas_equal(net_z, ctx_z))
    eng = tr_z._zero
    assert eng._n_dcn == 2 and eng._owner == [0, 2, 1, 3]
    rows = {(r["op"], r["axis"]): r for r in pt.commwatch.report()}
    for op in ("reduce_scatter", "allgather"):
        for axis in ("dp", "dcn"):
            assert rows.get((op, axis), {}).get("bytes", 0) > 0, (op, axis)
    net_r, tr_r, ctx_r = build(mx, False, opt="sgd", opt_kw=kw)
    run(mx, net_r, tr_r, ctx_r, 3)
    assert_parity(net_z, ctx_z[0], net_r, ctx_r[0])
    net_p, tr_p, ctx_p = build(pt, False, opt="sgd", opt_kw=kw,
                               prefix="p_")
    run(pt, net_p, tr_p, ctx_p, 3)
    fz = str(tmp_path / "z")
    tr_z.save_states(fz)
    sz = pt.optimizer.loads_states(open(fz, "rb").read())
    sp = pt.optimizer.loads_states(tr_p.states_blob())
    for k in sp:
        np.testing.assert_allclose(sz[k].asnumpy(), sp[k].asnumpy(),
                                   rtol=1e-5, atol=1e-7)
    # the gathered fragments follow the permutation: loading the file
    # into a flat 4-replica engine reproduces the same states
    net_f, tr_f, ctx_f = build(pt, True, opt="sgd", opt_kw=kw, prefix="f_")
    tr_f.load_states(fz)
    assert tr_f._zero._owner == [0, 1, 2, 3]
    got = pt.optimizer.loads_states(tr_f.states_blob())
    for k in sz:
        assert got[k].asnumpy().tobytes() == sz[k].asnumpy().tobytes()


# ---------------------------------------------------------------------------
# the eligibility ladder
# ---------------------------------------------------------------------------
def test_zero_eligibility_reasons_in_order():
    os.environ["MXNET_ZERO"] = "1"
    ctxs = _ctxs(pt, 2)

    def trainer(opt="sgd", ctx=ctxs, **kw):
        net = pt.gluon.nn.Dense(4, in_units=4, prefix="e_")
        net.initialize(ctx=ctx)
        tr = pt.gluon.Trainer(net.collect_params(), opt,
                              {"learning_rate": 0.01}, **kw)
        tr._contexts = tr._check_contexts()
        return net, tr
    _, tr = trainer(ctx=[pt.cpu(0)])
    assert zero_mod.eligibility(tr)[1].startswith("single replica")
    _, tr = trainer()
    tr._contexts = [pt.cpu(1), pt.cpu(1)]
    assert "share a device" in zero_mod.eligibility(tr)[1]
    _, tr = trainer()
    tr._update_on_kvstore = True
    assert "update_on_kvstore" in zero_mod.eligibility(tr)[1]
    _, tr = trainer()
    tr._init_kvstore()
    tr._kvstore = object()
    assert "not the in-process store" in zero_mod.eligibility(tr)[1]
    _, tr = trainer(compression_params={"type": "2bit", "threshold": 0.5})
    assert "compression" in zero_mod.eligibility(tr)[1]
    for opt in ("lamb", "adamw", "nag", "rmsprop"):
        _, tr = trainer(opt)
        assert "fragment form" in zero_mod.eligibility(tr)[1], opt
    _, tr = trainer()
    tr._optimizer.multi_precision = True
    assert "fragment form" in zero_mod.eligibility(tr)[1]
    net, tr = trainer()
    net.weight.grad_req = "add"
    assert "grad_req='add'" in zero_mod.eligibility(tr)[1]
    net, tr = trainer()
    for p in net.collect_params().values():
        p.grad_req = "null"
    assert zero_mod.eligibility(tr)[1] == \
        "no initialized trainable parameters"
    _, tr = trainer()
    assert zero_mod.eligibility(tr) == (True, None)
    os.environ["MXNET_ZERO_MIN_SIZE"] = "1000000"
    assert "too small" in zero_mod.eligibility(tr)[1]
    os.environ["MXNET_ZERO"] = "0"
    assert zero_mod.eligibility(tr) == (False, None)


@pytest.mark.parametrize("case", ["lamb", "min_size", "single"])
def test_zero_fallback_stays_replicated_with_reason(case, caplog,
                                                    monkeypatch):
    kw = {"learning_rate": 0.01}
    opt = "lamb" if case == "lamb" else "sgd"
    ndev = 1 if case == "single" else 4
    if case == "min_size":
        monkeypatch.setenv("MXNET_ZERO_MIN_SIZE", "1000000")
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.zero"):
        net_z, tr_z, ctx_z = build(pt, True, ndev=ndev, opt=opt, opt_kw=kw)
        run(pt, net_z, tr_z, ctx_z, 2)
    assert tr_z._zero is False and tr_z._zero_bailed
    msgs = [r.getMessage() for r in caplog.records
            if "not eligible" in r.getMessage()]
    assert len(msgs) == 1
    assert {"lamb": "fragment form", "min_size": "too small",
            "single": "single replica"}[case] in msgs[0]
    net_r, tr_r, ctx_r = build(mx, False, ndev=ndev, opt=opt, opt_kw=kw)
    run(mx, net_r, tr_r, ctx_r, 2)
    assert_parity(net_z, ctx_z[0], net_r, ctx_r[0])


def test_zero_structural_bail_dissolves_state(caplog):
    """A parameter set that changes mid-run (a BAIL) hands the sharded
    momentum to the replicated updaters, counted and warned once."""
    kw = {"learning_rate": 0.05, "momentum": 0.9}
    net, tr, ctxs = build(pt, True, opt="sgd", opt_kw=kw)
    run(pt, net, tr, ctxs, 2)
    eng = tr._zero
    moms = {k: v.asnumpy() for k, v in eng.gather_states().items()}
    first = list(net.collect_params().values())[0]
    first.grad_req = "null"
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.zero"):
        run(pt, net, tr, ctxs, 1)
    assert tr._zero is False and tr._zero_bailed
    assert any("structural change" in r.getMessage()
               for r in caplog.records)
    # the other parameters' momentum carried over
    assert sorted(tr._updaters[0].states) == sorted(moms)


# ---------------------------------------------------------------------------
# memory accounting and observability
# ---------------------------------------------------------------------------
def test_zero_state_memory_and_gauges(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    pt.telemetry.reset()
    kw = {"learning_rate": 0.01}
    ndev = 4
    net_z, tr_z, ctx_z = build(pt, True, ndev=ndev, opt="adam", opt_kw=kw)
    run(pt, net_z, tr_z, ctx_z, 1)
    net_r, tr_r, ctx_r = build(pt, False, ndev=ndev, opt="adam", opt_kw=kw,
                               prefix="p_")
    run(pt, net_r, tr_r, ctx_r, 1)
    zb, rb = tr_z.optimizer_state_bytes(), tr_r.optimizer_state_bytes()
    assert rb == 2 * 4 * 58 * ndev
    assert 0 < zb <= rb / ndev * 1.5, (zb, rb)
    snap = pt.telemetry.snapshot()
    keys = [k for k in snap["gauges"] if k.startswith("mx_zero_state_bytes")]
    assert len(keys) == ndev, snap["gauges"]
    saved = [v for k, v in snap["gauges"].items()
             if k.startswith("mx_zero_state_saved_bytes")]
    assert len(saved) == ndev and all(v > 0 for v in saved)


def test_zero_program_watch_and_comm(monkeypatch):
    """One watched step program a step, its RS and AG on the dp axis, and
    RS + AG bus bytes equal to one all-reduce's on the padded payload."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    pt.telemetry.reset()
    pt.commwatch.reset()
    net, tr, ctxs = build(pt, True, opt="sgd",
                          opt_kw={"learning_rate": 0.05, "momentum": 0.9})
    run(pt, net, tr, ctxs, 3)
    assert pt.commwatch.program_execs(tr._zero._watch_key("step")) == 3
    rows = {(r["op"], r["axis"]): r for r in pt.commwatch.report()}
    rs, ag = rows[("reduce_scatter", "dp")], rows[("allgather", "dp")]
    assert rs["bytes"] > 0 and ag["bytes"] > 0
    n = len(ctxs)
    padded = sum(g.C * n * 4 for g in tr._zero._groups)
    assert rs["bytes"] == 3 * padded
    assert ag["bytes"] == 3 * padded


def test_zero_modelwatch_report_deferred(monkeypatch):
    """With modelwatch sampling, a ZeRO step's per-parameter report (its
    grad, weight and update norms) is read at the next sampled step."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_MODELWATCH", "1")
    pt.telemetry.refresh()
    pt.modelwatch.reset()
    try:
        net, tr, ctxs = build(pt, True, opt="sgd",
                              opt_kw={"learning_rate": 0.05})
        run(pt, net, tr, ctxs, 3)
        mw = tr.modelwatch
        assert isinstance(tr._zero, zero_mod.ZeroEngine)
        # three sampled steps: two reports read (the last one pending)
        assert mw.samples == 2 and mw.sync_count == 2
        assert tr._zero._mw_pending is not None
        last = mw.last
        assert len(last["names"]) == 4
        assert all(np.isfinite(v) and v > 0 for v in last["grad_norms"])
        assert all(r is not None for r in last["update_ratios"])
    finally:
        pt.modelwatch.reset()
