"""The quantized gradient wire in the port
(``mxnet_tpu_torch/parallel/quantize.py``, the kvstore's quantized
grouped reduce, ZeRO's quantized reduce-scatter and all-gather) against
the reference's host-side functions and the contracts of its
``tests/test_quantize.py``.

The reference's quantized collectives (its shard_map programs) cannot
run on this JAX, but its blockwise ``quantize_rows`` can: the port's is
held to it bit for bit on the same numpy rows. The collectives are held
to the error-feedback identity

    sum_t out_t == sum_t sum_r grad_{r,t} + (res_0 - res_K)

to a ulp-scaled tolerance (1e-5 relative) on the flat, the hierarchical
and the kvstore paths and on ZeRO's reduce-scatter. Stochastic rounding
draws from torch generators, so it is held by distribution: the mean
rounding error of 2^20 elements within 3e-3 of a grid step of zero.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.parallel import quantize as rq
from mxnet_tpu_torch.parallel import quantize as pq
from mxnet_tpu_torch.parallel import collectives as pcoll
from mxnet_tpu_torch import parallel as ppar

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    pt.telemetry.refresh()
    yield
    for var in ("MXNET_ZERO", "MXNET_ZERO_DCN"):
        os.environ.pop(var, None)
    pt.telemetry.refresh()
    pt.telemetry.reset()
    pt.commwatch.reset()


def _rows(seed, m=5, L=1000):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, L) * rng.choice([1e-3, 1.0, 100.0], size=(m, 1))) \
        .astype(np.float32)
    x[1, :300] = 0.0                  # all-zero blocks
    return x


def _q_bytes(q):
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.itemsize == 1 else q


# ---------------------------------------------------------------------------
# the blockwise quantizer, bit for bit with the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [None, np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_rows_bitwise_with_the_reference(mode, block, bad):
    x = _rows(block + (0 if bad is None else 1))
    if bad is not None:
        x[2, 70] = bad
        x[3, 999] = bad               # in the padded last block
    rc, pc = rq.QuantConfig(mode=mode, block=block), \
        pq.QuantConfig(mode=mode, block=block)
    q1, s1, e1 = [np.asarray(a) for a in rq.quantize_rows(jnp.asarray(x),
                                                          rc)]
    q2, s2, e2 = pq.quantize_rows(torch.from_numpy(x), pc)
    assert q2.dtype == pq.wire_dtype(pc)
    assert q2.shape == q1.shape == (5, pq.padded_cols(1000, pc))
    # every byte: the poisoned blocks' values are 0 in both (NaN -> 0)
    assert _q_bytes(q1).tobytes() == \
        _q_bytes(q2.view(torch.uint8).numpy() if mode == "fp8"
                 else q2.numpy()).tobytes()
    assert np.array_equal(s1, s2.numpy(), equal_nan=True)
    assert e1.tobytes() == e2.numpy().tobytes()
    d1 = np.asarray(rq.dequantize_rows(jnp.asarray(q1), jnp.asarray(s1),
                                       rc))
    d2 = pq.dequantize_rows(q2, s2, pc).numpy()
    assert np.array_equal(d1, d2, equal_nan=True)
    if bad is not None:
        # a non-finite block poisons its own dequantized block only, and
        # never the carried error
        blk = d2[2].reshape(-1, block)
        assert np.isnan(blk[70 // block]).all()
        assert np.isfinite(np.delete(blk, 70 // block, axis=0)).all()
        assert np.isfinite(e2.numpy()).all()
    # all-zero blocks: scale 1, exact zeros
    assert (s2.numpy()[1, :300 // block] == 1.0).all()


def test_quantize_rows_bf16_and_grid_roundtrip():
    """bf16 rows quantize as the reference's do; values already on the
    int8 grid round-trip bit for bit."""
    import ml_dtypes
    x = _rows(3, m=2, L=512)
    xb = x.astype(ml_dtypes.bfloat16)
    cfg_r, cfg_p = rq.QuantConfig(block=128), pq.QuantConfig(block=128)
    q1, s1, e1 = [np.asarray(a) for a in rq.quantize_rows(jnp.asarray(xb),
                                                          cfg_r)]
    q2, s2, e2 = pq.quantize_rows(
        torch.from_numpy(x).to(torch.bfloat16), cfg_p)
    assert q1.tobytes() == q2.numpy().tobytes()
    assert e1.tobytes() == e2.numpy().tobytes()
    grid = (np.random.RandomState(0).randint(-127, 128, (3, 256))
            .astype(np.float32) * np.float32(0.5))
    grid[:, 0] = 63.5                  # absmax on the grid: scale 0.5
    q, s, e = pq.quantize_rows(torch.from_numpy(grid),
                               pq.QuantConfig(block=256))
    assert pq.dequantize_rows(q, s, pq.QuantConfig(block=256)).numpy() \
        .tobytes() == grid.tobytes()
    assert not e.numpy().any()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_numpy_reference_equals_the_reference(mode):
    x = _rows(7, m=2, L=777)[0]
    for block in (64, 256):
        a = rq.np_reference_quantize(x, rq.QuantConfig(mode=mode,
                                                       block=block))
        b = pq.np_reference_quantize(x, pq.QuantConfig(mode=mode,
                                                       block=block))
        for u, v in zip(a, b):
            assert u.tobytes() == v.tobytes()
        q, s, e = pq.quantize_rows(torch.from_numpy(x[None]),
                                   pq.QuantConfig(mode=mode, block=block))
        assert e.numpy()[0].tobytes() == b[1].tobytes()


def test_config_and_environment(monkeypatch):
    assert pq.from_env() is None
    with pytest.raises(ValueError, match="expected one of"):
        pq.QuantConfig(mode="int4")
    with pytest.raises(ValueError, match="TIER"):
        pq.QuantConfig(tier="ici")
    with pytest.raises(ValueError, match="BLOCK"):
        pq.QuantConfig(block=4)
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "fp8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_BLOCK", "64")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_TIER", "all")
    cfg = pq.from_env()
    assert cfg == pq.QuantConfig(mode="fp8", block=64, tier="all")
    assert cfg.key() == rq.from_env().key()
    assert pq.wire_dtype(cfg) is torch.float8_e4m3fn
    assert pq.active_mode() == "fp8"
    assert pq.MODES == rq.MODES and pq.TIERS == rq.TIERS


def test_stochastic_rounding_is_unbiased():
    """int8 stochastic rounding: the mean error of 2^20 elements, in grid
    steps, within 3e-3 of 0 (about 6 standard errors; round to nearest
    is biased on this data by construction: every value sits 0.3 of a
    step above a grid point)."""
    n = 1 << 20
    base = np.random.RandomState(0).randint(-100, 100, n) \
        .astype(np.float32)
    x = (base + np.float32(0.3)).reshape(1, n)
    x[0, 0] = 127.0                     # scale 1 for the first block
    cfg = pq.QuantConfig(block=n, stochastic=True)
    q, s, e = pq.quantize_rows(torch.from_numpy(x), cfg, key=1234)
    err = e.numpy().astype(np.float64)[0, 1:]
    assert abs(err.mean()) < 3e-3, err.mean()
    q2, _, _ = pq.quantize_rows(torch.from_numpy(x), cfg, key=1234)
    assert torch.equal(q, q2)           # seeded: deterministic
    q3, _, _ = pq.quantize_rows(torch.from_numpy(x), cfg, key=99)
    assert not torch.equal(q, q3)
    _, _, en = pq.quantize_rows(torch.from_numpy(x),
                                pq.QuantConfig(block=n))
    assert abs(en.numpy()[0, 1:].mean() - 0.3) < 1e-3


# ---------------------------------------------------------------------------
# the error-feedback identity on every path
# ---------------------------------------------------------------------------
def _cpus(n):
    return [pt.cpu(i) for i in range(n)]


def _identity_run(mesh, spec, cfg, steps, dcn, seed=0, size=300):
    """K quantized all-reduces of random gradients with the residual
    carried; returns (sum of outputs, sum of true sums, res_0, res_K)
    summed over replicas (float64)."""
    n = mesh.size
    rng = np.random.RandomState(seed)
    res = np.zeros((n, size), np.float32)
    res0 = res.astype(np.float64).sum(0)
    tot_out = np.zeros(size)
    tot_true = np.zeros(size)

    def body(g, r):
        out, new = pcoll.hierarchical_allreduce(
            g[0], "dp", dcn, quant=cfg, residual=r[0])
        return out[None], new[None]
    f = ppar.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec))
    for _ in range(steps):
        g = (rng.randn(n, size) * rng.choice([0.01, 1, 30], (n, 1))) \
            .astype(np.float32)
        out, new = f(g, res)
        out, res = out.asnumpy(), new.asnumpy()
        # every replica holds the same output
        assert all(out[i].tobytes() == out[0].tobytes() for i in range(n))
        tot_out += out[0]
        tot_true += g.astype(np.float64).sum(0)
    return tot_out, tot_true, res0, res.astype(np.float64).sum(0)


@pytest.mark.parametrize("path", ["flat", "dcn", "all"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_residual_identity_flat_and_hierarchical(mode, path):
    if path == "flat":
        mesh = ppar.make_mesh(ppar.MeshConfig(dp=4), devices=_cpus(4))
        spec, dcn = ppar.P("dp"), None
    else:
        mesh = ppar.make_mesh(ppar.MeshConfig(dcn=2, dp=2),
                              devices=_cpus(4))
        spec, dcn = ppar.P(("dcn", "dp")), "dcn"
    cfg = pq.QuantConfig(mode=mode, block=32,
                         tier="all" if path == "all" else "dcn")
    out, true, res0, resk = _identity_run(mesh, spec, cfg, 5, dcn)
    scale = np.maximum(np.abs(true), 1.0)
    assert (np.abs(out - (true + res0 - resk)) / scale).max() < 1e-5
    # the quantized sum is near the true one, and not equal to it
    assert not np.array_equal(out, true)


def test_kvstore_residual_identity_and_export(monkeypatch):
    """The kvstore's quantized grouped reduce over 4 contexts, 5 steps:
    the identity per key, and the export sums the per-device residuals
    (restoring it into a new store keeps the sum)."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_BLOCK", "32")
    kv = pt.kvstore.create("device")
    shapes = {"a": (7, 9), "b": (40,)}
    for k, s in shapes.items():
        kv.init(k, pt.nd.zeros(s, ctx=pt.cpu()))
    rng = np.random.RandomState(3)
    tot_out = {k: np.zeros(s) for k, s in shapes.items()}
    tot_true = {k: np.zeros(s) for k, s in shapes.items()}
    for _ in range(5):
        vals = {k: [rng.randn(*s).astype(np.float32) for _ in range(4)]
                for k, s in shapes.items()}
        nds = [[pt.nd.array(v, ctx=pt.cpu(i))
                for i, v in enumerate(vals[k])] for k in shapes]
        kv.pushpull_list(list(shapes), nds)
        for k, reps in zip(shapes, nds):
            assert all(r.asnumpy().tobytes() == reps[0].asnumpy().tobytes()
                       for r in reps)
            tot_out[k] += reps[0].asnumpy()
            tot_true[k] += np.sum(vals[k], axis=0, dtype=np.float64)
    res = kv.quant_residuals_export()
    for k in shapes:
        r = res[k].reshape(shapes[k]).astype(np.float64)
        scale = np.maximum(np.abs(tot_true[k]), 1.0)
        assert (np.abs(tot_out[k] + r - tot_true[k]) / scale).max() < 1e-5
    kv2 = pt.kvstore.create("device")
    for k, s in shapes.items():
        kv2.init(k, pt.nd.zeros(s, ctx=pt.cpu()))
    kv2.quant_residuals_restore(res)
    z = [[pt.nd.zeros(s, ctx=pt.cpu(i)) for i in range(4)]
         for s in shapes.values()]
    kv2.pushpull_list(list(shapes), z)
    back = kv2.quant_residuals_export()
    for k in shapes:
        # zeros in: out + new residuals = the restored sum
        tot = z[list(shapes).index(k)][0].asnumpy().reshape(-1) + back[k]
        np.testing.assert_allclose(tot, res[k], rtol=1e-5, atol=1e-6)


def test_kvstore_commwatch_wire_dtype_bytes(monkeypatch):
    """commwatch records the quantized reduce at its wire dtype: int8
    payload bytes, a quarter of the f32 wire's (the scales ride as
    f32, one a block)."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_BLOCK", "256")
    pt.telemetry.refresh()
    pt.commwatch.reset()
    kv = pt.kvstore.create("device")
    kv.init("w", pt.nd.zeros((4096,), ctx=pt.cpu()))
    reps = [pt.nd.ones((4096,), ctx=pt.cpu(i)) for i in range(4)]
    kv.pushpull_list(["w"], [reps])
    rows = pt.commwatch.report()
    int8 = [r for r in rows if r.get("dtype") == "int8"]
    assert {r["op"] for r in int8} == {"all_to_all", "allgather"}
    a2a = [r for r in int8 if r["op"] == "all_to_all"][0]
    assert a2a["bytes"] == 4096            # one int8 payload a replica
    f32 = [r for r in rows if r.get("dtype") == "f32"
           and r["op"] == "all_to_all"][0]
    assert f32["bytes"] == 4096 // 256 * 4  # its scales


def test_trainer_compression_converges_within_2pct(monkeypatch):
    """Trainer(compression_params={'type': '2bit'}) (the int8 wire with
    error feedback) over 4 contexts: 20 SGD steps land within 2% of the
    f32 run's final loss (the reference's
    test_trainer_kvstore_convergence_within_2pct), and
    MXNET_KVSTORE_QUANTIZE=int8 does the same."""
    monkeypatch.setattr(pt.kvstore, "_COMPRESSION_WARNED", True)
    ctxs = _cpus(4)
    w = [np.random.RandomState(21).randn(*s).astype(np.float32) * 0.3
         for s in ((32, 16), (32,), (8, 32), (8,))]

    def run(compress=None, env=None):
        if env:
            monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", env)
        else:
            monkeypatch.delenv("MXNET_KVSTORE_QUANTIZE", raising=False)
        net = pt.gluon.nn.HybridSequential(prefix="q_")
        with net.name_scope():
            net.add(pt.gluon.nn.Dense(32, in_units=16, activation="relu"),
                    pt.gluon.nn.Dense(8, in_units=32))
        net.initialize(ctx=ctxs)
        for p, a in zip(net.collect_params().values(), w):
            p.set_data(pt.nd.array(a, ctx=pt.cpu()))
        kw = {"compression_params": compress} if compress else {}
        tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05}, kvstore="device",
                              **kw)
        rng = np.random.RandomState(22)
        X = rng.rand(16, 16).astype(np.float32)
        Y = (X[:, :8] * 2 - 0.5).astype(np.float32)
        last = None
        for _ in range(20):
            xs = pt.gluon.utils.split_and_load(
                pt.nd.array(X, ctx=pt.cpu()), ctxs)
            ys = pt.gluon.utils.split_and_load(
                pt.nd.array(Y, ctx=pt.cpu()), ctxs)
            with pt.autograd.record():
                ls = [((net(x) - y) ** 2).mean() for x, y in zip(xs, ys)]
            for l in ls:
                l.backward()
            tr.step(16)
            last = float(np.mean([l.asnumpy().item() for l in ls]))
        return last, tr

    l_f32, _ = run()
    l_c, tr_c = run(compress={"type": "2bit", "threshold": 0.5})
    assert tr_c._kvstore._quant_state, "compression did not quantize"
    l_q, _ = run(env="int8")
    assert abs(l_c - l_f32) / l_f32 < 0.02, (l_c, l_f32)
    assert abs(l_q - l_f32) / l_f32 < 0.02, (l_q, l_f32)
    assert l_c != l_f32


def test_trainer_checkpoint_carries_kv_residual(monkeypatch, tmp_path):
    """A quantized kvstore Trainer's states blob is the reference's
    wrapper with the residuals; a new Trainer restores them, and the
    reference's Trainer reads the blob's states."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    from test_torch_zero import build, run
    net, tr, ctxs = build(pt, False, opt="sgd",
                          opt_kw={"learning_rate": 0.05, "momentum": 0.9})
    run(pt, net, tr, ctxs, 2)
    blob = tr.states_blob()
    obj = pt.optimizer.loads_states(blob)
    assert obj["__mx_quant__"] == 1 and sorted(obj["kv_residual"]) == \
        ["0", "1", "2", "3"]
    net2, tr2, _ = build(pt, False, opt="sgd", prefix="p_",
                         opt_kw={"learning_rate": 0.05, "momentum": 0.9})
    tr2.load_states_blob(blob)
    assert sorted(tr2._kvstore._quant_restore) == ["0", "1", "2", "3"]
    f = tmp_path / "q.states"
    f.write_bytes(blob)
    net_r, tr_r, _ = build(mx, False, opt="sgd",
                           opt_kw={"learning_rate": 0.05, "momentum": 0.9})
    tr_r.load_states(str(f))
    assert sorted(tr_r._updaters[0].states) == [0, 1, 2, 3]


def test_nonfinite_step_does_not_poison_residual(monkeypatch):
    """A NaN gradient under the kvstore's wire: the guard sees the
    poisoned block, names the mode in its event and skips the step; the
    residual stays finite and the next steps run."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", "skip_step")
    events = []
    unsub = pt.guardrails.on_event(events.append)
    try:
        from test_torch_zero import build, run
        net, tr, ctxs = build(pt, False, opt="sgd",
                              opt_kw={"learning_rate": 0.05})
        run(pt, net, tr, ctxs, 3, poison_step=1)
    finally:
        unsub()
    assert tr.grad_guard.skipped_steps == 1
    nf = [e for e in events if e["kind"] == "nonfinite"]
    assert nf and nf[0]["quantize"] == "int8"
    for ent in tr._kvstore._quant_state.values():
        for r in ent["res"]:
            assert torch.isfinite(r).all()
    for p in net.collect_params().values():
        assert np.isfinite(p.data(ctxs[0]).asnumpy()).all()


# ---------------------------------------------------------------------------
# ZeRO on the wire
# ---------------------------------------------------------------------------
def _zero_net(ndev=4, dcn=0, opt_kw=None, prefix="z_"):
    from test_torch_zero import build
    return build(pt, True, ndev=ndev, opt="sgd", dcn=dcn, prefix=prefix,
                 opt_kw=opt_kw or {"learning_rate": 0.05, "momentum": 0.9})


@pytest.mark.parametrize("dcn", [0, 2])
def test_zero_residual_identity(dcn, monkeypatch):
    """ZeRO's quantized reduce-scatter, 4 rounds of random per-replica
    gradients: the sum of the scattered shards plus the replica-summed
    residual equals the true sums plus the first residual, per fragment
    in the engine's layout."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_BLOCK", "8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_TIER", "all")
    from test_torch_zero import run
    net, tr, ctxs = _zero_net(dcn=dcn)
    run(pt, net, tr, ctxs, 1)
    eng = tr._zero
    assert eng._quant is not None and eng._n_dcn == (dcn or 1)
    n, g0 = eng._n, eng._groups[0]
    rng = np.random.RandomState(42)

    def res_sum():
        return sum(eng._gres[0][p].numpy().astype(np.float64)
                   .reshape(n, g0.C) for p in range(n))

    def gmat(grads):
        cols = []
        for it in g0.items:
            gg = np.zeros(it.frag * n, np.float32)
            gg[:it.size] = grads[it.pos].reshape(-1)
            cols.append(gg.reshape(n, it.frag))
        return np.concatenate(cols, axis=1)
    res0 = res_sum()
    tot_sh = np.zeros((n, g0.C))
    tot_true = np.zeros((n, g0.C))
    for _ in range(4):
        per = [[rng.randn(*it.shape).astype(np.float32) * 3
                for it in eng._items] for _ in range(n)]
        ts = [[torch.from_numpy(a) for a in g] for g in per]

        def body(m, p):
            shards, gres = eng._reduce(p, ts[p], None)
            eng._gres[0][p].copy_(gres[0])
            return shards[0]
        out = eng._run(body)
        for p in range(n):
            tot_sh[eng._owner[p]] += out[p].numpy()
        tot_true += sum(gmat(g) for g in per)
    scale = np.maximum(np.abs(tot_true), 1.0)
    assert (np.abs(tot_sh + res_sum() - (tot_true + res0)) / scale).max() \
        < 1e-5


@pytest.mark.parametrize("dcn", [0, 2])
def test_zero_quant_converges_and_records_int8(dcn, monkeypatch):
    """ZeRO with MXNET_KVSTORE_QUANTIZE=int8 (flat and dcn=2): replicas
    bit for bit, 10 steps within 2% of the f32 ZeRO run's weights'
    loss proxy, and commwatch's RS/AG payloads at int8."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    from test_torch_zero import run, replicas_equal, weights
    net_f, tr_f, ctx_f = _zero_net(dcn=dcn, prefix="f_")
    run(pt, net_f, tr_f, ctx_f, 10)
    pt.commwatch.reset()
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_BLOCK", "16")
    net_q, tr_q, ctx_q = _zero_net(dcn=dcn, prefix="q_")
    run(pt, net_q, tr_q, ctx_q, 10,
        check=lambda s: replicas_equal(net_q, ctx_q))
    for a, b in zip(weights(net_q, ctx_q[0]), weights(net_f, ctx_f[0])):
        assert np.linalg.norm(a - b) <= 0.02 * np.linalg.norm(b)
    rows = pt.commwatch.report()
    assert any(r["op"] == "all_to_all" and r.get("dtype") == "int8"
               and r["bytes"] > 0 for r in rows)
    assert any(r["op"] == "allgather" and r.get("dtype") == "int8"
               and r["bytes"] > 0 for r in rows)


def test_zero_quant_checkpoint_cross_topology(monkeypatch, tmp_path):
    """A quantized ZeRO checkpoint carries its residuals in parameter
    space; loaded on 2 replicas and gathered again, the grad residual's
    sum and the weight residual come back exactly, and a replicated
    Trainer reads the blob's states."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_BLOCK", "8")
    from test_torch_zero import build, run
    net, tr, ctxs = _zero_net()
    run(pt, net, tr, ctxs, 3)
    blob = tr.states_blob()
    obj = pt.optimizer.loads_states(blob)
    assert obj["__mx_zero_quant__"] == 1
    gres, wres = tr._zero._gathered_residuals()
    net2, tr2, _ = _zero_net(ndev=2, prefix="t_")
    tr2.load_states_blob(blob)
    g2, w2 = tr2._zero._gathered_residuals()
    for k in gres:
        assert g2[k].tobytes() == gres[k].tobytes()
        assert w2[k].tobytes() == wres[k].tobytes()
    os.environ["MXNET_ZERO"] = "0"
    net3, tr3, _ = build(pt, False, opt="sgd", prefix="r_",
                         opt_kw={"learning_rate": 0.05, "momentum": 0.9})
    tr3.load_states_blob(blob)
    assert sorted(tr3._updaters[0].states) == [0, 1, 2, 3]
    assert sorted(tr3._kvstore._quant_restore) == ["0", "1", "2", "3"]


def test_zero_nonfinite_names_the_mode(monkeypatch):
    """ZeRO on the wire with a skip_step guard: the NaN step is skipped,
    its event names int8, the residuals stay finite, the run goes on."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", "skip_step")
    events = []
    unsub = pt.guardrails.on_event(events.append)
    try:
        from test_torch_zero import run
        net, tr, ctxs = _zero_net()
        run(pt, net, tr, ctxs, 3, poison_step=1)
    finally:
        unsub()
    assert tr.grad_guard.skipped_steps == 1
    assert [e["quantize"] for e in events if e["kind"] == "nonfinite"] \
        == ["int8"]
    eng = tr._zero
    for bufs in eng._gres + eng._wres:
        for b in bufs:
            assert torch.isfinite(b).all()
    for p in net.collect_params().values():
        assert np.isfinite(p.data(ctxs[0]).asnumpy()).all()


def test_zero_stochastic_rounding_wired(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE_STOCHASTIC", "1")
    from test_torch_zero import run, replicas_equal
    net, tr, ctxs = _zero_net()
    run(pt, net, tr, ctxs, 3, check=lambda s: replicas_equal(net, ctxs))
    assert tr._zero._quant.stochastic and tr._zero._qstep == 3
