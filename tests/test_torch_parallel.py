"""``mxnet_tpu_torch.parallel`` (meshes, the collectives, ``shard_map``
and ``ShardedTrainStep``) against the reference's ``tests/test_parallel.py``
case by case (its pipeline and MoE cases excepted: those modules are not
ported). The reference runs on the 8 virtual CPU devices of
``tests/conftest.py``; the port on ``cpu(0)...cpu(7)`` with the same mesh
shapes, one thread a device. Inputs come from numpy seeds; the port's
nets take the reference's initial weights.

Tolerances: the collectives' outputs exactly; a step's parameters within
rtol 1e-5 of the reference's (f32 sums in another order); the tiny BERT
encoder's 5 losses within rtol 1e-4 (its GSPMD program splits the tp
products, the port replicates them).
"""
import numpy as np
import pytest

import jax

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import parallel as rpar
from mxnet_tpu_torch import parallel as ppar
from mxnet_tpu_torch.parallel import collectives as pcoll
from mxnet_tpu.parallel import collectives as rcoll

CPUS = [pt.cpu(i) for i in range(8)]
TOL = dict(rtol=1e-5, atol=1e-6)


def pmesh(n=None, **axes):
    devs = CPUS if n is None else CPUS[:n]
    return ppar.make_mesh(ppar.MeshConfig(**axes), devices=devs)


def rmesh(n=None, **axes):
    devs = jax.devices() if n is None else jax.devices()[:n]
    return rpar.make_mesh(rpar.MeshConfig(**axes), devices=devs)


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(jax.device_get(x))


def carry(rnet, pnet):
    """The reference net's weights into the port's net of the same
    names."""
    arrays = {k: p.data().asnumpy()
              for k, p in rnet.collect_params().items()}
    assert sorted(arrays) == sorted(pnet.collect_params().keys())
    pt.params_from_numpy(pnet, arrays, ctx=pt.cpu())


def mlp(lib, widths, prefix, in_units, dropout=None, act="relu"):
    """A HybridSequential of Dense layers named ``<prefix><i>_`` (a
    Dropout after the first with ``dropout``)."""
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    units = in_units
    for i, w in enumerate(widths):
        last = i == len(widths) - 1
        net.add(nn.Dense(w, activation=None if last else act,
                         in_units=units, prefix="%s%d_" % (prefix, i)))
        if dropout is not None and i == 0:
            net.add(nn.Dropout(dropout))
        units = w
    return net


def twin(build, seed=0):
    """``(reference net, port net)`` of ``build(lib)``, the port's with
    the reference's Xavier weights."""
    mx.random.seed(seed)
    rnet = build(mx)
    rnet.initialize(init=mx.initializer.Xavier())
    pnet = build(pt)
    pnet.initialize(ctx=pt.cpu())
    carry(rnet, pnet)
    return rnet, pnet


def assert_params(step_p, step_r, tol=TOL):
    got = {k: _np(v) for k, v in step_p.params.items()}
    want = {k: _np(v) for k, v in step_r.params.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def test_make_mesh(monkeypatch):
    mesh = pmesh(dp=4, tp=2)
    assert mesh.shape["dp"] == 4 and mesh.shape["tp"] == 2
    assert tuple(mesh.axis_names) == tuple(rmesh(dp=4, tp=2).axis_names)
    monkeypatch.setenv("MXNET_DIST_CPU_DEVICES", "8")
    mesh2 = ppar.make_mesh()
    assert mesh2.shape["dp"] == 8
    assert [d.context for d in mesh2.devices.flat] == CPUS
    with pytest.raises(ValueError, match="mesh needs 16 devices but only 8"):
        ppar.make_mesh(ppar.MeshConfig(dp=16), devices=CPUS)


def test_dcn_mesh_axes_and_batch_axes():
    mesh = pmesh(dcn=2, dp=2, tp=2)
    assert tuple(mesh.axis_names) == ("dcn", "dp", "tp")
    assert ppar.batch_axes(mesh) == ("dcn", "dp") == \
        rpar.batch_axes(rmesh(dcn=2, dp=2, tp=2))
    devs = mesh.devices
    assert {d.id for d in devs[0].flat} == {0, 1, 2, 3}
    assert {d.id for d in devs[1].flat} == {4, 5, 6, 7}
    assert ppar.batch_axes(pmesh(dp=8)) == "dp"


def test_dcn_axis_across_processes_warns_when_not_grouped():
    from mxnet_tpu_torch.parallel.mesh import Device
    grouped = [Device(i, i // 2, pt.cpu(i % 2)) for i in range(4)]
    ppar.make_mesh(ppar.MeshConfig(dcn=2, dp=2), devices=grouped)
    mixed = [Device(i, i % 2, pt.cpu(i // 2)) for i in range(4)]
    with pytest.warns(RuntimeWarning, match="does NOT group the dcn"):
        ppar.make_mesh(ppar.MeshConfig(dcn=2, dp=2), devices=mixed)


# ---------------------------------------------------------------------------
# shard_map and every collective, against the reference's outputs exactly
# ---------------------------------------------------------------------------
X8 = np.arange(8 * 6, dtype=np.float32).reshape(8, 6) - 7.0

CASES = {
    "allreduce_sum": lambda c, v: c.allreduce_sum(v, "dp"),
    "allreduce_mean": lambda c, v: c.allreduce_mean(v, "dp"),
    "allgather": lambda c, v: c.allgather(v, "dp")[None],
    "allgather_untiled": lambda c, v: c.allgather(v[0], "dp", tiled=False)[
        None],
    "reduce_scatter": lambda c, v: c.reduce_scatter(
        c.allgather(v, "dp"), "dp"),
    "ring_permute": lambda c, v: c.ring_permute(v, "dp"),
    "ring_permute_back": lambda c, v: c.ring_permute(v, "dp", shift=-3),
    "all_to_all_tiled": lambda c, v: c.all_to_all(
        c.allgather(v, "dp"), "dp", 0, 0, tiled=True),
    "all_to_all": lambda c, v: c.all_to_all(
        c.allgather(v, "dp")[:, :4], "dp", 0, 1)[None],
    "pad_to_multiple": lambda c, v: c.pad_to_multiple(v, 4, axis=1)[:, 4:],
}


def _shard_map(lib, coll, fn, mesh, spec_in, spec_out, *args):
    f = lib.parallel.shard_map(lambda *v: fn(coll, *v), mesh=mesh,
                               in_specs=spec_in, out_specs=spec_out)
    return _np(f(*args))


@pytest.mark.parametrize("case", sorted(CASES))
def test_collectives_shard_map(case):
    fn = CASES[case]
    want = _shard_map(mx, rcoll, fn, rmesh(dp=8), rpar.P("dp"),
                      rpar.P("dp"), X8)
    got = _shard_map(pt, pcoll, fn, pmesh(dp=8), ppar.P("dp"),
                     ppar.P("dp"), X8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_collectives_reference_contract():
    """The reference's own case (allreduce sums, ring_permute rolls),
    the axis queries and barrier_sum on a dp x tp mesh."""
    x = np.arange(8, dtype=np.float32)
    mesh = pmesh(dp=8)
    out = _shard_map(pt, pcoll, CASES["allreduce_sum"], mesh, ppar.P("dp"),
                     ppar.P("dp"), x)
    assert (out == x.sum()).all()
    rolled = _shard_map(pt, pcoll, CASES["ring_permute"], mesh,
                        ppar.P("dp"), ppar.P("dp"), x)
    assert (rolled == np.roll(x, 1)).all()

    def probe(c, v):
        n = c.barrier_sum("tp")
        idx = c.shard_owner_index("tp", "dp")
        return v * 0 + (n.asnumpy().item() * 100 + idx * 10
                        + c.axis_size(("dp", "tp")))
    got = _shard_map(pt, pcoll, probe, pmesh(dp=4, tp=2),
                     ppar.P(("dp", "tp")), ppar.P(("dp", "tp")), x)
    want = [200 + 10 * (t * 4 + d) + 8 for d in range(4) for t in range(2)]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(pt.MXNetError, match="inside shard_map"):
        pcoll.allreduce_sum(pt.nd.ones((2,), ctx=pt.cpu()), "dp")


def test_hierarchical_allreduce_exact():
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    outs = []
    for lib, coll, mesh, P in ((mx, rcoll, rmesh(dcn=2, dp=4), rpar.P),
                               (pt, pcoll, pmesh(dcn=2, dp=4), ppar.P)):
        spec = P(("dcn", "dp"))
        outs.append(_shard_map(
            lib, coll, lambda c, v: c.hierarchical_allreduce(
                v[0], "dp", "dcn")[None], mesh, spec, spec, x))
    want = np.broadcast_to(x.sum(axis=0, keepdims=True), x.shape)
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], want)


def test_hierarchical_reduce_scatter_and_allgather_invert():
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    outs = []
    for lib, coll, mesh, P in ((mx, rcoll, rmesh(dcn=2, dp=4), rpar.P),
                               (pt, pcoll, pmesh(dcn=2, dp=4), ppar.P)):
        spec = P(("dcn", "dp"))

        def fn(c, v):
            shard = c.hierarchical_reduce_scatter(v[0], "dp", "dcn")
            whole = c.hierarchical_allgather(shard, "dp", "dcn")
            return c.allgather(shard, ("dcn", "dp"))[None] * 0 + \
                whole[None]
        outs.append(_shard_map(lib, coll, fn, mesh, spec, spec, x))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(
        outs[1], np.broadcast_to(x.sum(0, keepdims=True), x.shape))


def test_hierarchical_grad_sync_pytree_padding():
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(8, 3, 5).astype(np.float32),
            "b": rng.randn(8, 7).astype(np.float32),
            "s": rng.randn(8).astype(np.float32)}
    res = []
    for lib, coll, mesh, P in ((mx, rcoll, rmesh(dcn=2, dp=4), rpar.P),
                               (pt, pcoll, pmesh(dcn=2, dp=4), ppar.P)):
        spec = P(("dcn", "dp"))
        f = lib.parallel.shard_map(
            lambda t: {k: v[None] for k, v in coll.hierarchical_grad_sync(
                {k: v[0] for k, v in t.items()}, ici_axis="dp",
                dcn_axis="dcn").items()},
            mesh=mesh, in_specs=(spec,), out_specs=spec)
        res.append({k: _np(v) for k, v in f(tree).items()})
    for k, v in tree.items():
        want = np.broadcast_to(v.sum(axis=0, keepdims=True), v.shape)
        np.testing.assert_allclose(res[1][k], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res[1][k], res[0][k], rtol=1e-6,
                                   atol=1e-6)
    # the quantized wire (item 11, ported): within int8's grid of the
    # sum, and the carried residual closes the gap exactly in f32 terms
    cfg = pt.parallel.quantize.QuantConfig(mode="int8", block=8,
                                           tier="all")
    qf = pt.parallel.shard_map(
        lambda v: tuple(t["a"][None] for t in pcoll.hierarchical_grad_sync(
            {"a": v[0]}, quant=cfg,
            residual={"a": pt.nd.zeros(v[0].shape, ctx=v.context)})),
        mesh=pmesh(dcn=2, dp=4), in_specs=ppar.P(("dcn", "dp")),
        out_specs=ppar.P(("dcn", "dp")))
    out, resid = [_np(t) for t in qf(X8)]
    want = X8.sum(axis=0)
    np.testing.assert_allclose(out[0], want, atol=np.abs(X8).max() * 0.1)
    np.testing.assert_allclose(out[0] + resid.sum(axis=0), want,
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
def _dp_net(lib):
    return mlp(lib, (16, 4), "dpa", 8)


def test_sharded_dp_step_matches_single():
    """DP over the mesh == the single-device Gluon step, and the
    reference's sharded step's parameters."""
    rng = np.random.RandomState(0)
    rnet, pnet = twin(_dp_net)
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randint(0, 4, (16,)).astype(np.float32)
    lr = 0.1
    loss_fn = pt.gluon.loss.SoftmaxCrossEntropyLoss()
    with pt.autograd.record():
        loss = loss_fn(pnet(pt.nd.array(x, ctx=pt.cpu())),
                       pt.nd.array(y, ctx=pt.cpu()))
    loss.backward()
    single = {n: p.data().asnumpy() - lr * p.grad().asnumpy() / 16.0
              for n, p in pnet.collect_params().items()}
    steps = []
    for lib, par, mesh, net in ((mx, rpar, rmesh(dp=8), rnet),
                                (pt, ppar, pmesh(dp=8), pnet)):
        step = par.ShardedTrainStep(net, lib.gluon.loss
                                    .SoftmaxCrossEntropyLoss(), mesh,
                                    optimizer="sgd", lr=lr, momentum=0.0)
        step._hp["lr"] = lr / 16.0
        step._build()
        step.step(lib.nd.array(x), lib.nd.array(y)) if lib is mx else \
            step.step(pt.nd.array(x, ctx=pt.cpu()),
                      pt.nd.array(y, ctx=pt.cpu()))
        steps.append(step)
    for name, val in steps[1].params.items():
        np.testing.assert_allclose(_np(val), single[name], rtol=1e-5,
                                   atol=1e-6)
    assert_params(steps[1], steps[0])


def _run(lib, par, mesh, net, loss_fn, batches, n_steps=1, **kw):
    step = par.ShardedTrainStep(net, loss_fn, mesh, **kw)
    losses = []
    for i in range(n_steps):
        args = batches(i)
        if lib is pt:
            args = [pt.nd.array(a, ctx=pt.cpu()) for a in args]
        else:
            args = [mx.nd.array(a) for a in args]
        losses.append(float(_np(step.step(*args))))
    return step, losses


def test_sharded_tp_step_runs():
    """dp x tp with tensor-sharded Dense weights: learning, and the
    reference's parameters after 2 steps."""
    rng = np.random.RandomState(1)
    rnet, pnet = twin(lambda lib: mlp(lib, (32, 8), "tpa", 16))
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 8, (8,)).astype(np.float32)
    rules = lambda P: [(r"tpa0_weight", P("tp", None)),
                       (r"tpa1_weight", P(None, "tp"))]
    out = []
    for lib, par, mesh, net in ((mx, rpar, rmesh(dp=4, tp=2), rnet),
                                (pt, ppar, pmesh(dp=4, tp=2), pnet)):
        out.append(_run(lib, par, mesh, net,
                        lib.gluon.loss.SoftmaxCrossEntropyLoss(),
                        lambda i: (x, y), 2, lr=0.05,
                        param_rules=rules(par.P)))
    (rs, rl), (ps, pl) = out
    assert ps.param_shardings["tpa0_weight"].spec == ppar.P("tp", None)
    assert ps.param_shardings["tpa1_weight"].spec == ppar.P(None, "tp")
    assert all(np.isfinite(pl)) and pl[1] < pl[0]
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert_params(ps, rs)


def test_shard_params_drops_axes_that_do_not_divide():
    shapes = {"a_weight": (6, 4), "b_weight": (8, 5), "c": (3,)}
    rules = [(r"_weight", ("tp", "dp"))]
    got = ppar.shard_params(shapes, pmesh(dp=4, tp=2),
                            [(r, ppar.P(*s)) for r, s in rules])
    want = rpar.shard_params(shapes, rmesh(dp=4, tp=2),
                             [(r, rpar.P(*s)) for r, s in rules])
    assert {k: tuple(v.spec) for k, v in got.items()} == \
        {k: tuple(v.spec) for k, v in want.items()}


class _TinyBertFactory:
    units, heads, T, N = 16, 4, 6, 8

    def __call__(self, lib):
        from importlib import import_module
        bert = import_module(lib.__name__ + ".gluon.model_zoo.bert")
        units, heads = self.units, self.heads
        nn = lib.gluon.nn

        class TinyBert(lib.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.cell = bert.BERTEncoderCell(units, units * 4, heads,
                                                     dropout=0.0)
                    self.head = nn.Dense(4, flatten=False)

            def hybrid_forward(self, F, x):
                out = self.cell(x)
                out = self.head(out)
                return F.mean(out, axis=0)
        return TinyBert(prefix="tinybert_")


def test_sharded_bert_tiny_dp_tp():
    """The tiny BERT encoder over dp=4 x tp=2, the batch on axis 1:
    5 losses within rtol 1e-4 of the reference's, and falling."""
    f = _TinyBertFactory()
    rng = np.random.RandomState(2)
    mx.random.seed(2)
    rnet = f(mx)
    rnet.initialize(init=mx.initializer.Xavier())
    rnet(mx.nd.ones((2, 2, f.units)))
    pnet = f(pt)
    pnet.initialize(ctx=pt.cpu())
    pnet(pt.nd.ones((2, 2, f.units), ctx=pt.cpu()))
    carry(rnet, pnet)
    x = rng.randn(f.T, f.N, f.units).astype(np.float32)
    y = rng.randint(0, 4, (f.N,)).astype(np.float32)
    runs = []
    for lib, par, mesh, net in ((mx, rpar, rmesh(dp=4, tp=2), rnet),
                                (pt, ppar, pmesh(dp=4, tp=2), pnet)):
        P = par.P
        runs.append(_run(
            lib, par, mesh, net, lib.gluon.loss.SoftmaxCrossEntropyLoss(),
            lambda i: (x, y), 5, lr=0.1,
            param_rules=[(r"attn_qkv_weight|ffn_1_weight", P("tp", None)),
                         (r"proj_weight|ffn_2_weight", P(None, "tp"))],
            data_specs=[P(None, "dp"), P("dp")]))
    (_, rl), (ps, pl) = runs
    assert any(tuple(s.spec) != () for s in ps.param_shardings.values())
    assert all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, rl, rtol=1e-4)


def test_sharded_grad_accum_matches_big_batch():
    """grad_accum=2 over the two halves applies half the full-batch
    update; and the reference's accumulated parameters."""
    rng = np.random.RandomState(3)
    rnet, pnet = twin(lambda lib: mlp(lib, (4,), "gaa", 6))
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    w0 = {k: p.data().asnumpy() for k, p in pnet.collect_params().items()}
    mesh = pmesh(dp=4)
    loss = pt.gluon.loss.L2Loss()
    big, _ = _run(pt, ppar, mesh, pnet, loss, lambda i: (x, y), 1,
                  optimizer="sgd", lr=0.1, momentum=0.0)
    halves = lambda i: (x[4 * i:4 * i + 4], y[4 * i:4 * i + 4])
    acc, _ = _run(pt, ppar, mesh, pnet, loss, halves, 2, optimizer="sgd",
                  lr=0.1, momentum=0.0, grad_accum=2)
    racc, _ = _run(mx, rpar, rmesh(dp=4), rnet, mx.gluon.loss.L2Loss(),
                   halves, 2, optimizer="sgd", lr=0.1, momentum=0.0,
                   grad_accum=2)
    for name in big.params:
        d_big = _np(big.params[name]) - w0[name]
        d_acc = _np(acc.params[name]) - w0[name]
        np.testing.assert_allclose(d_acc, 0.5 * d_big, rtol=1e-4, atol=1e-6)
    assert_params(acc, racc)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw", "lamb"])
def test_sharded_optimizers_match_the_reference(opt):
    """Six steps of each optimizer: the losses fall and the parameters
    and states equal the reference's (LAMB with a tp-sharded weight, so
    its norms cross the shards)."""
    rng = np.random.RandomState(4)
    rnet, pnet = twin(lambda lib: mlp(lib, (8, 4), "opa", 6))
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    runs = []
    for lib, par, mesh, net in ((mx, rpar, rmesh(dp=4, tp=2), rnet),
                                (pt, ppar, pmesh(dp=4, tp=2), pnet)):
        runs.append(_run(lib, par, mesh, net, lib.gluon.loss.L2Loss(),
                         lambda i: (x, y), 6, optimizer=opt, lr=0.01,
                         wd=0.01,
                         param_rules=[(r"opa0_weight", par.P("tp", None))]))
    (rs, rl), (ps, pl) = runs
    assert all(np.isfinite(pl)) and pl[-1] < pl[0], pl
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert_params(ps, rs)
    for k in rs.states:
        for a, b in zip(ps.states[k], rs.states[k]):
            np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_split_update_equals_fused():
    rng = np.random.RandomState(6)
    _, pnet = twin(lambda lib: mlp(lib, (8, 4), "spa", 6))
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    kw = dict(optimizer="lamb", lr=0.01)
    fused, lf = _run(pt, ppar, pmesh(dp=4), pnet, pt.gluon.loss.L2Loss(),
                     lambda i: (x, y), 3, **kw)
    split, ls = _run(pt, ppar, pmesh(dp=4), pnet, pt.gluon.loss.L2Loss(),
                     lambda i: (x, y), 3, split_update=True, **kw)
    assert lf == ls
    for k, v in fused.params.items():
        np.testing.assert_array_equal(_np(split.params[k]), _np(v))
    with pytest.raises(pt.MXNetError, match="split_update"):
        ppar.ShardedTrainStep(pnet, pt.gluon.loss.L2Loss(), pmesh(dp=4),
                              split_update=True, grad_accum=2)


def test_sharded_rng_advances_each_step():
    """lr 0: the loss differs across steps only if the dropout masks
    move."""
    rng = np.random.RandomState(5)
    _, pnet = twin(lambda lib: mlp(lib, (32, 4), "rga", 16, dropout=0.5))
    x = rng.randn(4, 16).astype(np.float32)
    y = rng.randn(4, 4).astype(np.float32)
    _, losses = _run(pt, ppar, pmesh(dp=2), pnet, pt.gluon.loss.L2Loss(),
                     lambda i: (x, y), 2, optimizer="sgd", lr=0.0,
                     momentum=0.0)
    assert losses[0] != losses[1]


def test_sharded_save_load_states_resumes_bit_continuous(tmp_path):
    """A restored step continues the uninterrupted run bit for bit:
    params, Adam's states, the step count and the dropout streams."""
    rng = np.random.RandomState(11)
    _, pnet = twin(lambda lib: mlp(lib, (16, 4), "sla", 8, dropout=0.3))
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    mesh = pmesh(dp=4)
    args = lambda: (pt.nd.array(x, ctx=pt.cpu()), pt.nd.array(y, ctx=pt.cpu()))

    def mk():
        return ppar.ShardedTrainStep(pnet, pt.gluon.loss.L2Loss(), mesh,
                                     optimizer="adam", lr=0.01, seed=3)
    ref = mk()
    for _ in range(3):
        ref.step(*args())
    ckpt = str(tmp_path / "st.npz")
    ref.save_states(ckpt)
    keys = set(np.load(ckpt).keys())
    assert {"t", "rng"} <= keys and any(k.startswith("s1:") for k in keys)
    ref_losses = [float(_np(ref.step(*args()))) for _ in range(3)]
    resumed = mk()
    resumed.load_states(ckpt)
    got = [float(_np(resumed.step(*args()))) for _ in range(3)]
    assert got == ref_losses
    for k in ref.params:
        np.testing.assert_array_equal(_np(resumed.params[k]),
                                      _np(ref.params[k]))
    for k in ref.states:
        for a, b in zip(resumed.states[k], ref.states[k]):
            np.testing.assert_array_equal(_np(a), _np(b))
    acc = ppar.ShardedTrainStep(pnet, pt.gluon.loss.L2Loss(), mesh,
                                grad_accum=2)
    acc.step(*args())
    with pytest.raises(pt.MXNetError, match="mid-gradient-accumulation"):
        acc.save_states(str(tmp_path / "mid.npz"))


def test_reference_states_file_resumes_in_the_port(tmp_path):
    """The reference's npz (its key stream dropped) loads into the port,
    whose next step gives the reference's next step (dropout 0)."""
    rng = np.random.RandomState(12)
    rnet, pnet = twin(lambda lib: mlp(lib, (16, 4), "rfa", 8))
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    rstep, _ = _run(mx, rpar, rmesh(dp=4), rnet, mx.gluon.loss.L2Loss(),
                    lambda i: (x, y), 2, optimizer="adam", lr=0.01)
    ckpt = str(tmp_path / "ref.npz")
    rstep.save_states(ckpt)
    blob = dict(np.load(ckpt))
    del blob["rng"]
    with open(ckpt, "wb") as f:
        np.savez(f, **blob)
    pstep = ppar.ShardedTrainStep(pnet, pt.gluon.loss.L2Loss(), pmesh(dp=4),
                                  optimizer="adam", lr=0.01)
    pstep.load_states(ckpt)
    assert pstep._t == 2
    lr_ = float(_np(rstep.step(mx.nd.array(x), mx.nd.array(y))))
    lp = float(_np(pstep.step(pt.nd.array(x, ctx=pt.cpu()),
                              pt.nd.array(y, ctx=pt.cpu()))))
    np.testing.assert_allclose(lp, lr_, rtol=1e-5)
    assert_params(pstep, rstep)


def test_sharded_step_dcn_matches_single_slice():
    """A dcn=2 x dp=2 mesh and a dp=4 mesh train the same parameters."""
    rng = np.random.RandomState(7)
    _, pnet = twin(_dp_net, seed=7)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.float32)
    loss = pt.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = dict(optimizer="sgd", lr=0.1, momentum=0.9)
    flat, _ = _run(pt, ppar, pmesh(dp=4), pnet, loss, lambda i: (x, y), 3,
                   **kw)
    hier, _ = _run(pt, ppar, pmesh(dcn=2, dp=2), pnet, loss,
                   lambda i: (x, y), 3, **kw)
    for k in flat.params:
        np.testing.assert_allclose(_np(flat.params[k]), _np(hier.params[k]),
                                   rtol=1e-5, atol=1e-6)


def test_constructor_checks():
    _, pnet = twin(lambda lib: mlp(lib, (4,), "cca", 6))

    class Head(pt.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="cca0_")
            with self.name_scope():
                self.weight = self.params.get("weight", shape=(4, 4))

        def hybrid_forward(self, F, out, label, weight):
            return F.sum(F.dot(out, weight) - label, axis=1)
    head = Head()
    head.initialize(ctx=pt.cpu())
    with pytest.raises(pt.MXNetError, match="collides"):
        ppar.ShardedTrainStep(pnet, head, pmesh(dp=2))
    lazy = pt.gluon.nn.Dense(4, prefix="ccb_")
    lazy.initialize(ctx=pt.cpu())
    with pytest.raises(pt.MXNetError, match="not materialized"):
        ppar.ShardedTrainStep(lazy, pt.gluon.loss.L2Loss(), pmesh(dp=2))


def test_a_batch_mean_loss_differs_from_the_reference_by_the_shards():
    """Pinned gap (ROADMAP queue 3): a loss that averages over the batch
    inside the step is averaged over each replica's block, so over 4
    batch shards its gradient is 4 times the reference's (whose program
    averages the whole batch)."""
    rng = np.random.RandomState(8)
    rnet, pnet = twin(lambda lib: mlp(lib, (4,), "bma", 6))
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    w0 = {k: p.data().asnumpy() for k, p in pnet.collect_params().items()}

    def mean_loss(lib):
        l2 = lib.gluon.loss.L2Loss()
        return lambda out, label: l2(out, label).mean()
    runs = []
    for lib, par, mesh, net in ((mx, rpar, rmesh(dp=4), rnet),
                                (pt, ppar, pmesh(dp=4), pnet)):
        runs.append(_run(lib, par, mesh, net, mean_loss(lib),
                         lambda i: (x, y), 1, optimizer="sgd", lr=0.1,
                         momentum=0.0)[0])
    for k in w0:
        d_ref = _np(runs[0].params[k]) - w0[k]
        d_port = _np(runs[1].params[k]) - w0[k]
        np.testing.assert_allclose(d_port, 4 * d_ref, rtol=1e-4, atol=1e-7)


def test_data_parallel_step():
    import torch
    rng = np.random.RandomState(9)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(16, 4).astype(np.float32)
    rstep = rpar.data_parallel_step(
        lambda p, x: (x @ p["w"]).sum() ** 2 * 1e-3, rmesh(dp=8), lr=0.1)
    pstep = ppar.data_parallel_step(
        lambda p, x: (x @ p["w"]).sum() ** 2 * 1e-3, pmesh(dp=8), lr=0.1)
    rp, rl = rstep({"w": w}, b)
    pp, pl = pstep({"w": torch.from_numpy(w)}, b)
    np.testing.assert_allclose(pp["w"].numpy(), _np(rp["w"]), rtol=1e-5)
    np.testing.assert_allclose(float(pl), float(_np(rl)), rtol=1e-5)


def test_unported_layers_name_their_slice():
    for name in ("moe_apply", "make_moe_layer", "pipeline_apply",
                 "make_pipeline_step", "local_attention", "ring_attention",
                 "ulysses_attention"):
        with pytest.raises(NotImplementedError, match="item 11"):
            getattr(pt.parallel, name)()


def test_sharded_auto_layout_is_accepted(monkeypatch):
    """``MXNET_SHARDED_AUTO_LAYOUT``: the reference's default and type;
    off, the step trains the same bits (it acts only on TPUs there)."""
    ref = mx.config.VARS["MXNET_SHARDED_AUTO_LAYOUT"]
    port = pt.config.VARS["MXNET_SHARDED_AUTO_LAYOUT"]
    assert port.default == ref.default is True
    assert "hoisted" in port.doc or "channels-last" in port.doc
    rng = np.random.RandomState(13)
    _, pnet = twin(lambda lib: mlp(lib, (8, 4), "ala", 6))
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_SHARDED_AUTO_LAYOUT", flag)
        runs.append(_run(pt, ppar, pmesh(dp=2), pnet, pt.gluon.loss.L2Loss(),
                         lambda i: (x, y), 2)[0])
    for k, v in runs[0].params.items():
        np.testing.assert_array_equal(_np(runs[1].params[k]), _np(v))
