"""Redistribution in the port (``mxnet_tpu_torch/parallel/reshard.py``,
``Trainer.reshard_to``) against the reference's host-side planner and
the contracts of its ``tests/test_reshard.py``.

The fragment plans (``FragLayout``, ``plan_moves``, ``stage_blocks``,
``owner_permutation``) run in both packages on the host: they are held
equal over a grid of sizes and replica counts, parameters smaller than
one fragment a replica included. The device moves are held to the
arrays they move (bit for bit), and the Trainer's live reshard to a run
started on the new topology from the same gathered state (bit for bit),
on ``cpu(i)`` contexts.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu.parallel import reshard as rrs
from mxnet_tpu_torch.parallel import reshard as prs
from mxnet_tpu_torch import parallel as ppar
from mxnet_tpu_torch.gluon import zero as zero_mod


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    pt.faultinject.clear()
    pt.telemetry.refresh()
    with pt.cpu():                  # the DataLoader stages to the CPU
        yield
    pt.faultinject.clear()
    pt.telemetry.refresh()
    pt.telemetry.reset()


_SIZES = [1, 3, 7, 8, 35, 64, 100, 257]


# ---------------------------------------------------------------------------
# the host-side planner, equal to the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_dcn", [0, 2])
def test_owner_permutation_and_layouts_match(n_dcn):
    for n in range(1, 9):
        if n_dcn and n % n_dcn:
            with pytest.raises(prs.ReshardError):
                prs.owner_permutation(n, n_dcn)
            continue
        assert prs.owner_permutation(n, n_dcn) == \
            rrs.owner_permutation(n, n_dcn)
        for size in _SIZES:
            a = prs.FragLayout.build(size, n, n_dcn, offset=5)
            b = rrs.FragLayout.build(size, n, n_dcn, offset=5)
            assert (a.size, a.n, a.owner, a.offset, a.frag) == \
                (b.size, b.n, b.owner, b.offset, b.frag)
            for r in range(n):
                assert a.data_extent(r) == b.data_extent(r)
                assert a.pos_of(r) == b.pos_of(r)
    assert prs.owner_permutation(8, 2) == (0, 2, 4, 6, 1, 3, 5, 7)


@pytest.mark.parametrize("dcn_dst", [0, 2])
@pytest.mark.parametrize("dcn_src", [0, 2])
def test_plan_moves_and_blocks_match(dcn_src, dcn_dst):
    for n_src in range(1, 9):
        for n_dst in range(1, 9):
            if (dcn_src and n_src % dcn_src) or (dcn_dst and n_dst % dcn_dst):
                continue
            for size in _SIZES:
                ps, pd = (prs.FragLayout.build(size, n_src, dcn_src, 3),
                          prs.FragLayout.build(size, n_dst, dcn_dst, 1))
                rs_, rd = (rrs.FragLayout.build(size, n_src, dcn_src, 3),
                           rrs.FragLayout.build(size, n_dst, dcn_dst, 1))
                mp, mr = prs.plan_moves(ps, pd), rrs.plan_moves(rs_, rd)
                assert [tuple(m) for m in mp] == [tuple(m) for m in mr]
                assert sum(m.elems for m in mp) == size
                for blk in (1, 5, 64):
                    assert [[tuple(m) for m in b]
                            for b in prs.stage_blocks(mp, blk)] == \
                        [[tuple(m) for m in b]
                         for b in rrs.stage_blocks(mr, blk)]
    with pytest.raises(prs.ReshardError, match="size mismatch"):
        prs.plan_moves(prs.FragLayout.build(3, 2), prs.FragLayout.build(4, 2))


def test_block_bytes_and_bound(monkeypatch):
    assert prs.block_bytes() == rrs.block_bytes() == 4 << 20
    monkeypatch.setenv("MXNET_ELASTIC_BLOCK", "1024")
    assert prs.block_bytes() == 1024
    assert prs.peak_live_bytes(4096) == rrs.peak_live_bytes(4096) == 5120


# ---------------------------------------------------------------------------
# the device moves
# ---------------------------------------------------------------------------
def _cpus(n):
    return [pt.cpu(i) for i in range(n)]


@pytest.mark.parametrize("src,dst", [(8, 4), (4, 2), (2, 8), (3, 5),
                                     (4, 4)])
def test_reshard_fragments_moves_the_array(src, dst, monkeypatch):
    """Several arrays packed in one shard buffer move between fragment
    layouts (with the dcn permutation where the count allows) in staged
    blocks: gathered back they are the same bytes, the destination
    padding is zero, and the blocks are counted."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    pt.telemetry.reset()
    rng = np.random.RandomState(src * 10 + dst)
    arrays = [rng.randn(s).astype(np.float32) for s in (35, 3, 100)]
    dcn_s = 2 if src % 2 == 0 and src > 2 else 0
    dcn_d = 2 if dst % 2 == 0 and dst > 2 else 0

    def layouts(n, dcn):
        out, off = [], 0
        for a in arrays:
            lay = prs.FragLayout.build(a.size, n, dcn, off)
            out.append(lay)
            off += lay.frag
        return out, off
    ls, C_s = layouts(src, dcn_s)
    ld, C_d = layouts(dst, dcn_d)
    src_bufs = prs.place_from_host(list(zip(arrays, ls)), src, C_s,
                                   _cpus(src), np.float32)
    moves = []
    for a, b in zip(ls, ld):
        moves += prs.plan_moves(a, b)
    bufs = prs.reshard_fragments(src_bufs, moves, dst, C_d, _cpus(dst),
                                 blk_bytes=16)
    got = prs.gather_to_host(bufs, ld)
    for a, g in zip(arrays, got):
        assert a.tobytes() == g.tobytes()
    used = np.zeros((dst, C_d), bool)
    for m in moves:
        used[m.dst_pos, m.dst_lo:m.dst_lo + m.elems] = True
    for p in range(dst):
        assert not bufs[p].numpy()[~used[p]].any()
    snap = pt.telemetry.snapshot()["counters"]
    assert snap['mx_reshard_blocks_total{kind="fragments"}'] > 1
    assert snap['mx_reshard_moved_bytes_total{kind="fragments"}'] == \
        4 * sum(a.size for a in arrays)


def test_reshard_fail_fires_at_live_entry_not_at_restore():
    pt.faultinject.set_fault("reshard_fail", 1.0)
    lay = prs.FragLayout.build(10, 2)
    bufs = prs.place_from_host([(np.arange(10, dtype=np.float32), lay)], 2,
                               lay.frag, _cpus(2), np.float32)
    assert bufs[1].numpy().tolist() == [5, 6, 7, 8, 9]
    with pytest.raises(prs.ReshardError):
        prs.reshard_fragments(bufs, prs.plan_moves(lay, lay), 2, lay.frag,
                              _cpus(2))
    mesh = ppar.make_mesh(ppar.MeshConfig(dp=2), devices=_cpus(2))
    with pytest.raises(prs.ReshardError):
        prs.redistribute(torch.ones(4), ppar.NamedSharding(mesh,
                                                           ppar.P("dp")))
    net = pt.gluon.nn.Dense(2, in_units=3, prefix="f_")
    net.initialize(ctx=_cpus(2))
    tr = pt.gluon.Trainer(net.collect_params(), "sgd")
    with pytest.raises(prs.ReshardError):
        tr.reshard_to(_cpus(1))
    assert tr._contexts == _cpus(2)        # nothing moved


@pytest.mark.parametrize("case", ["dp_to_tp", "tp2_to_dp4", "uneven",
                                  "replicated_to_2d"])
def test_redistribute_general(case):
    """The general form: an array under one NamedSharding moved to
    another (other contexts too); the whole array comes back the same,
    each destination block on its device."""
    x = torch.arange(6 * 10, dtype=torch.float32).reshape(6, 10)
    m4 = ppar.make_mesh(ppar.MeshConfig(dp=4), devices=_cpus(4))
    m2 = ppar.make_mesh(ppar.MeshConfig(tp=2), devices=_cpus(6)[4:])
    m22 = ppar.make_mesh(ppar.MeshConfig(dp=2, tp=2), devices=_cpus(4))
    src, dst = {
        "dp_to_tp": (ppar.NamedSharding(m4, ppar.P("dp")),
                     ppar.NamedSharding(m2, ppar.P(None, "tp"))),
        "tp2_to_dp4": (ppar.NamedSharding(m2, ppar.P("tp")),
                       ppar.NamedSharding(m4, ppar.P(None, "dp"))),
        "uneven": (ppar.NamedSharding(m4, ppar.P(None, "dp")),
                   ppar.NamedSharding(m4, ppar.P("dp"))),
        "replicated_to_2d": (None, ppar.NamedSharding(m22,
                                                      ppar.P("dp", "tp"))),
    }[case]
    arr = x if src is None else prs.Sharded.from_tensor(x, src)
    out = prs.redistribute(arr, dst, blk_bytes=24)
    assert torch.equal(out.full(), x)
    boxes = prs.devices_indices_map(dst, tuple(x.shape))
    for d, t in out.shards.items():
        assert t.shape == tuple(hi - lo for lo, hi in boxes[d])
    tree = prs.redistribute_tree({"a": arr, "b": [arr]}, dst)
    assert torch.equal(tree["b"][0].full(), x)
    assert prs.transition_programs() >= 1


# ---------------------------------------------------------------------------
# the Trainer's live reshard
# ---------------------------------------------------------------------------
def _setup(ctxs, prefix, seed=13):
    rng = np.random.RandomState(seed)
    net = pt.gluon.nn.Dense(3, in_units=4, prefix=prefix)
    net.initialize(ctx=list(ctxs))
    net.weight.set_data(pt.nd.array(rng.randn(3, 4).astype(np.float32),
                                    ctx=pt.cpu()))
    tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    est = pt.gluon.contrib.estimator.Estimator(
        net, pt.gluon.loss.L2Loss(), train_metrics=[pt.metric.MSE()],
        trainer=tr, context=list(ctxs))
    return net, tr, est


def _loader(n=32, start=0):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 4).astype(np.float32)
    Y = (X @ rng.randn(4, 3)).astype(np.float32)
    return pt.gluon.data.DataLoader(
        pt.gluon.data.ArrayDataset(X[start:], Y[start:]), batch_size=8)


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._structural_params().items()}


def _arrays(params):
    return {k: pt.nd.array(v, ctx=pt.cpu()) for k, v in params.items()}


_VARIANTS = {
    "replicated": {},
    "zero": {"MXNET_ZERO": "1"},
    "zero_dcn": {"MXNET_ZERO": "1", "MXNET_ZERO_DCN": "2"},
    "quant_ef": {"MXNET_ZERO": "1", "MXNET_KVSTORE_QUANTIZE": "int8"},
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_chain_8_4_2_8_bitparity(variant, monkeypatch):
    """Trainer.reshard_to 8 -> 4 -> 2 -> 8: the parameters and the
    states blob (the ZeRO fragments, the dcn permutation, the wire's
    residuals) are unchanged at every hop, and the run continued on each
    topology is bit for bit a run started there from the gathered
    state."""
    for k, v in _VARIANTS[variant].items():
        monkeypatch.setenv(k, v)
    ctxs = _cpus(8)
    net, tr, est = _setup(ctxs, "c_")
    est.fit(_loader(), epochs=1)
    zero = variant != "replicated"
    assert isinstance(tr._zero, zero_mod.ZeroEngine) == zero
    p0, blob0 = _params(net), tr.states_blob()
    for hop, n in enumerate((4, 2, 8)):
        tr.reshard_to(ctxs[:n])
        assert tr._contexts == ctxs[:n]
        if zero:
            assert isinstance(tr._zero, zero_mod.ZeroEngine)
            assert tr._zero._n == n
        got = _params(net)
        for k in p0:
            assert got[k].tobytes() == p0[k].tobytes(), (k, n)
        assert tr.states_blob() == blob0, n
        # a control started on this topology from the same state
        net2, tr2, est2 = _setup(ctxs[:n], "k%d_" % hop, seed=99)
        est2._restore_arg_params(_arrays(p0))
        tr2.load_states_blob(blob0)
        est.context = list(ctxs[:n])
        est.fit(_loader(16), epochs=1)
        est2.fit(_loader(16), epochs=1)
        a, b = _params(net), _params(net2)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (k, n)
        p0, blob0 = a, tr.states_blob()


def test_zero_reshard_to_one_dissolves(monkeypatch):
    """A survivor set of one cannot shard: the momentum goes to the
    replicated updater, and the run continues bit for bit with a
    one-context Trainer loaded from the same state."""
    monkeypatch.setenv("MXNET_ZERO", "1")
    ctxs = _cpus(4)
    net, tr, est = _setup(ctxs, "d_")
    est.fit(_loader(), epochs=1)
    p0, blob0 = _params(net), tr.states_blob()
    tr.reshard_to(ctxs[:1])
    assert tr._zero is False and tr._zero_bailed
    assert tr.states_blob() == blob0
    net2, tr2, est2 = _setup(ctxs[:1], "e_", seed=5)
    est2._restore_arg_params(_arrays(p0))
    tr2.load_states_blob(blob0)
    est.context = ctxs[:1]
    est.fit(_loader(16), epochs=1)
    est2.fit(_loader(16), epochs=1)
    a, b = _params(net), _params(net2)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_zero_reshard_from_refuses_mismatched_layouts(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO", "1")
    ctxs = _cpus(4)
    net, tr, est = _setup(ctxs, "v_")
    est.fit(_loader(), epochs=1)
    old = tr._zero
    tr.reshard_to(ctxs[:2])
    new = tr._zero
    old._nstates = 2
    with pytest.raises(pt.MXNetError, match="layouts disagree"):
        new.reshard_from(old)


def test_sharding_manifest_sections(monkeypatch):
    """The checkpoint's sharding section: replicated, and under ZeRO with
    dcn=2 its axes, permutation and each parameter's geometry (the
    reference's keys)."""
    ctxs = _cpus(4)
    net, tr, est = _setup(ctxs, "m_")
    est.fit(_loader(), epochs=1)
    sec = prs.sharding_manifest(tr)
    assert sec == {"version": 1, "n_devices": 4,
                   "contexts": ["cpu(%d)" % i for i in range(4)],
                   "mesh_axes": ["dp"], "layout": "replicated",
                   "partition_spec": None, "params": {}}
    monkeypatch.setenv("MXNET_ZERO", "1")
    monkeypatch.setenv("MXNET_ZERO_DCN", "2")
    net, tr, est = _setup(ctxs, "n_")
    est.fit(_loader(), epochs=1)
    sec = prs.sharding_manifest(tr)
    assert sec["layout"] == "zero" and sec["owner"] == [0, 2, 1, 3]
    assert sec["mesh_axes"] == ["dcn", "dp"] and sec["n_dcn"] == 2
    assert sec["partition_spec"] == ["dcn", "dp"]
    assert sec["quantized"] is False
    # the Trainer takes a ParameterDict's parameters in name order
    assert sec["params"] == {"n_bias": {"size": 3, "frag": 1,
                                        "offset": 0, "group": 0},
                             "n_weight": {"size": 12, "frag": 3,
                                          "offset": 1, "group": 0}}
    assert set(sec) == {"version", "n_devices", "contexts", "mesh_axes",
                        "layout", "partition_spec", "params", "owner",
                        "n_dcn", "quantized"}
