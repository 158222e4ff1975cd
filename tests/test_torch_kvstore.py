"""The port's in-process kvstore and the Trainer's kvstore path
(``mxnet_tpu_torch/kvstore/``, ``gluon/trainer.py``) against the
reference's ``tests/test_kvstore.py``, case by case on the same numpy
inputs, where the reference is green (its two gradient-compression cases
are red; the port's compression, the quantized wire, is held in
tests/test_torch_quantize.py).

The port's CPU contexts are one host device, so its replicas on
``cpu(0)``, ``cpu(1)``, ... take the ordered sum on the store's context,
where the reference's virtual devices take its grouped XLA reduce: sums
of integer-valued arrays agree exactly, others within 1e-6. The grouped
NCCL reduce across CUDA devices is held through its coalescing with a
stand-in all-reduce (one card cannot run it).
"""
import io
import pickletools
import sys
import types

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import kvstore as pkv

CPU = pt.cpu()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("MXNET_KVSTORE_QUANTIZE", raising=False)
    yield


def _ctxs(lib, n):
    return [lib.Context("cpu", i) for i in range(n)]


def _nd(lib, a, ctx=None):
    a = np.asarray(a)
    if lib is pt:
        return pt.nd.array(a, ctx=ctx or CPU, dtype=a.dtype)
    return mx.nd.array(a, ctx=ctx, dtype=a.dtype)


def _both(fn):
    return fn(mx), fn(pt)


# ---------------------------------------------------------------------------
# the reference's tests/test_kvstore.py cases
# ---------------------------------------------------------------------------
def test_push_pull_single():
    def run(lib):
        kv = lib.kvstore.create("local")
        kv.init("w", _nd(lib, np.ones((2, 3), np.float32)))
        kv.push("w", _nd(lib, np.full((2, 3), 4.0, np.float32)))
        out = _nd(lib, np.zeros((2, 3), np.float32))
        kv.pull("w", out=out)
        return out.asnumpy()
    ref, port = _both(run)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, np.full((2, 3), 4.0))


def test_push_aggregates_list():
    def run(lib):
        kv = lib.kvstore.create("device")
        ctxs = _ctxs(lib, 4)
        kv.init(3, _nd(lib, np.zeros((2, 2), np.float32)))
        kv.push(3, [_nd(lib, np.full((2, 2), i + 1.0, np.float32), c)
                    for i, c in enumerate(ctxs)])
        out = _nd(lib, np.zeros((2, 2), np.float32))
        kv.pull(3, out=out)
        return out.asnumpy()
    ref, port = _both(run)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, np.full((2, 2), 10.0))


def test_grouped_store_pushpull():
    """The reference's ``tpu`` store is the port's ``nccl``."""
    def run(lib):
        kv = lib.kvstore.create("tpu" if lib is mx else "nccl")
        ctxs = _ctxs(lib, 2)
        kv.init("g", _nd(lib, np.zeros((4,), np.float32)))
        vals = [_nd(lib, np.ones((4,), np.float32), c) for c in ctxs]
        outs = [_nd(lib, np.zeros((4,), np.float32), c) for c in ctxs]
        kv.pushpull("g", vals, out=outs)
        return [o.asnumpy() for o in outs], kv.type
    (ref, rtype), (port, ptype) = _both(run)
    assert (rtype, ptype) == ("tpu", "nccl")
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
        np.testing.assert_array_equal(p, np.full((4,), 2.0))


def test_multi_key():
    def run(lib):
        kv = lib.kvstore.create("local")
        keys = [5, 7, 9]
        kv.init(keys, [_nd(lib, np.ones((2,), np.float32))] * 3)
        kv.push(keys, [_nd(lib, np.full((2,), 2.0, np.float32))] * 3)
        outs = [_nd(lib, np.zeros((2,), np.float32)) for _ in keys]
        kv.pull(keys, out=outs)
        return [o.asnumpy() for o in outs]
    ref, port = _both(run)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)


def test_updater_on_kvstore():
    def run(lib):
        kv = lib.kvstore.create("local")
        kv.init("w", _nd(lib, np.ones((2,), np.float32)))
        kv.set_optimizer(lib.optimizer.SGD(learning_rate=0.1))
        kv.push("w", _nd(lib, np.ones((2,), np.float32)))
        out = _nd(lib, np.zeros((2,), np.float32))
        kv.pull("w", out=out)
        return out.asnumpy(), kv.is_capable("optimizer")
    (ref, rcap), (port, pcap) = _both(run)
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    np.testing.assert_allclose(port, np.full((2,), 0.9), rtol=1e-4)
    assert rcap is pcap is True


def test_kvstore_registry():
    import mxnet_tpu.kvstore.dist  # noqa: F401  (registers the stores)
    import mxnet_tpu.kvstore.horovod  # noqa: F401
    import mxnet_tpu_torch.kvstore.dist  # noqa: F401
    import mxnet_tpu_torch.kvstore.horovod  # noqa: F401
    ref = set(mx.kvstore.KVStoreBase.kv_registry)
    port = set(pt.kvstore.KVStoreBase.kv_registry)
    # the one name of another spelling: the grouped store
    assert port == (ref - {"tpu"}) | {"nccl"}
    assert pt.kvstore.KVStoreBase.get("NCCL") is pt.kvstore.KVStore
    with pytest.raises(pt.MXNetError, match="unknown kvstore"):
        pt.kvstore.create("no_such_store")
    with pytest.raises(TypeError):
        pt.kvstore.create(3)
    assert pt.kv is pt.kvstore and pt.KVStore is pt.kvstore.KVStore


def test_broadcast():
    def run(lib):
        kv = lib.kvstore.create("device")
        ctxs = _ctxs(lib, 3)
        v = _nd(lib, np.arange(6, dtype=np.float32).reshape(2, 3))
        outs = [_nd(lib, np.zeros((2, 3), np.float32), c) for c in ctxs]
        kv.broadcast("b", v, outs)
        return [o.asnumpy() for o in outs]
    ref, port = _both(run)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_pushpull_list_sums_every_key_into_outs_and_store(dtype):
    rng = np.random.RandomState(3)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    if dtype == "int32":
        raw = [[rng.randint(-50, 50, s).astype(dtype) for s in shapes]
               for _ in range(3)]
    else:
        raw = [[rng.randn(*s).astype(dtype) for s in shapes]
               for _ in range(3)]

    def run(lib):
        kv = lib.kvstore.create("device")
        ctxs = _ctxs(lib, 3)
        keys = ["k%d" % i for i in range(len(shapes))]
        for i, s in enumerate(shapes):
            kv.init(keys[i], _nd(lib, np.zeros(s, dtype)))
        vals = [[_nd(lib, raw[d][i], ctxs[d]) for d in range(3)]
                for i in range(len(shapes))]
        kv.pushpull_list(keys, vals)
        stored = []
        for i, s in enumerate(shapes):
            o = _nd(lib, np.zeros(s, dtype))
            kv.pull(keys[i], out=o)
            stored.append(o.asnumpy())
        return [[v.asnumpy() for v in vs] for vs in vals], stored
    (ref, rstore), (port, pstore) = _both(run)
    tol = 0 if dtype == "int32" else 1e-6
    for i in range(len(shapes)):
        want = sum(raw[d][i].astype(np.float64) for d in range(3))
        for d in range(3):
            np.testing.assert_allclose(port[i][d], ref[i][d], rtol=tol,
                                       atol=tol)
            np.testing.assert_allclose(port[i][d], want, rtol=tol,
                                       atol=tol)
            assert port[i][d].dtype == np.dtype(dtype)
        np.testing.assert_allclose(pstore[i], rstore[i], rtol=tol, atol=tol)


def test_store_entry_does_not_alias_the_pushed_gradient():
    kv = pt.kvstore.create("local")
    g = pt.nd.array(np.ones(4, np.float32), ctx=CPU)
    kv.init("g", g)
    kv.pushpull_list(["g"], [[g]])
    g[:] = 7.0
    out = pt.nd.zeros((4,), ctx=CPU)
    kv.pull("g", out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.ones(4))


# ---------------------------------------------------------------------------
# the grouped reduce's coalescing, with a stand-in for NCCL's all-reduce
# ---------------------------------------------------------------------------
def _fake_allreduce(calls):
    def allreduce(flats):
        calls.append([(f.dtype, tuple(f.shape)) for f in flats])
        total = sum(f.clone() for f in flats)
        for f in flats:
            f.copy_(total)
    return allreduce


def test_grouped_reduce_one_flat_buffer_per_device_and_dtype():
    import torch
    rng = np.random.RandomState(5)
    shapes = [((3, 4), torch.float32), ((7,), torch.float16),
              ((2, 5), torch.float32), ((1,), torch.float16)]
    ndev = 3
    groups = [[torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt)
               for _ in range(ndev)] for s, dt in shapes]
    before = [[t.clone() for t in g] for g in groups]
    calls = []
    out = pkv.coalesced_allreduce(groups, _fake_allreduce(calls))
    # one all-reduce a dtype, each over a (device count) list of flats
    assert calls == [[(torch.float32, (22,))] * ndev,
                     [(torch.float16, (8,))] * ndev]
    for k, (s, dt) in enumerate(shapes):
        want = sum(b.float() for b in before[k])
        for d in range(ndev):
            assert out[k][d].shape == s and out[k][d].dtype == dt
            torch.testing.assert_close(out[k][d].float(), want.to(dt).float(),
                                       rtol=0, atol=0 if dt ==
                                       torch.float32 else 1e-2)
            assert torch.equal(groups[k][d], before[k][d])   # not written


def test_collective_reducer_is_recorded_by_commwatch(monkeypatch):
    import torch
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    pt.telemetry.reset()
    try:
        calls = []
        red = pkv._CollectiveReducer(allreduce=_fake_allreduce(calls))
        groups = [[torch.ones(4) * (d + 1) for d in range(2)],
                  [torch.ones(2, 3) for _ in range(2)]]
        out = red.reduce_groups(groups)
        assert len(calls) == 1
        torch.testing.assert_close(out[0][1], torch.full((4,), 3.0))
        rows = pt.commwatch.report()
        assert [(r["op"], r["axis"], r["ops"], r["bytes"]) for r in rows] \
            == [("allreduce", "kv", 1.0, 40.0)]
        # one replica: nothing to reduce, nothing recorded
        assert red.reduce_groups([[torch.ones(2)]])[0][0].sum() == 2
    finally:
        monkeypatch.delenv("MXNET_TELEMETRY")
        pt.telemetry.refresh()
        pt.telemetry.reset()


# ---------------------------------------------------------------------------
# data parallel across contexts (reference test_multi_device_dp_training)
# ---------------------------------------------------------------------------
def _dp_run(lib, ctxs, x, y, w, b, kvstore="device", steps=2, **kw):
    net = lib.gluon.nn.Dense(1, in_units=4)
    net.initialize(ctx=ctxs)
    net.weight.set_data(_nd(lib, w))
    net.bias.set_data(_nd(lib, b))
    trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9},
                                kvstore=kvstore, **kw)
    n = len(ctxs)
    for _ in range(steps):
        with lib.autograd.record():
            losses = []
            for i, c in enumerate(ctxs):
                rows = slice(i * len(x) // n, (i + 1) * len(x) // n)
                xd, yd = _nd(lib, x[rows], c), _nd(lib, y[rows], c)
                losses.append(((net(xd) - yd) ** 2).sum())
        for loss in losses:
            loss.backward()
        trainer.step(len(x))
    return ([net.weight.data(c).asnumpy() for c in ctxs],
            [net.bias.data(c).asnumpy() for c in ctxs], trainer)


def _dp_inputs():
    rng = np.random.RandomState(0)
    x = rng.rand(8, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) * 2).astype(np.float32)
    w = rng.randn(1, 4).astype(np.float32) * 0.1
    return x, y, w, np.zeros(1, np.float32)


def test_multi_device_dp_training():
    x, y, w, b = _dp_inputs()
    ref_w, _, _ = _dp_run(mx, _ctxs(mx, 2), x, y, w, b)
    port_w, port_b, tr = _dp_run(pt, _ctxs(pt, 2), x, y, w, b)
    one_w, one_b, _ = _dp_run(pt, [CPU], x, y, w, b)
    assert tr._kvstore is not None and tr._kvstore.type == "device"
    # the replicas stay equal bit for bit
    np.testing.assert_array_equal(port_w[0], port_w[1])
    np.testing.assert_array_equal(port_b[0], port_b[1])
    # the reference's tolerances against its run and the one-context run
    np.testing.assert_allclose(port_w[0], ref_w[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port_w[0], one_w[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port_b[0], one_b[0], rtol=1e-4, atol=1e-5)


def test_trainer_update_on_kvstore_equals_replica_updates():
    """MXNet 1.x's update_on_kvstore: the optimizer on the store, the
    weights pulled into every replica; the same bits as each replica
    updating itself from the summed gradient."""
    x, y, w, b = _dp_inputs()
    on_w, on_b, tr = _dp_run(pt, _ctxs(pt, 2), x, y, w, b,
                             update_on_kvstore=True, steps=3)
    off_w, off_b, _ = _dp_run(pt, _ctxs(pt, 2), x, y, w, b,
                              update_on_kvstore=False, steps=3)
    assert tr._update_on_kvstore and tr._kvstore._updater is not None
    for a, c in zip(on_w + on_b, off_w + off_b):
        np.testing.assert_array_equal(a, c)
    # the states live on the store, under its string keys (the
    # reference's), and the blob carries them
    blob = tr.states_blob()
    assert sorted(pt.optimizer.loads_states(blob)) == ["0", "1"]


def test_trainer_accepts_a_kvstore_instance():
    x, y, w, b = _dp_inputs()
    kv = pt.kvstore.create("local")
    got_w, _, tr = _dp_run(pt, [CPU], x, y, w, b, kvstore=kv)
    one_w, _, _ = _dp_run(pt, [CPU], x, y, w, b)
    assert tr._kvstore is kv
    np.testing.assert_array_equal(got_w[0], one_w[0])


def test_trainer_contexts_must_match():
    a = pt.gluon.nn.Dense(2, in_units=3, prefix="a_")
    a.initialize(ctx=_ctxs(pt, 2))
    bnet = pt.gluon.nn.Dense(2, in_units=3, prefix="b_")
    bnet.initialize(ctx=CPU)
    params = a.collect_params()
    params.update(bnet.collect_params())
    with pytest.raises(ValueError, match="same set of contexts"):
        pt.gluon.Trainer(params, "sgd")


def test_trainer_states_blob_over_two_contexts_round_trips():
    x, y, w, b = _dp_inputs()
    _, _, tr = _dp_run(pt, _ctxs(pt, 2), x, y, w, b)
    blob = tr.states_blob()
    states = pt.optimizer.loads_states(blob)
    _, _, fresh = _dp_run(pt, _ctxs(pt, 2), x, y, w, b, steps=0)
    fresh.load_states_blob(blob)
    assert len(fresh._updaters) == 2
    for upd in fresh._updaters:
        assert sorted(upd.states) == sorted(states)
        for i, s in upd.states.items():
            np.testing.assert_array_equal(s.asnumpy(), states[i].asnumpy())


# ---------------------------------------------------------------------------
# the optimizer's states through the store
# ---------------------------------------------------------------------------
def _opcodes(blob):
    """The pickle's opcode stream with the package's module name
    normalised (the arrays are pickled as each package's ``_unpickle``)."""
    out = []
    for op, arg, _ in pickletools.genops(io.BytesIO(blob)):
        if isinstance(arg, str):
            arg = arg.replace("mxnet_tpu_torch", "mxnet_tpu")
        out.append((op.name, arg))
    return [(n, a) for n, a in out if n not in ("MEMOIZE", "FRAME")]


def test_save_optimizer_states_match_the_reference(tmp_path):
    rng = np.random.RandomState(9)
    grads = [rng.randn(3, 2).astype(np.float32) for _ in range(2)]
    mom = rng.randn(3, 2).astype(np.float32)

    def run(lib):
        kv = lib.kvstore.create("local")
        kv.init(0, _nd(lib, np.ones((3, 2), np.float32)))
        kv.set_optimizer(lib.optimizer.SGD(learning_rate=0.1,
                                           momentum=0.9))
        for g in grads:
            kv.push(0, _nd(lib, g))
        # the same state in both (the updates agree to an ulp, not bits)
        kv._updater.states["0"] = _nd(lib, mom)
        fname = str(tmp_path / ("%s.states" % lib.__name__))
        kv.save_optimizer_states(fname)
        out = _nd(lib, np.zeros((3, 2), np.float32))
        kv.pull(0, out=out)
        return kv, fname, out.asnumpy()
    (rkv, rfile, rw), (pkv_, pfile, pw) = _both(run)
    np.testing.assert_allclose(pw, rw, rtol=1e-6)
    rblob, pblob = open(rfile, "rb").read(), open(pfile, "rb").read()
    assert _opcodes(pblob) == _opcodes(rblob)
    # each package reads the other's file
    pkv_.load_optimizer_states(rfile)
    np.testing.assert_array_equal(pkv_._updater.states["0"].asnumpy(), mom)
    rkv.load_optimizer_states(pfile)
    np.testing.assert_array_equal(rkv._updater.states["0"].asnumpy(), mom)


def test_optimizer_states_need_an_optimizer(tmp_path):
    kv = pt.kvstore.create("local")
    with pytest.raises(pt.MXNetError, match="no optimizer"):
        kv.save_optimizer_states(str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# the horovod plugin (reference test_horovod_plugin_delegates)
# ---------------------------------------------------------------------------
def test_horovod_plugin_delegates(monkeypatch):
    import torch
    calls = []

    class _FakeHvd(types.ModuleType):
        def init(self):
            calls.append("init")

        def rank(self):
            return 0

        def size(self):
            return 1

        def broadcast(self, val, root_rank=0, name=None):
            calls.append(("broadcast", name, root_rank))
            assert isinstance(val, torch.Tensor)
            return val

        def allreduce(self, val, average=False, name=None):
            calls.append(("allreduce", name, average))
            return val * 2          # a fake 2-worker sum

    fake = _FakeHvd("horovod.torch")
    pkg = types.ModuleType("horovod")
    pkg.torch = fake
    monkeypatch.setitem(sys.modules, "horovod", pkg)
    monkeypatch.setitem(sys.modules, "horovod.torch", fake)
    kv = pt.kvstore.create("horovod")
    assert kv.type == "horovod"
    assert kv.rank == 0 and kv.num_workers == 1
    assert not kv.is_capable("optimizer")
    v = pt.nd.array(np.array([1.0, 2.0], np.float32), ctx=CPU)
    out = pt.nd.zeros((2,), ctx=CPU)
    kv.broadcast("w0", v, out)
    np.testing.assert_array_equal(out.asnumpy(), [1.0, 2.0])
    g1 = pt.nd.array(np.array([1.0, 1.0], np.float32), ctx=CPU)
    g2 = pt.nd.array(np.array([2.0, 2.0], np.float32), ctx=CPU)
    outg = pt.nd.zeros((2,), ctx=CPU)
    kv.pushpull("g0", [g1, g2], out=outg)
    np.testing.assert_array_equal(outg.asnumpy(), [6.0, 6.0])
    assert calls[0] == "init"
    assert ("allreduce", "g0", False) in calls


def test_horovod_needs_its_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "horovod", None)
    monkeypatch.setitem(sys.modules, "horovod.torch", None)
    monkeypatch.setitem(sys.modules, "horovod.mxnet", None)
    for lib in (mx, pt):
        with pytest.raises(lib.MXNetError, match="horovod"):
            lib.kvstore.create("horovod")


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------
def test_gradient_compression_refused(monkeypatch):
    """Gradient compression is ported (item 11): every type routes to
    the int8 quantized wire with error feedback, with the reference's
    warning (once a process); an unknown type raises as the reference's
    does."""
    monkeypatch.setattr(pkv, "_COMPRESSION_WARNED", False)
    kv = pt.kvstore.create("local")
    with pytest.warns(FutureWarning, match="int8 quantized"):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    assert kv._quant_cfg() == pt.parallel.quantize.QuantConfig()
    with pytest.raises(pt.MXNetError, match="unsupported compression"):
        kv.set_gradient_compression({"type": "3bit"})


def test_quantized_sync_refused(monkeypatch):
    """MXNET_KVSTORE_QUANTIZE=int8 is ported (item 11): one replica has
    nothing on the wire and is its own sum; two replicas on distinct
    contexts sum through the quantized wire (values on the int8 grid
    come through exactly)."""
    monkeypatch.setenv("MXNET_KVSTORE_QUANTIZE", "int8")
    kv = pt.kvstore.create("device")
    kv.init("w", pt.nd.zeros((2,), ctx=CPU))
    one = pt.nd.ones((2,), ctx=CPU)
    kv.pushpull_list(["w"], [[one]])
    np.testing.assert_array_equal(one.asnumpy(), [1, 1])
    reps = [pt.nd.array(np.array([1.0, -127.0], np.float32),
                        ctx=pt.cpu(i)) for i in range(2)]
    kv.pushpull_list(["w"], [reps])
    for r in reps:
        np.testing.assert_array_equal(r.asnumpy(), [2.0, -254.0])
    assert kv._quant_state


def test_row_sparse_pull_refused():
    kv = pt.kvstore.create("local")
    kv.init("w", pt.nd.zeros((2,), ctx=CPU))
    with pytest.raises(NotImplementedError, match="item 16"):
        kv.row_sparse_pull("w", out=pt.nd.zeros((2,), ctx=CPU),
                           row_ids=pt.nd.zeros((1,), ctx=CPU))


# ---------------------------------------------------------------------------
# the configuration keys of the slice read the environment as the
# reference's do
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [
    "MXNET_DIST_INIT_TIMEOUT", "MXNET_DIST_INIT_BACKOFF",
    "MXNET_DIST_INIT_RETRIES", "MXNET_BARRIER_TIMEOUT",
    "MXNET_KVSTORE_TIMEOUT", "MXNET_KVSTORE_RETRIES",
    "MXNET_KVSTORE_BIGARRAY_BOUND", "MXNET_COMMWATCH",
    "MXNET_GUARD_COMM_VOTE", "MXNET_STRAGGLER_WARN", "DMLC_ROLE",
    "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_NUM_WORKER",
    "DMLC_NUM_SERVER", "DMLC_WORKER_ID"])
def test_config_key_matches_the_reference(monkeypatch, name):
    r, p = mx.config.VARS[name], pt.config.VARS[name]
    assert (p.type, p.default) == (r.type, r.default)
    assert pt.config.get(name) == mx.config.get(name)
    raw = {bool: "0", int: "7", float: "2.5", str: "x"}[r.type]
    monkeypatch.setenv(name, raw)
    assert pt.config.get(name) == mx.config.get(name)
