"""Mesh-sharded serving (``InferenceSession(mesh=, param_specs=,
data_spec=)``), the engine's collective pushes and the
``engine_collective_overlap`` fault site, against the reference's
``tests/test_serve.py::TestShardedAndMixed`` (its pjit-sharded session
and its rng graph) on the 8 virtual CPU devices of ``tests/conftest.py``;
the port serves on ``cpu(0)..cpu(7)``, one thread a device, with the
reference's weights. Outputs within rtol 1e-5 (atol 1e-5, the reference
test's own) of the reference's.

The places where the port's mesh session differs from the reference's
pjit partitioning are pinned as gaps: ``param_specs`` is checked but
not applied (every device holds every whole weight, runs every product
and no collective a request), a mesh of several devices captures
nothing, a mesh of one device reads the live weights, and ``data_spec``
splits the batch axis only.
"""
import threading

import numpy as np
import pytest

import jax

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.kvstore import device_mesh
from mxnet_tpu_torch import engine as p_engine
from mxnet_tpu_torch import faultinject
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import P
from mxnet_tpu_torch.parallel.mesh import contexts_mesh
from mxnet_tpu_torch.serve import Scheduler

TOL = dict(rtol=1e-5, atol=1e-5)
CPUS = [pt.cpu(i) for i in range(8)]
RULE = [(r".*dense1.*weight", P("mp", None))]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_SERVE_BUCKETS", raising=False)
    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    faultinject.reset()
    yield
    faultinject.reset()
    pt.telemetry.refresh()
    pt.telemetry.reset()


def _pair(build, seed=0):
    """The reference's net, and the port's with its weights by name."""
    mx.random.seed(seed)
    rnet = build(mx)
    rnet.initialize(init=mx.initializer.Xavier())
    pnet = build(pt)
    pnet.initialize(ctx=pt.cpu())
    arrays = {k: p.data().asnumpy() for k, p in rnet.collect_params().items()}
    assert sorted(arrays) == sorted(pnet.collect_params().keys())
    pt.params_from_numpy(pnet, arrays, ctx=pt.cpu())
    return rnet, pnet


def _mlp(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(32, in_units=16, activation="relu",
                         prefix="dense0_"),
                nn.Dense(8, in_units=32, prefix="dense1_"))
    return net


def _dropout_net(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix="drop_")
    with net.name_scope():
        net.add(nn.Dense(16, in_units=16, activation="relu",
                         prefix="dense0_"),
                nn.Dropout(0.5), nn.Dense(8, in_units=16, prefix="dense1_"))
    return net


def _pmesh(n=8):
    return contexts_mesh(CPUS[:n], ("mp",))


def _x():
    return pt.nd.ones((2, 16), ctx=pt.cpu())


def test_pjit_sharded_session():
    rnet, pnet = _pair(_mlp)
    xs = np.random.RandomState(0).rand(3, 16).astype(np.float32)
    rmesh = device_mesh(jax.devices()[:8], ("mp",))
    rsess = rnet.serve_session(mx.nd.ones((2, 16)), max_batch=4, mesh=rmesh,
                               param_specs=[(r".*dense1.*weight",
                                             jax.sharding.PartitionSpec(
                                                 "mp", None))])
    ref = pnet.serve_session(_x(), max_batch=4)
    sess = pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(),
                              param_specs=RULE)
    got = sess.infer(xs)
    np.testing.assert_allclose(got, rsess.infer(xs), **TOL)
    np.testing.assert_allclose(got, ref.infer(xs), **TOL)
    # the weights are resident on the mesh, one whole copy a device
    name = [n for n in sess._weights if "dense1" in n and "weight" in n][0]
    assert [(tuple(w.shape), w.device) for w in sess._weights[name]] == \
        [((8, 32), c.torch_device) for c in CPUS]
    # a weight update reaches the session at refresh_weights
    for lib, net in ((mx, rnet), (pt, pnet)):
        for _, p in net.collect_params().items():
            p.set_data(p.data() * 0.5)
    np.testing.assert_array_equal(sess.infer(xs), got)
    sess.refresh_weights()
    rsess.refresh_weights()
    got2 = sess.infer(xs)
    assert not np.allclose(got2, got)
    np.testing.assert_allclose(got2, rsess.infer(xs), **TOL)


def test_sharded_session_rng_graph():
    """A graph with a random op (Dropout, the identity in eval) serves
    on the mesh: each device draws from a generator of its own."""
    rnet, pnet = _pair(_dropout_net)
    xs = np.random.RandomState(1).rand(2, 16).astype(np.float32)
    rsess = rnet.serve_session(mx.nd.ones((2, 16)), max_batch=2,
                               mesh=device_mesh(jax.devices()[:8], ("mp",)))
    sess = pnet.serve_session(_x(), max_batch=2, mesh=_pmesh())
    ref = pnet.serve_session(_x(), max_batch=2)
    got = sess.infer(xs)
    np.testing.assert_allclose(got, rsess.infer(xs), **TOL)
    np.testing.assert_allclose(got, ref.infer(xs), **TOL)


def test_data_spec_splits_the_batch():
    """Requests split over the devices by ``data_spec``; a bucket that
    does not divide is padded to the devices and cut back."""
    _, pnet = _pair(_mlp)
    ref = pnet.serve_session(_x(), max_batch=8)
    sess = pnet.serve_session(_x(), max_batch=8, mesh=_pmesh(4),
                              param_specs=RULE, data_spec=P("mp"))
    rng = np.random.RandomState(2)
    for rows in (8, 3, 1):
        xs = rng.rand(rows, 16).astype(np.float32)
        got = sess.infer(xs)
        assert got.shape == (rows, 8)
        np.testing.assert_allclose(got, ref.infer(xs), **TOL)


def test_param_specs_are_checked_at_construction():
    _, pnet = _pair(_mlp)
    with pytest.raises(MXNetError, match="mesh axis 'tp'"):
        pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(),
                           param_specs=[(r".*dense1.*weight", P("tp"))])
    with pytest.raises(MXNetError, match="rank"):
        pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(),
                           param_specs=[(r".*dense1.*bias",
                                         P("mp", None))])
    with pytest.raises(MXNetError, match="does not divide"):
        pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(3),
                           param_specs=[(r".*dense1.*weight", P("mp"))])


def test_collective_tag():
    _, pnet = _pair(_mlp)
    sess = pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(2),
                              param_specs=RULE)
    tag = sess.collective_tag()
    assert tag["lock"] == id(sess._exec_lock)
    assert "mp" in tag["program"]
    assert pnet.serve_session(_x(), max_batch=4).collective_tag() is None
    assert pnet.serve_session(_x(), max_batch=4,
                              mesh=_pmesh(1)).collective_tag() is None


def _scheduled(pnet, rows=2, n=6):
    sess = pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(2),
                              param_specs=RULE)
    sess.warmup()
    sched = Scheduler(sess, max_wait_ms=1, inflight=2)
    rng = np.random.RandomState(3)
    xs = [rng.rand(rows, 16).astype(np.float32) for _ in range(n)]
    try:
        futs = [sched.submit(x) for x in xs]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        sched.close()
    for x, o in zip(xs, outs):
        np.testing.assert_allclose(o, sess.infer(x), **TOL)
    return sess


def test_scheduler_pushes_with_the_tag():
    _, pnet = _pair(_mlp)
    eng = p_engine.native_engine()
    before = len(eng.collective_pushes())
    sess = _scheduled(pnet)
    pushes = [d for label, d in eng.collective_pushes()[before:]
              if label == "serve.batch"]
    assert pushes and all(d == sess.collective_tag() for d in pushes)


def test_engine_collective_overlap_strips_the_lock():
    """The fault site strips the lock from the recorded descriptor of a
    push that names one, never from one without, and counts its fires;
    the op runs as before."""
    _, pnet = _pair(_mlp)
    eng = p_engine.native_engine()
    faultinject.set_fault("engine_collective_overlap", 1.0)
    before = len(eng.collective_pushes())
    var = eng.new_var()
    eng.push_async(lambda: None, write_vars=(var,), label="nolock",
                   collective={"program": "p", "lock": None})
    eng.wait_for_var(var)
    assert faultinject.fires("engine_collective_overlap") == 0
    sess = _scheduled(pnet)
    pushes = [d for label, d in eng.collective_pushes()[before:]
              if label == "serve.batch"]
    assert pushes and all(d["lock"] is None for d in pushes)
    assert all(d["program"] == sess.collective_tag()["program"]
               for d in pushes)
    assert faultinject.fires("engine_collective_overlap") == len(pushes)


# ---------------------------------------------------------------------------
# the gaps against the reference's pjit partitioning
# ---------------------------------------------------------------------------
def test_gap_the_compute_is_replicated(monkeypatch):
    """``param_specs`` is checked but not applied: every device holds
    every whole weight from refresh_weights on and runs every product
    (pjit would split dense1's product over mp), so a request runs no
    collective."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    pt.telemetry.refresh()
    pt.telemetry.reset()
    _, pnet = _pair(_mlp)
    sess = pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(),
                              param_specs=RULE)
    assert tuple(sess._specs["mlp_dense1_weight"]) == ("mp", None)
    assert all(tuple(w.shape) == tuple(p.shape)
               for n, p in pnet.collect_params().items()
               for w in sess._weights[n])
    pt.telemetry.reset()
    sess.infer(np.ones((2, 16), np.float32))
    assert pt.commwatch.report() == []


def test_gap_a_mesh_of_several_devices_captures_nothing(monkeypatch):
    """Several devices run eagerly, one thread a device: no CachedOp
    call, no capture (the reference compiles one program a bucket)."""
    from mxnet_tpu_torch import cached_op
    _, pnet = _pair(_mlp)
    sess = pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(2))
    calls = []
    real = cached_op.CachedOp.__call__

    def spy(self, *a, **k):
        calls.append(threading.current_thread().name)
        return real(self, *a, **k)
    monkeypatch.setattr(cached_op.CachedOp, "__call__", spy)
    sess.infer(np.ones((2, 16), np.float32))
    assert calls == []


def test_gap_a_one_device_mesh_reads_the_live_weights():
    """A mesh of one device is the single-device session there: it reads
    the parameters in place, so an update shows without a refresh (the
    reference's sharded session serves its placed copy until
    refresh_weights)."""
    _, pnet = _pair(_mlp)
    sess = pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(1))
    assert not sess._sharded and sess._ctx == pt.cpu(0)
    xs = np.ones((2, 16), np.float32)
    before = sess.infer(xs)
    for _, p in pnet.collect_params().items():
        p.set_data(p.data() * 0.5)
    assert not np.allclose(sess.infer(xs), before)


def test_gap_data_spec_splits_the_batch_axis_only():
    _, pnet = _pair(_mlp)
    with pytest.raises(MXNetError, match="batch axis only"):
        pnet.serve_session(_x(), max_batch=4, mesh=_pmesh(2),
                           data_spec=P(None, "mp"))
