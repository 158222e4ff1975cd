"""BatchNorm across the replicas of ``ShardedTrainStep`` and the layout
pass's hoisted weights, against the reference's ``tests/test_sync_bn.py``
and the sharded-step cases of ``tests/test_layout_opt.py``.

In the reference, BatchNorm inside the sharded program sees the global
batch (its partitioner adds the cross-device sum), so ``SyncBatchNorm``
is BatchNorm there. The port's replicas sum their per-channel sums, sums
of squares and counts over the batch axes (``ops/nn.py``
``_BNTrainFn``); a control with that sum taken away must miss the
reference. Tolerances: rtol 1e-5 on parameters and moving statistics
after 3 steps, with an absolute floor of 1e-5 of the array's largest
magnitude (f32; the sums run in other orders, and an element near zero
keeps the rounding of its larger neighbours), 1e-5 on the normalized
outputs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import parallel as rpar
from mxnet_tpu_torch import parallel as ppar

CPUS = [pt.cpu(i) for i in range(8)]
TOL = dict(rtol=1e-5, atol=1e-6)


def close(got, want, err_msg=""):
    """Within rtol 1e-5, the absolute floor 1e-5 of want's largest
    magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    for var in ("MXNET_LAYOUT_OPT", "MXNET_CONV_S2D"):
        monkeypatch.delenv(var, raising=False)
    yield


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(jax.device_get(x))


def small_convnet(lib, bn="BatchNorm", prefix="scn_"):
    """The reference's ``_small_convnet`` (tests/test_layout_opt.py),
    its BatchNorm of kind ``bn``."""
    nn = lib.gluon.nn

    def norm():
        if bn == "SyncBatchNorm":
            return lib.gluon.contrib.nn.SyncBatchNorm(num_devices=4)
        return nn.BatchNorm()
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, strides=2, padding=1, use_bias=True),
                norm(), nn.Activation("relu"), nn.MaxPool2D(pool_size=2),
                nn.Conv2D(16, 1), norm(), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(10))
    return net


def twin(bn="BatchNorm", seed=0):
    mx.random.seed(seed)
    rnet = small_convnet(mx, bn)
    rnet.initialize()
    rnet(mx.nd.ones((4, 3, 16, 16)))
    pnet = small_convnet(pt, bn)
    pnet.initialize(ctx=pt.cpu())
    pnet(pt.nd.ones((4, 3, 16, 16), ctx=pt.cpu()))
    arrays = {k: p.data().asnumpy() for k, p in rnet.collect_params().items()}
    pt.params_from_numpy(pnet, arrays, ctx=pt.cpu())
    return rnet, pnet


def batch(seed=0, n=8, shift=1.0):
    rng = np.random.RandomState(seed)
    # each quarter of the batch from another distribution
    x = np.concatenate([rng.rand(n // 4, 3, 16, 16) + shift * i
                        for i in range(4)]).astype(np.float32)
    y = rng.randint(0, 10, (n,)).astype(np.float32)
    return x, y


def ref_params(rstep):
    """The reference step's masters in the documented layouts (its
    hoisted conv weights transposed back from HWIO)."""
    out = {}
    for k, v in rstep.params.items():
        v = _np(v)
        perm = rstep._param_transforms.get(k)
        if perm is not None:
            v = np.transpose(v, np.argsort(perm))
        out[k] = v
    return out


def train(lib, net, mesh, steps, x, y, **kw):
    par = rpar if lib is mx else ppar
    step = par.ShardedTrainStep(net, lib.gluon.loss.SoftmaxCrossEntropyLoss(),
                                mesh, **kw)
    ctx = {} if lib is mx else {"ctx": pt.cpu()}
    losses = [float(_np(step.step(lib.nd.array(x, **ctx),
                                  lib.nd.array(y, **ctx))))
              for _ in range(steps)]
    return step, losses


# ---------------------------------------------------------------------------
# BatchNorm across the replicas
# ---------------------------------------------------------------------------
def test_sync_bn_api_and_single_device():
    bn = pt.gluon.contrib.nn.SyncBatchNorm(in_channels=4, num_devices=8,
                                           prefix="sbn_")
    bn.initialize(ctx=pt.cpu())
    x = pt.nd.array(np.random.RandomState(0).rand(6, 4, 3, 3)
                    .astype(np.float32), ctx=pt.cpu())
    with pt.autograd.record():
        out = bn(x)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.asnumpy().mean(axis=(0, 2, 3)),
                               np.zeros(4), atol=1e-3)


class _Dot(pt.gluon.HybridBlock):
    """A loss linear in the output: each sample's sum of out * label."""

    def hybrid_forward(self, F, out, label):
        return F.sum(out * label, axis=(1, 2, 3))


def test_bn_stats_span_global_batch_under_sharding():
    """BatchNorm inside a dp=4 step normalizes with the global batch's
    statistics: the step's loss, linear in the output, equals the one of
    the reference's global normalization of the same batch."""
    ndev = 4
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.rand(2, 3, 4, 4) + 10 * i
                        for i in range(ndev)]).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)

    def bn_train(xb):
        mean = jnp.mean(xb, axis=(0, 2, 3), keepdims=True)
        var = jnp.var(xb, axis=(0, 2, 3), keepdims=True)
        return (xb - mean) / jnp.sqrt(var + 1e-5)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:ndev]), ("dp",))
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))
    with mesh:
        ref = np.asarray(jax.jit(bn_train, in_shardings=sh,
                                 out_shardings=sh)(jax.device_put(x, sh)))
    want = float((ref.astype(np.float64) * w).sum())
    losses = []
    for sync in (True, False):
        bn = pt.gluon.nn.BatchNorm(in_channels=3, prefix="gbn_")
        bn.initialize(ctx=pt.cpu())
        step = ppar.ShardedTrainStep(
            bn, _Dot(prefix="dot_"), ppar.make_mesh(ppar.MeshConfig(dp=ndev),
                                       devices=CPUS[:ndev]),
            optimizer="sgd", lr=0.0, momentum=0.0)
        if not sync:
            step._batch_axes = ()      # the control: per-replica statistics
        losses.append(float(_np(step.step(pt.nd.array(x, ctx=pt.cpu()),
                                          pt.nd.array(w, ctx=pt.cpu())))))
    np.testing.assert_allclose(losses[0], want, rtol=1e-5, atol=1e-4)
    assert abs(losses[1] - want) > 1e-2


@pytest.mark.parametrize("bn", ["BatchNorm", "SyncBatchNorm"])
def test_convnet_dp4_matches_the_reference(bn, monkeypatch):
    """The small convnet, 3 SGD steps at dp=4 on a batch whose quarters
    differ: parameters and moving statistics within rtol 1e-5 of the
    reference's; without the cross-replica sum they are not."""
    x, y = batch(3)
    rnet, pnet = twin(bn)
    kw = dict(optimizer="sgd", lr=0.05, momentum=0.9)
    rstep, rl = train(mx, rnet, rpar.make_mesh(rpar.MeshConfig(dp=4),
                                               devices=jax.devices()[:4]),
                      3, x, y, **kw)
    pmesh = ppar.make_mesh(ppar.MeshConfig(dp=4), devices=CPUS[:4])
    pstep, pl = train(pt, pnet, pmesh, 3, x, y, **kw)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    for got, want in ((pstep.params, ref_params(rstep)),
                      (pstep.aux, rstep.aux)):
        assert sorted(got) == sorted(want)
        for k in want:
            close(_np(got[k]), _np(want[k]), err_msg=k)
    _, pnet2 = twin(bn)
    from mxnet_tpu_torch.ops import nn as port_nn
    monkeypatch.setattr(port_nn, "_batch_reducer", lambda: None)
    cstep, _ = train(pt, pnet2, pmesh, 3, x, y, **kw)
    far = []
    for k in rstep.aux:
        try:
            close(_np(cstep.aux[k]), _np(rstep.aux[k]))
        except AssertionError:
            far.append(k)
    assert far, "the control without the cross-replica sum was not caught"


def test_sync_bn_outside_a_step_is_batch_norm():
    x = np.random.RandomState(4).randn(6, 3, 5, 5).astype(np.float32)
    res = []
    for make in (lambda: pt.gluon.nn.BatchNorm(in_channels=3, prefix="obn_"),
                 lambda: pt.gluon.contrib.nn.SyncBatchNorm(
                     in_channels=3, num_devices=4, prefix="osbn_")):
        blk = make()
        blk.initialize(ctx=pt.cpu())
        xa = pt.nd.array(x, ctx=pt.cpu())
        xa.attach_grad()
        with pt.autograd.record():
            out = blk(xa)
            loss = (out * out * out).sum()
        loss.backward()
        res.append([out.asnumpy(), xa.grad.asnumpy(),
                    blk.running_mean.data().asnumpy(),
                    blk.running_var.data().asnumpy()])
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the layout pass's hoisted weights
# ---------------------------------------------------------------------------
def _ref_transforms(rnet):
    import mxnet_tpu.symbol as sym_mod
    from mxnet_tpu.symbol.layout_opt import convert_layout
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loss_sym = loss_fn(rnet(sym_mod.var("data0")), sym_mod.var("data1"))
    if isinstance(loss_sym, (list, tuple)):
        loss_sym = loss_sym[0]
    transforms = {}
    convert_layout(loss_sym, collect_transforms=transforms)
    return transforms


def test_weight_transpose_hoisting():
    """Both conv weights, the reference's hoisted ones, are stored
    channels-last after the first step (f32 under TF32, an island on
    the port's path), and no later step converts a weight."""
    import torch
    rnet, pnet = twin()
    x, y = batch(0, shift=0.0)
    step = ppar.ShardedTrainStep(pnet, pt.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 ppar.make_mesh(ppar.MeshConfig(dp=1),
                                                devices=CPUS[:1]),
                                 lr=0.05, momentum=0.9,
                                 data_specs=[ppar.P(), ppar.P()])
    assert step._param_transforms == {}
    step.step(pt.nd.array(x, ctx=pt.cpu()), pt.nd.array(y, ctx=pt.cpu()))
    # the first run converts the 3x3 weight; the 1x1 one is channels-last
    # as it is stored
    assert step.stats["weight_conversions"] == 1
    want = _ref_transforms(rnet)
    assert sorted(step._param_transforms) == sorted(want)
    assert all(v == (2, 3, 1, 0) for v in want.values())
    rep = step._replicas[0]
    for k in want:
        assert rep.params[k].is_contiguous(memory_format=torch.channels_last)
        assert all(s.is_contiguous(memory_format=torch.channels_last)
                   for s in rep.states[k])
    step.step(pt.nd.array(x, ctx=pt.cpu()), pt.nd.array(y, ctx=pt.cpu()))
    assert step.stats["weight_conversions"] == 0


def test_sharded_step_with_layout_opt_matches_the_reference():
    """3 steps with the pass on, dp=1: the parameters the step writes
    back into the net are contiguous NCHW arrays equal to the
    reference's (its HWIO storage transposed back)."""
    rnet, pnet = twin(seed=5)
    x, y = batch(5, shift=0.0)
    kw = dict(lr=0.05, momentum=0.9)
    rstep, rl = train(mx, rnet, rpar.make_mesh(rpar.MeshConfig(dp=1),
                                               devices=jax.devices()[:1]),
                      3, x, y, data_specs=[rpar.P(), rpar.P()], **kw)
    pstep, pl = train(pt, pnet, ppar.make_mesh(ppar.MeshConfig(dp=1),
                                               devices=CPUS[:1]),
                      3, x, y, data_specs=[ppar.P(), ppar.P()], **kw)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    rstep.write_back(rnet)
    pstep.write_back(pnet)
    got = pnet.collect_params()
    for k, p in rnet.collect_params().items():
        t = got[k].data().tensor()
        assert t.is_contiguous(), k
        close(t.detach().numpy(), p.data().asnumpy(), err_msg=k)


def test_sharded_step_with_layout_opt_learns():
    _, pnet = twin(seed=6)
    x, y = batch(6, shift=0.0)
    shapes = {n: p.data().shape for n, p in pnet.collect_params().items()}
    step, losses = train(pt, pnet, ppar.make_mesh(ppar.MeshConfig(dp=1),
                                                  devices=CPUS[:1]),
                         30, x, y, lr=0.05, momentum=0.9,
                         data_specs=[ppar.P(), ppar.P()])
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    step.write_back(pnet)
    for n, p in pnet.collect_params().items():
        assert p.data().shape == shapes[n], n


def test_sharded_step_updates_bn_moving_stats():
    _, pnet = twin(seed=7)
    step = ppar.ShardedTrainStep(pnet, pt.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 ppar.make_mesh(ppar.MeshConfig(dp=1),
                                                devices=CPUS[:1]),
                                 lr=0.01, data_specs=[ppar.P(), ppar.P()])
    before = {k: _np(v) for k, v in step.aux.items()}
    assert before and all(k.endswith(("running_mean", "running_var"))
                          for k in before)
    x, y = batch(7, shift=0.0)
    for _ in range(5):
        step.step(pt.nd.array(x + 1.0, ctx=pt.cpu()),
                  pt.nd.array(y, ctx=pt.cpu()))
    assert any(not np.allclose(_np(step.aux[k]), before[k]) for k in before)
    step.write_back(pnet)
    name = next(k for k in step.aux if k.endswith("running_mean"))
    np.testing.assert_allclose(pnet.collect_params()[name].data().asnumpy(),
                               _np(step.aux[name]), rtol=1e-5)
