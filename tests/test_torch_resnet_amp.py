"""One SGD step of ``resnet18_v1`` (32x32, batch 2) under bf16 AMP in
the port against the reference under AMP: ``bench.py``'s headline runs
AMP over ResNet, where the port's BatchNorm sees bf16 data with f32
gamma, beta and moving statistics. Held by the reference's own
AMP-vs-f32 distance of each array, as in tests/test_torch_amp.py (on
the CPU the port's read at most 0.62 of it, median 0.36 for the
gradients; the loss equal).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as ref_amp
from mxnet_tpu.gluon.model_zoo import vision as rvision

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision

from test_torch_amp import FACTOR, _amp, _ctx, _dist


@pytest.fixture(autouse=True)
def _amp_reset(monkeypatch):
    for var in list(pt.config.VARS) + ["MXNET_OPTIMIZER_AGGREGATION_SIZE"]:
        monkeypatch.delenv(var, raising=False)
    yield
    amp.reset()
    ref_amp.reset()


def _resnet18(lib, arrays, use_amp):
    """One SGD step of resnet18_v1 at 32x32, batch 2, under bf16 AMP
    (bench.py's headline casts) or in f32: (loss, gradients, weights
    after the step)."""
    if use_amp:
        _amp(lib).init(target_dtype="bfloat16")
    ctx = _ctx(lib)
    zoo = rvision if lib is mx else pvision
    net = zoo.resnet18_v1(classes=10, prefix="r18_")
    if lib is mx:
        net.initialize(ctx=ctx)
        net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
        for n, p in net.collect_params().items():
            p.set_data(mx.nd.array(arrays[n]))
    else:
        pt.params_from_numpy(net, arrays, ctx=ctx)
    rng = np.random.RandomState(3)
    x = lib.nd.array(rng.randn(2, 3, 32, 32).astype(np.float32), ctx=ctx)
    y = lib.nd.array(np.array([1, 7], np.float32), ctx=ctx)
    params = net.collect_params()
    trainer = lib.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                                "momentum": 0.9})
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    with lib.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    trainer.step(2)
    weights = {n: p.data().asnumpy() for n, p in params.items()}
    if use_amp:
        _amp(lib).reset()
    return loss.asnumpy(), grads, weights


def test_resnet18_sgd_step_under_amp_matches_reference():
    """bf16 convolutions and Dense, BatchNorm on bf16 data with f32
    gamma, beta and moving statistics: the loss, every gradient and
    every weight (moving statistics included) after one step, each by
    the reference's own AMP-vs-f32 distance of that array."""
    mx.random.seed(0)
    probe = rvision.resnet18_v1(classes=10, prefix="r18_")
    probe.initialize(init=mx.initializer.Xavier(magnitude=2.0))
    probe(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    arrays = {n: p.data().asnumpy() for n, p in
              probe.collect_params().items()}
    ref_f32 = _resnet18(mx, arrays, False)
    ref_amp_run = _resnet18(mx, arrays, True)
    port_amp = _resnet18(pt, arrays, True)
    assert _dist(port_amp[0], ref_amp_run[0]) <= \
        FACTOR * _dist(ref_amp_run[0], ref_f32[0])
    for k in (1, 2):
        assert port_amp[k].keys() == ref_amp_run[k].keys()
        for n in ref_amp_run[k]:
            own = _dist(ref_amp_run[k][n], ref_f32[k][n])
            got = _dist(port_amp[k][n], ref_amp_run[k][n])
            assert got <= FACTOR * own + 1e-7, (n, got, own)
        # not the f32 run: over the arrays of each kind, the port's AMP
        # step at least 1 / FACTOR of the reference's largest distance
        # from f32 away from the f32 step (0.87 on the CPU)
        assert max(_dist(port_amp[k][n], ref_f32[k][n])
                   for n in ref_amp_run[k]) >= \
            max(_dist(ref_amp_run[k][n], ref_f32[k][n])
                for n in ref_amp_run[k]) / FACTOR
