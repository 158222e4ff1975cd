"""The slice of ``chip_smoke.py`` phase 9 on the CPU, at full width: the
MNIST MLP of ``example/image_classification/train_mnist.py``
(784-128-64-10, Xavier, ``SoftmaxCrossEntropyLoss``, SGD lr 0.1, batch
64) on its ``--synthetic`` data through ``gluon.data``, with both relus a
``CustomOp`` whose forward and backward launch rtc kernels.

* The port's custom-op MLP against the reference's, whose ``CustomOp``
  launches the same kernel bodies as Pallas kernels (interpret mode):
  three SGD steps on the same shuffled batches from the same weights,
  every weight within 1e-5 relative L2 and the loss within 1e-6 (the two
  differ only in the order of f32 sums in the matmuls).
* The port's custom-op MLP against its ``Dense(activation="relu")``
  twin: bit for bit, as ``chip_smoke.py`` holds it on the card.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

import chip_smoke as cs
from test_torch_gluon_surface import _xavier_from

STEPS = 3


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _register_reference_relu():
    import jax.numpy as jnp

    def relu_fwd(x_ref, y_ref):
        y_ref[...] = jnp.maximum(x_ref[...], 0)

    def relu_bwd(dy_ref, y_ref, dx_ref):
        dx_ref[...] = jnp.where(y_ref[...] > 0, dy_ref[...], 0)

    mod = mx.rtc.PallasModule(relu_fwd, relu_bwd)
    fwd, bwd = mod.get_kernel("relu_fwd"), mod.get_kernel("relu_bwd")

    class PallasRelu(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], fwd.launch([in_data[0]]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        bwd.launch([out_grad[0], out_data[0]]))

    class PallasReluProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return PallasRelu()

    if mx.operator.get_prop("ttm_pallas_relu") is None:
        mx.operator.register("ttm_pallas_relu")(PallasReluProp)


def _reference_mlp():
    nn = mx.gluon.nn

    class PallasRelu(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Custom(x, op_type="ttm_pallas_relu")

    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(128), PallasRelu(), nn.Dense(64), PallasRelu(),
                nn.Dense(10))
    return net


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _train(lib, ctx, net, X, y, steps=STEPS):
    """``steps`` SGD steps on the loader's shuffled batches; returns the
    loss and every weight after each step."""
    trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": cs.MNIST_LR})
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    np.random.seed(7)
    with ctx:
        loader = lib.gluon.data.DataLoader(
            lib.gluon.data.ArrayDataset(X, y), batch_size=cs.MNIST_BATCH,
            shuffle=True)
        out = []
        for data, label in loader:
            with lib.autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(data.shape[0])
            out.append((loss.asnumpy(),
                        {n: p.data().asnumpy()
                         for n, p in net.collect_params().items()}))
            if len(out) == steps:
                return out


@pytest.fixture(scope="module")
def slice_data():
    return _slice_data(0)


def _slice_data(seed):
    """The data, and the reference's MLP with weights drawn from a
    RandomState of ``seed``."""
    X, y, _, _ = cs.mnist_synthetic(600)
    _register_reference_relu()
    cs.register_rtc_relu(pt, pt.rtc.CudaModule(cs.RTC_SOURCE,
                                               plain=cs.rtc_plain()))
    ref = _reference_mlp()
    ref.initialize(mx.initializer.Xavier())
    ref(mx.nd.array(X[:1]))
    _xavier_from(np.random.RandomState(seed), ref)
    init = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    return X, y, ref, init


def test_custom_op_mlp_matches_reference_custom_op_mlp(slice_data):
    _check_mlp(*slice_data)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_custom_op_mlp_matches_reference_at_seeds(seed):
    """Seeds 1-4 of the reference's weights, at the tolerances of seed
    0."""
    _check_mlp(*_slice_data(seed))


def _check_mlp(X, y, ref, init):
    port = cs.mnist_mlp(pt, True)
    pt.params_from_numpy(port, init, ctx=pt.cpu())   # the reference's names
    assert sorted(init) == sorted(port.collect_params().keys()) == [
        "mlp_dense%d_%s" % (i, k) for i in range(3)
        for k in ("bias", "weight")]
    assert init["mlp_dense0_weight"].shape == (128, 784)
    got = _train(pt, pt.cpu(), port, X, y)
    want = _train(mx, mx.cpu(), ref, X, y)
    assert len(got) == len(want) == STEPS
    for (loss, weights), (rloss, rweights) in zip(got, want):
        assert loss.shape == (cs.MNIST_BATCH,)
        assert _rel(loss, rloss) <= 1e-6
        for name, w in rweights.items():
            assert _rel(weights[name], w) <= 1e-5, name
    # the weights moved
    assert _rel(got[-1][1]["mlp_dense0_weight"],
                init["mlp_dense0_weight"]) > 1e-4


def test_custom_op_mlp_equals_its_dense_relu_twin_bit_for_bit(slice_data):
    X, y, _, init = slice_data
    nets = cs._mnist_nets(pt, init, pt.cpu())
    loss_fn = pt.gluon.loss.SoftmaxCrossEntropyLoss()
    np.random.seed(3)
    with pt.cpu():
        loader = pt.gluon.data.DataLoader(
            pt.gluon.data.ArrayDataset(X, y), batch_size=cs.MNIST_BATCH,
            shuffle=True)
        metric = pt.metric.Accuracy()
        for step, (data, label) in enumerate(loader):
            out, loss = cs._mnist_step(*nets["custom"], loss_fn, data, label)
            _, tloss = cs._mnist_step(*nets["twin"], loss_fn, data, label)
            metric.update([label], [out])
            assert cs._mnist_diff(nets, loss, tloss) is None, step
            if step == STEPS - 1:
                break
        assert 0.0 <= metric.get()[1] <= 1.0 and metric.num_inst == 192
        # the planted fault of chip_smoke.py is caught here too
        bad = cs._mnist_nets(pt, init, pt.cpu(), leak_grad=True)
        _, loss = cs._mnist_step(*bad["custom"], loss_fn, data, label)
        _, tloss = cs._mnist_step(*bad["twin"], loss_fn, data, label)
        assert cs._mnist_diff(bad, loss, tloss) is not None


def test_synthetic_data_is_train_mnists():
    X, y, Xv, yv = cs.mnist_synthetic()
    assert X.shape == (5000, 1, 28, 28) and Xv.shape == (1000, 1, 28, 28)
    rng = np.random.RandomState(42)
    W = rng.rand(784, 10).astype(np.float32)
    np.testing.assert_array_equal(X[:5], rng.rand(5, 1, 28, 28).astype(
        np.float32))
    np.testing.assert_array_equal(
        y[:5], (X[:5].reshape(5, -1) @ W).argmax(1).astype(np.float32))
    assert set(np.unique(yv)) <= set(range(10))
