"""The port's autograd, parameter gradients, losses, optimizers and
Trainer against the reference, on the CPU.

Both packages get the same numpy inputs; weights move by name with
``params_from_numpy``. Everything here runs in f32 and agrees within
1e-5 (abs + rel) unless a test states otherwise: the two packages differ
only in the order of f32 sums.

The MLP is the exit test of ROADMAP.md queue 1 item 4: synthetic
MNIST-shaped data, SGD with momentum, held step for step.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu.ops import optimizer_ops as ref_ops
from mxnet_tpu_torch.ops import optimizer_ops as port_ops

TOL = dict(rtol=1e-5, atol=1e-5)
LIBS = [(mx, mx.cpu()), (pt, pt.cpu())]


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    """Unset every variable the port's config declares: other test files
    of the suite set some (MXNET_ZERO, ...) in os.environ without
    restoring them, and the port's Trainer refuses what they turn on."""
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _vars(lib, ctx, arrays, req="write"):
    out = [lib.nd.array(a, ctx=ctx) for a in arrays]
    for v in out:
        v.attach_grad(req)
    return out


def _both(fn):
    """fn(lib, ctx) run with each package; returns (reference, port)."""
    return [fn(lib, ctx) for lib, ctx in LIBS]


# ---------------------------------------------------------------------------
# autograd semantics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add_match_reference(req):
    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)

    def run(lib, ctx):
        x, y = _vars(lib, ctx, [a, b], req)
        for _ in range(2):
            with lib.autograd.record():
                z = (x * y + x * 3.0).sum()
            z.backward()
        return x.grad.asnumpy(), y.grad.asnumpy()

    (rx, ry), (px, py) = _both(run)
    np.testing.assert_allclose(px, rx, **TOL)
    np.testing.assert_allclose(py, ry, **TOL)
    scale = 2.0 if req == "add" else 1.0
    np.testing.assert_allclose(px, scale * (b + 3.0), **TOL)


def test_head_gradients_match_reference():
    """No head gradient means ones of the head's shape; a given one is
    used as it is."""
    rng = np.random.RandomState(1)
    a = rng.randn(2, 5).astype(np.float32)
    hg = rng.randn(2, 5).astype(np.float32)

    def run(lib, ctx):
        x, = _vars(lib, ctx, [a])
        with lib.autograd.record():
            y = x * x
        y.backward()
        g1 = x.grad.asnumpy()
        with lib.autograd.record():
            y = x * x
        lib.autograd.backward([y], [lib.nd.array(hg, ctx=ctx)])
        return g1, x.grad.asnumpy()

    (r1, r2), (p1, p2) = _both(run)
    np.testing.assert_allclose(p1, r1, **TOL)
    np.testing.assert_allclose(p2, r2, **TOL)
    np.testing.assert_allclose(p2, 2 * a * hg, **TOL)


def test_pause_and_no_graph_outside_record():
    a = np.ones((2, 3), np.float32)

    def run(lib, ctx):
        x, = _vars(lib, ctx, [a])
        seen = []
        with lib.autograd.record():
            seen.append((lib.autograd.is_recording(),
                         lib.autograd.is_training()))
            with lib.autograd.pause():
                seen.append((lib.autograd.is_recording(),
                             lib.autograd.is_training()))
                paused = x * 2.0
        outside = x * 2.0
        errors = []
        for y in (paused, outside):
            try:
                y.backward()
                errors.append(None)
            except lib.MXNetError as e:
                errors.append(str(e))
        return seen, errors

    ref, port = _both(run)
    assert port == ref
    assert all(e is not None for e in port[1])


def test_port_builds_no_torch_graph_outside_record():
    x, = _vars(pt, pt.cpu(), [np.ones((2, 3), np.float32)])
    assert x.tensor().requires_grad
    assert not x.detach().tensor().requires_grad
    assert not (x * 2.0).tensor().requires_grad
    with pt.autograd.record():
        assert (x * 2.0).tensor().requires_grad
        with pt.autograd.pause():
            assert not (x * 2.0).tensor().requires_grad


def test_unreached_variable_keeps_its_grad_and_mark_variables():
    def run(lib, ctx):
        x, y = _vars(lib, ctx, [np.ones(3, np.float32),
                                np.ones(3, np.float32)])
        if lib is mx:
            y.grad[:] = 7.0
        else:
            y.grad.tensor().fill_(7.0)
        with lib.autograd.record():
            z = (x * 2.0).sum()
        z.backward()
        w = lib.nd.array(np.arange(3, dtype=np.float32), ctx=ctx)
        gw = lib.nd.zeros((3,), ctx=ctx)
        lib.autograd.mark_variables([w], [gw], "write")
        with lib.autograd.record():
            v = (w * w).sum()
        v.backward()
        return x.grad.asnumpy(), y.grad.asnumpy(), gw.asnumpy()

    ref, port = _both(run)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, **TOL)
    np.testing.assert_allclose(port[1], 7.0)


def test_parameter_grad_zero_grad_and_grad_req():
    def run(lib, ctx):
        d = lib.gluon.nn.Dense(2, in_units=3, prefix="d_")
        d.initialize(ctx=ctx)
        d.bias.grad_req = "null"
        x = lib.nd.array(np.ones((1, 3), np.float32), ctx=ctx)
        with lib.autograd.record():
            y = d(x).sum()
        y.backward()
        g = d.weight.grad().asnumpy()
        d.collect_params().zero_grad()
        try:
            d.bias.grad()
            bias_err = None
        except RuntimeError as e:
            bias_err = str(e)
        return g, d.weight.grad().asnumpy(), bias_err, \
            [p.grad_req for p in d.collect_params().values()]

    ref, port = _both(run)
    np.testing.assert_allclose(port[0], ref[0], **TOL)
    np.testing.assert_array_equal(port[1], 0.0)
    assert port[2] == ref[2] and port[3] == ref[3]


def test_grad_req_add_set_on_initialized_parameters_accumulates():
    """Set after initialize, ``add`` reaches the arrays in the port (the
    reference's setter leaves them on ``write``: ROADMAP.md queue 3)."""
    d = pt.gluon.nn.Dense(2, in_units=3, prefix="a_")
    d.initialize(ctx=pt.cpu())
    d.collect_params().setattr("grad_req", "add")
    x = pt.nd.array(np.ones((1, 3), np.float32), ctx=pt.cpu())
    for _ in range(2):
        with pt.autograd.record():
            y = d(x).sum()
        y.backward()
    np.testing.assert_array_equal(d.weight.grad().asnumpy(), 2.0)
    np.testing.assert_array_equal(d.bias.grad().asnumpy(), 2.0)


def test_embedding_float_ids_get_no_gradient():
    def run(lib, ctx):
        emb = lib.gluon.nn.Embedding(10, 4, prefix="e_")
        emb.initialize(ctx=ctx)
        ids = lib.nd.array(np.array([[1, 3, 3]], np.float32), ctx=ctx)
        ids.attach_grad()
        with lib.autograd.record():
            y = emb(ids).sum()
        y.backward()
        return emb.weight.grad().asnumpy(), ids.grad.asnumpy()

    ref, port = _both(run)
    np.testing.assert_allclose(port[0], ref[0], **TOL)
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[0][3], 2.0)


# ---------------------------------------------------------------------------
# ops the losses need
# ---------------------------------------------------------------------------
def test_loss_ops_match_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 7).astype(np.float32)
    idx = np.array([0, 6, 9, -2], np.float32)    # out of range: clipped

    def run(lib, ctx):
        a = lib.nd.array(x, ctx=ctx)
        i = lib.nd.array(idx, ctx=ctx)
        F = lib.nd
        return [o.asnumpy() for o in (
            F.pick(a, i, axis=-1), F.pick(a, i, axis=1, keepdims=True),
            F.log_softmax(a, axis=-1), F.negative(a), -a, a.sum(), a.mean(),
            F.mean(a, axis=0, exclude=True), F.sum(a, axis=1, keepdims=True),
            F.square(a), F.reshape_like(a, F.zeros((7, 4), ctx=ctx)))]

    ref, port = _both(run)
    for r, p in zip(ref, port):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, **TOL)


@pytest.mark.parametrize("loss", ["SoftmaxCrossEntropyLoss", "L2Loss"])
def test_losses_and_their_gradients_match_reference(loss):
    rng = np.random.RandomState(3)
    pred = rng.randn(6, 5).astype(np.float32)
    label = (rng.randint(0, 5, (6,)) if loss != "L2Loss"
             else rng.randn(6, 5)).astype(np.float32)

    def run(lib, ctx):
        p, = _vars(lib, ctx, [pred])
        fn = getattr(lib.gluon.loss, loss)()
        with lib.autograd.record():
            out = fn(p, lib.nd.array(label, ctx=ctx))
        out.backward()
        return out.asnumpy(), p.grad.asnumpy()

    ref, port = _both(run)
    for r, p in zip(ref, port):
        assert p.shape == r.shape
        np.testing.assert_allclose(p, r, **TOL)


# ---------------------------------------------------------------------------
# optimizer operators, dtype chain included
# ---------------------------------------------------------------------------
def _opt_inputs(dtype, n=3, seed=4):
    import ml_dtypes
    rng = np.random.RandomState(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    arrays = []
    for _ in range(n):
        arrays += [rng.randn(5, 3).astype(npdt),
                   (rng.randn(5, 3) * 10).astype(npdt),
                   (rng.randn(5, 3) * 0.1).astype(npdt),
                   np.abs(rng.randn(5, 3) * 0.01).astype(npdt)]
    return arrays


def _jx(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _tt(a):
    return pt.nd.host_tensor(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_lamb_update_matches_reference(dtype):
    arrays = _opt_inputs(dtype)
    kw = dict(learning_rates=(1e-3, 2e-3, 5e-4), wds=(0.01, 0.0, 0.01),
              beta1=0.9, beta2=0.999, epsilon=1e-6, step_count=(1, 2, 7),
              bias_correction=True, rescale_grad=1 / 32, clip_gradient=-1.0,
              lower_bound=-1.0, upper_bound=-1.0, num_tensors=3)
    import jax.numpy as jnp
    ref = ref_ops.multi_lamb_update(
        *[_jx(a) for a in arrays],
        **dict(kw, learning_rates=jnp.asarray(kw["learning_rates"],
                                              jnp.float32),
               wds=jnp.asarray(kw["wds"], jnp.float32),
               step_count=jnp.asarray(kw["step_count"], jnp.float32),
               rescale_grad=jnp.asarray(np.float32(kw["rescale_grad"]))))
    got = port_ops.multi_lamb_update(*[_tt(a) for a in arrays], **kw)
    for r, g in zip(ref, got):
        assert str(g.dtype).endswith(dtype)
        r = np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), r, **TOL)
        else:   # one bf16 ulp of the result
            np.testing.assert_allclose(g.float().numpy(), r, rtol=2 ** -7,
                                       atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preloaded_multi_sgd_updates_match_reference(dtype):
    """The new weights and momenta of the aggregated SGD path are f32
    for bf16 inputs in both packages (the reference's f32 lrs/wds
    promote); the port's optimizer writes them back in the weight's
    dtype."""
    arrays = _opt_inputs(dtype, n=2)
    lrs, wds = np.float32([0.1, 0.05]), np.float32([1e-4, 0.0])
    body_mom = [a for i, a in enumerate(arrays) if i % 4 != 3]
    body = [a for i, a in enumerate(arrays) if i % 4 < 2]
    for fn, arrs, extra in (
            ("preloaded_multi_sgd_mom_update", body_mom, {"momentum": 0.9}),
            ("preloaded_multi_sgd_update", body, {})):
        kw = dict(extra, rescale_grad=0.25, clip_gradient=-1.0,
                  num_weights=2)
        ref = getattr(ref_ops, fn)(*[_jx(a) for a in arrs], _jx(lrs),
                                   _jx(wds), **kw)
        got = getattr(port_ops, fn)(*[_tt(a) for a in arrs],
                                    torch.from_numpy(lrs),
                                    torch.from_numpy(wds), **kw)
        for r, g in zip(ref, got):
            assert np.asarray(r).dtype == np.float32 and \
                g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ---------------------------------------------------------------------------
# the MLP slice, step for step
# ---------------------------------------------------------------------------
def _mlp(lib):
    net = lib.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(32, activation="relu"),
                lib.gluon.nn.Dense(10))
    return net


def test_mlp_sgd_momentum_matches_reference_step_for_step():
    rng = np.random.RandomState(5)
    data = rng.rand(6, 8, 1, 28, 28).astype(np.float32)     # 6 batches
    labels = rng.randint(0, 10, (6, 8)).astype(np.float32)
    ref = _mlp(mx)
    ref.initialize()
    ref(mx.nd.array(data[0]))
    arrays = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = _mlp(pt)
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    hp = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    nets = {"ref": (mx, mx.cpu(), ref), "port": (pt, pt.cpu(), port)}
    trainers = {k: lib.gluon.Trainer(net.collect_params(), "sgd", dict(hp))
                for k, (lib, _, net) in nets.items()}
    losses = {k: lib.gluon.loss.SoftmaxCrossEntropyLoss()
              for k, (lib, _, _) in nets.items()}
    for step in range(len(data)):
        got = {}
        for k, (lib, ctx, net) in nets.items():
            x = lib.nd.array(data[step], ctx=ctx)
            y = lib.nd.array(labels[step], ctx=ctx)
            with lib.autograd.record():
                loss = losses[k](net(x), y)
            loss.backward()
            trainers[k].step(8)
            got[k] = (loss.asnumpy(),
                      {n: p.data().asnumpy()
                       for n, p in net.collect_params().items()})
        np.testing.assert_allclose(got["port"][0], got["ref"][0], **TOL)
        for n, w in got["ref"][1].items():
            np.testing.assert_allclose(got["port"][1][n], w, **TOL)


# ---------------------------------------------------------------------------
# what the Trainer leaves out raises
# ---------------------------------------------------------------------------
def _dense():
    d = pt.gluon.nn.Dense(2, in_units=3, prefix="t_")
    d.initialize(ctx=pt.cpu())
    return d


@pytest.mark.parametrize("kwargs,match", [
    ({"compression_params": {"type": "2bit"}}, "item 11")])
def test_trainer_refuses_what_is_not_ported(kwargs, match, monkeypatch):
    """Gradient compression (item 11) is ported: the Trainer takes
    ``compression_params`` and hands them to its kvstore at the first
    step, which routes them to the int8 quantized wire; with one context
    there is no store, as in the reference."""
    tr = pt.gluon.Trainer(_dense().collect_params(), "sgd", **kwargs)
    assert tr._compression_params == kwargs["compression_params"]
    net = pt.gluon.nn.Dense(2, in_units=3, prefix="c_")
    net.initialize(ctx=[pt.cpu(0), pt.cpu(1)])
    tr = pt.gluon.Trainer(net.collect_params(), "sgd", **kwargs)
    monkeypatch.setattr(pt.kvstore, "_COMPRESSION_WARNED", False)
    with pytest.warns(FutureWarning, match="int8"):
        pt.kvstore.KVStore().set_gradient_compression(
            kwargs["compression_params"])
    tr._init_kvstore()
    assert tr._kvstore._compression[0] == "2bit"
    assert tr._kvstore._quant_cfg().mode == "int8"


def test_trainer_dist_sync_joins_the_group_at_its_first_step(monkeypatch):
    """``kvstore="dist_sync"`` is accepted and its store made at the first
    step, which joins the process group through the DMLC_* rendezvous:
    without that environment it says what is missing."""
    for var in ("DMLC_PS_ROOT_URI", "MXNET_COORDINATOR_URI"):
        monkeypatch.delenv(var, raising=False)
    d = _dense()
    trainer = pt.gluon.Trainer(d.collect_params(), "sgd",
                               kvstore="dist_sync")
    assert trainer._kvstore is None and not pt.dist.is_initialized()
    with pt.autograd.record():
        loss = d(pt.nd.ones((1, 3), ctx=pt.cpu())).sum()
    loss.backward()
    with pytest.raises(RuntimeError, match="DMLC_PS_ROOT_URI"):
        trainer.step(1)
    assert not pt.dist.is_initialized()


def test_trainer_update_on_kvstore_one_context_updates_locally():
    """``update_on_kvstore=True`` is accepted; with one context there is
    no store, so the Trainer updates in place, as the reference does."""
    a, b = _dense(), _dense()
    b.weight.set_data(a.weight.data())
    b.bias.set_data(a.bias.data())
    trainers = [pt.gluon.Trainer(a.collect_params(), "sgd",
                                 update_on_kvstore=True),
                pt.gluon.Trainer(b.collect_params(), "sgd")]
    for net, tr in zip((a, b), trainers):
        with pt.autograd.record():
            loss = net(pt.nd.ones((2, 3), ctx=pt.cpu())).sum()
        loss.backward()
        tr.step(2)
    assert trainers[0]._kvstore is None
    assert trainers[0]._update_on_kvstore is False
    np.testing.assert_array_equal(a.weight.data().asnumpy(),
                                  b.weight.data().asnumpy())


# K-step scan (item 7), the grad guard and modelwatch (item 13) are
# ported: with them turned on the step runs, and the same ids now check
# that it does
@pytest.mark.parametrize("var,value,match", [
    ("MXNET_ZERO", "1", None), ("MXNET_SCAN_STEPS", "4", None),
    ("MXNET_GUARD_NONFINITE", "skip_step", None),
    ("MXNET_MODELWATCH", "1", None)], ids=[
    "MXNET_ZERO-1-item 11", "MXNET_SCAN_STEPS-4-item 7",
    "MXNET_GUARD_NONFINITE-skip_step-item 13",
    "MXNET_MODELWATCH-1-item 13"])
def test_trainer_step_refuses_features_turned_on(monkeypatch, var, value,
                                                 match):
    d = _dense()
    tr = pt.gluon.Trainer(d.collect_params(), "sgd")
    monkeypatch.setenv(var, value)
    if match is None:
        if var == "MXNET_MODELWATCH":       # modelwatch rides telemetry
            monkeypatch.setenv("MXNET_TELEMETRY", "1")
            pt.telemetry.refresh()
        try:
            with pt.autograd.record():
                out = d(pt.nd.ones((1, 3), ctx=pt.cpu()))
            out.backward()
            tr.step(1)
        finally:
            monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
            pt.telemetry.refresh()
            pt.telemetry.reset()
            pt.modelwatch.reset()
        if var == "MXNET_GUARD_NONFINITE":
            assert tr.grad_guard.nonfinite == value
            assert tr.grad_guard.steps == 1
        if var == "MXNET_MODELWATCH":
            assert tr.modelwatch.samples == 1
            assert tr.modelwatch.sync_count == 1
        if var == "MXNET_ZERO":
            # item 11 is ported: one context is not eligible, so the
            # Trainer warns and stays replicated
            assert tr._zero is False and tr._zero_bailed
        return
    with pytest.raises(NotImplementedError, match=match):
        tr.step(1)


def test_optimizer_refusals_and_registry():
    # every optimizer of the reference is ported: an unknown name raises
    # as the reference's registry does, and rmsprop is an optimizer
    with pytest.raises(pt.MXNetError, match=r"Cannot find 'dcasgd'"):
        pt.optimizer.create("dcasgd")
    assert isinstance(pt.optimizer.create("rmsprop"), pt.optimizer.RMSProp)
    assert isinstance(pt.optimizer.create("lamb"), pt.optimizer.LAMB)
    for name in ("sgd", "adam", "adamw"):
        opt = pt.optimizer.create(name, multi_precision=True)
        assert opt.multi_precision
