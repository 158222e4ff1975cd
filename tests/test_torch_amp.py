"""The port's ``contrib.amp`` against the reference's
(mxnet_tpu/contrib/amp): the cases of tests/test_amp.py that need no
``symbol``, on the same numpy inputs in both packages.

Both packages cast the same namespace calls, so an AMP run of the port
is held to the reference's AMP run, eager. Where low-precision sums can
round differently in the two (bf16 products, reductions), the yardstick
is the reference's own distance from its run without AMP: the port's
AMP run may differ from the reference's AMP run by at most ``FACTOR``
times that, per output, loss and weight: twice the largest reading on
the CPU, 1.02 (the MLP's weights; BERT-tiny's output 1.00, resnet18's
arrays at most 0.62, tests/test_torch_resnet_amp.py). A port whose AMP
cast nothing would sit at exactly 1x that distance and pass, so the
port's AMP run must also differ from the reference's f32 run by at least
``1 / FACTOR`` of it (on the CPU it read 1.36 of it for the MLP, 1.18 for
BERT-tiny's output, 0.87 for resnet18's gradients and weights).
"""
import ml_dtypes
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as ref_amp

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.contrib import amp

FACTOR = 2.0


@pytest.fixture(autouse=True)
def _amp_reset(monkeypatch):
    for var in list(pt.config.VARS) + ["MXNET_OPTIMIZER_AGGREGATION_SIZE"]:
        monkeypatch.delenv(var, raising=False)
    yield
    amp.reset()
    ref_amp.reset()


def _amp(lib):
    return ref_amp if lib is mx else amp


def _ctx(lib):
    return lib.cpu()


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_eager_cast_lists_match_reference():
    for lib in (mx, pt):
        _amp(lib).init(target_dtype="bfloat16")
        ctx = _ctx(lib)
        x, w = lib.nd.ones((4, 8), ctx=ctx), lib.nd.ones((3, 8), ctx=ctx)
        y = lib.nd.FullyConnected(x, w, no_bias=True, num_hidden=3)
        z = lib.nd.softmax(y)
        assert "bfloat16" in str(y.dtype)   # a low-precision op
        assert "float32" in str(z.dtype)    # an f32 op casts back
        np.testing.assert_array_equal(z.asnumpy(), np.full((4, 3), 1 / 3,
                                                           np.float32))


def test_widest_casts_and_operators_are_not_cast():
    """``nd.broadcast_add`` casts to the widest input (the first of
    equal width: bf16 for bf16 + f16); ``a + b`` reaches the op
    directly, uncast, and promotes (to f32), in both packages."""
    out = {}
    for lib in (mx, pt):
        _amp(lib).init(target_dtype="bfloat16")
        ctx = _ctx(lib)
        a = lib.nd.array(np.full((2, 3), 1.5, np.float32), ctx=ctx,
                         dtype="bfloat16")
        b = lib.nd.array(np.full((2, 3), 0.25, np.float32), ctx=ctx,
                         dtype="float16")
        f = lib.nd.array(np.full((2, 3), 0.5, np.float32), ctx=ctx)
        out[lib] = [str(v.dtype).split(".")[-1] for v in (
            lib.nd.broadcast_add(a, b), a + b, lib.nd.broadcast_mul(a, f),
            lib.nd.broadcast_mul(b, f))]
    assert out[pt] == out[mx] == ["bfloat16", "float32", "float32",
                                  "float32"]
    amp.init()
    a = pt.nd.ones((2, 3), ctx=pt.cpu(), dtype="bfloat16")
    with pt.ops.recording() as seen:
        a + a.astype("float16")
    assert {o.name for o in seen} == {"Cast", "broadcast_add"}
    with pt.ops.recording() as seen:
        pt.nd.broadcast_add(a, pt.nd.ones((2, 3), ctx=pt.cpu()))
    assert "Cast" in {o.name for o in seen}


def test_amp_cast_ops_match_reference():
    ints = np.arange(6, dtype=np.int32).reshape(2, 3)
    fl = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    for lib in (mx, pt):
        ctx = _ctx(lib)
        i, x = lib.nd.array(ints, ctx=ctx, dtype="int32"), \
            lib.nd.array(fl, ctx=ctx)
        h = x.astype("float16")
        c = lib.nd.amp_cast(i, dtype="bfloat16")
        assert "int32" in str(c.dtype)
        assert "bfloat16" in str(lib.nd.amp_cast(x, dtype="bfloat16").dtype)
        outs = lib.nd.amp_multicast(h, x, i, num_outputs=3)
        assert [str(o.dtype).split(".")[-1] for o in outs] == \
            ["float32", "float32", "int32"]
        np.testing.assert_array_equal(outs[0].asnumpy(),
                                      fl.astype(np.float16).astype(np.float32))


def test_loss_scaler_dynamic_matches_reference():
    seen = {}
    for lib in (mx, pt):
        ctx = _ctx(lib)
        s = _amp(lib).LossScaler(init_scale=256.0, dynamic=True,
                                 scale_window=4)
        bad = [lib.nd.array(np.array([np.inf, 1, 2], np.float32), ctx=ctx)]
        trace = [s.unscale_and_check(bad), s.loss_scale]
        for _ in range(4):
            gs = [lib.nd.ones((3,), ctx=ctx) * s.loss_scale]
            trace.append(s.unscale_and_check(gs))
            np.testing.assert_allclose(gs[0].asnumpy(), np.ones(3))
        trace.append(s.loss_scale)
        seen[lib] = (trace, bad[0].asnumpy())
    assert seen[pt][0] == seen[mx][0] == [False, 128.0] + [True] * 4 + [256.0]
    # the overflowed gradients are zeroed
    np.testing.assert_array_equal(seen[pt][1], seen[mx][1])
    assert not seen[pt][1].any()
    s = amp.LossScaler(init_scale=8.0)
    g = [pt.nd.ones((2,), ctx=pt.cpu())]
    s.unscale(g)
    assert s.loss_scale == 8.0 and s._unskipped == 0
    np.testing.assert_array_equal(g[0].asnumpy(), [0.125, 0.125])


def _dense(lib, dtype=None):
    net = lib.gluon.nn.Dense(2, in_units=4, prefix="d_")
    net.initialize(ctx=_ctx(lib))
    net.weight.set_data(lib.nd.array(np.arange(8, dtype=np.float32)
                                     .reshape(2, 4) / 8, ctx=_ctx(lib)))
    if dtype:
        net.cast(dtype)
    return net


def test_scale_loss_float16_matches_reference():
    got = {}
    for lib in (mx, pt):
        _amp(lib).init(target_dtype="float16")
        net = _dense(lib)
        trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.01}, kvstore=None)
        _amp(lib).init_trainer(trainer)
        x = lib.nd.ones((2, 4), ctx=_ctx(lib))
        with lib.autograd.record():
            loss = net(x).sum()
            with _amp(lib).scale_loss(loss, trainer) as scaled:
                pass
        scale = trainer._amp_loss_scaler.loss_scale
        assert scale == 2.0 ** 16
        assert trainer._scale == 1.0 / scale
        got[lib] = (scaled.asnumpy(), loss.asnumpy())
    np.testing.assert_allclose(got[pt][0], got[pt][1] * 2.0 ** 16,
                               rtol=1e-3)
    np.testing.assert_array_equal(got[pt][0], got[mx][0])


def test_unscale_checks_zeroes_on_overflow_and_restores_the_scale():
    """float16 loss scaling end to end in the port: scale_loss, backward,
    unscale (gradients divided once, the Trainer's scale restored, so
    the step divides by the batch size only), and a planted inf that
    halves the scale and zeroes the gradients."""
    amp.init(target_dtype="float16")
    net = _dense(pt, "float16")
    trainer = pt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5}, kvstore=None)
    amp.init_trainer(trainer)
    x = pt.nd.ones((2, 4), ctx=pt.cpu(), dtype="float16")
    w0 = net.weight.data().asnumpy()
    for planted in (False, True):
        with pt.autograd.record():
            # an f32 loss, as log_softmax gives under AMP: 2^16 is inf
            # in float16
            loss = net(x).astype("float32").mean()
            with amp.scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        if planted:
            net.bias.grad().tensor()[0] = float("inf")
        amp.unscale(trainer)
        assert trainer._scale == 1.0
        grads = [p.grad().asnumpy() for p in (net.weight, net.bias)]
        if planted:
            assert trainer._amp_loss_scaler.loss_scale == 2.0 ** 15
            assert not any(g.any() for g in grads)
        else:
            np.testing.assert_array_equal(grads[0], np.full((2, 4), 0.5))
            trainer.step(2)
            np.testing.assert_allclose(net.weight.data().asnumpy(),
                                       w0 - 0.125, rtol=1e-3)


def _scaled_steps(lib, opt, unscale_clean, steps=4, planted=1):
    """float16 Dense with f32 masters trained ``steps`` steps under
    amp.init("float16") with scale_loss; a gradient made inf after the
    backward of step ``planted``, then unscale and step. On clean steps
    the port calls unscale before the step, the reference goes straight
    to the step (``unscale_clean``)."""
    _amp(lib).init(target_dtype="float16")
    ctx = _ctx(lib)
    net = _dense(lib, "float16")
    hp = dict(OPTS_AMP[opt], multi_precision=True)
    trainer = lib.gluon.Trainer(net.collect_params(), opt, hp,
                                kvstore=None)
    _amp(lib).init_trainer(trainer)
    rng = np.random.RandomState(11)
    trace = []
    for k in range(steps):
        x = lib.nd.array(rng.rand(4, 4).astype(np.float32), ctx=ctx,
                         dtype="float16")
        with lib.autograd.record():
            loss = net(x).astype("float32").mean()
            with _amp(lib).scale_loss(loss, trainer) as scaled:
                pass
        scaled.backward()
        if k == planted:
            g = net.bias.grad()
            (g if lib is mx else g.tensor())[0] = float("inf")
        if k == planted or unscale_clean:
            _amp(lib).unscale(trainer)
        trainer.step(4)
        updater = trainer._updaters[0] if lib is mx else trainer._updater
        trace.append((trainer._amp_loss_scaler.loss_scale,
                      [p.data().asnumpy().astype(np.float32)
                       for p in (net.weight, net.bias)],
                      [updater.states[i][1].asnumpy() for i in range(2)]))
    _amp(lib).reset()
    return trace


OPTS_AMP = {"sgd": {"learning_rate": 0.5, "momentum": 0.9, "wd": 0.01},
            "lamb": {"learning_rate": 0.05, "wd": 0.01}}


@pytest.mark.parametrize("opt", sorted(OPTS_AMP))
def test_scale_loss_unscale_step_matches_the_reference_scale_loss_step(opt):
    """The port's unscale restores the Trainer's gradient scale, which
    the reference's leaves at 1 / loss scale: so the port's scale_loss,
    unscale, step must equal the reference's scale_loss, step, where the
    step divides by the loss scale once. On the step with a planted inf
    both call unscale (the gradients zeroed, the scale halved) and then
    step. Per step: the loss scale equal, each f32 master within 1e-6
    (relative, 1e-7 absolute) and each float16 weight within one float16
    ulp of the reference's (power-of-two scales divide exactly)."""
    ref = _scaled_steps(mx, opt, unscale_clean=False)
    port = _scaled_steps(pt, opt, unscale_clean=True)
    assert [t[0] for t in port] == [t[0] for t in ref] == \
        [2.0 ** 16, 2.0 ** 15, 2.0 ** 15, 2.0 ** 15]
    for (_, rw, rm), (_, pw, pm) in zip(ref, port):
        for r, p in zip(rm, pm):
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7)
        for r, p in zip(rw, pw):
            np.testing.assert_allclose(p, r, rtol=2 ** -10, atol=2 ** -24)
    # the zeroed step still moves the masters (momentum, weight decay)
    assert any(np.abs(a - b).max() > 0 for a, b in
               zip(port[1][2], port[0][2]))


def test_amp_api_edges():
    with pytest.raises(pt.MXNetError, match="amp.init"):
        amp.init_trainer(pt.gluon.Trainer(_dense(pt).collect_params(),
                                          "sgd"))
    assert not amp.is_initialized()
    amp.init("float16")
    amp.init("bfloat16")            # a second call changes nothing
    assert amp.is_initialized() and amp.target_dtype() == "float16"
    with pytest.raises(NotImplementedError, match=r"queue 1, item 16\)"):
        amp.convert_symbol(None)
    net = amp.convert_model(_dense(pt), "bfloat16")
    assert net.weight.data().dtype == ml_dtypes.bfloat16
    amp.reset()
    with pytest.raises(AssertionError):
        amp.init("int8")
    # the bf16 scaler is static at 1
    amp.init()
    trainer = amp.init_trainer(pt.gluon.Trainer(
        _dense(pt).collect_params(), "sgd"))
    assert trainer._amp_loss_scaler.loss_scale == 1.0
    assert not trainer._amp_loss_scaler._dynamic


def test_f32_parameters_get_f32_gradients_through_the_casts():
    amp.init()
    net = _dense(pt)
    x = pt.nd.ones((2, 4), ctx=pt.cpu())
    with pt.autograd.record():
        out = net(x)
        loss = out.sum()
    loss.backward()
    assert out.dtype == ml_dtypes.bfloat16
    for p in (net.weight, net.bias):
        assert p.data().dtype == p.grad().dtype == np.float32
    np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                  np.full((2, 4), 2.0))


# ---------------------------------------------------------------------------
# models under AMP against the reference under AMP
# ---------------------------------------------------------------------------
def _mlp_losses(lib, use_amp, steps=3, hybridize=False):
    rng = np.random.RandomState(0)
    X = rng.rand(16, 10).astype(np.float32)
    Y = rng.randint(0, 3, (16,)).astype(np.float32)
    rng2 = np.random.RandomState(7)
    if use_amp:
        _amp(lib).init(target_dtype="bfloat16")
    ctx = _ctx(lib)
    net = lib.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(16, activation="relu", in_units=10))
        net.add(lib.gluon.nn.Dense(3, in_units=16))
    net.initialize(ctx=ctx)
    for p in sorted(net.collect_params()):
        arr = rng2.rand(*net.collect_params()[p].shape).astype(np.float32)
        net.collect_params()[p].set_data(lib.nd.array(arr * 0.1, ctx=ctx))
    if hybridize:
        net.hybridize()
    trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=None)
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with lib.autograd.record():
            loss = loss_fn(net(lib.nd.array(X, ctx=ctx)),
                           lib.nd.array(Y, ctx=ctx))
        loss.backward()
        trainer.step(16)
        losses.append(float(loss.mean().asnumpy()[0]))
    weights = [net.collect_params()[p].data().asnumpy()
               for p in sorted(net.collect_params())]
    if use_amp:
        _amp(lib).reset()
    return losses, weights


def test_mlp_sgd_under_amp_matches_reference():
    """tests/test_amp.py's three SGD steps of the MLP: the port under
    AMP against the reference under AMP (eager), losses and weights, by
    the reference's own AMP-vs-f32 distance; and, as the reference's
    test holds its hybridized AMP run, within 2e-2 of f32."""
    ref_f32 = _mlp_losses(mx, False)
    ref_amp_run = _mlp_losses(mx, True)
    port_amp = _mlp_losses(pt, True)
    port_hyb = _mlp_losses(pt, True, hybridize=True)
    own = max(_dist(ref_amp_run[0], ref_f32[0]),
              max(_dist(a, b) for a, b in zip(ref_amp_run[1], ref_f32[1])))
    assert own > 0
    assert _dist(port_amp[0], ref_amp_run[0]) <= FACTOR * own
    # not the f32 run: the casts took effect
    assert max(_dist(port_amp[0], ref_f32[0]),
               max(_dist(a, b) for a, b in zip(port_amp[1], ref_f32[1]))) \
        >= own / FACTOR
    for a, b in zip(port_amp[1], ref_amp_run[1]):
        assert _dist(a, b) <= FACTOR * own
    assert port_hyb[0] == port_amp[0]
    for a, b in zip(port_hyb[1], port_amp[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port_amp[0], ref_f32[0], rtol=2e-2, atol=2e-2)


def _bert_tiny(lib, use_amp):
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as PortBERT
    if use_amp:
        _amp(lib).init(target_dtype="bfloat16")
    ctx = _ctx(lib)
    ids = lib.nd.array(np.arange(2 * 12).reshape(2, 12) % 50, ctx=ctx)
    tok = lib.nd.array(np.zeros((2, 12), np.float32), ctx=ctx)
    net = (RefBERT if lib is mx else PortBERT)(
        num_layers=2, units=32, hidden_size=64, num_heads=4, max_length=16,
        vocab_size=50, dropout=0.0, use_pooler=False, use_decoder=False,
        use_classifier=False, prefix="bert_")
    rng = np.random.RandomState(2)
    if lib is mx:
        net.initialize()
        net(ids, tok)
        for name in sorted(net.collect_params()):
            p = net.collect_params()[name]
            p.set_data(mx.nd.array(
                (rng.rand(*p.shape).astype(np.float32) - 0.5) * 0.1))
    else:
        ref = _bert_tiny.shapes
        pt.params_from_numpy(net, {
            n: ((rng.rand(*ref[n]).astype(np.float32) - 0.5) * 0.1)
            for n in sorted(ref)}, ctx=ctx)
    out = net(ids, tok)
    out = (out[0] if isinstance(out, (list, tuple)) else out).asnumpy()
    if use_amp:
        _amp(lib).reset()
    return out.astype(np.float32)


def test_bert_tiny_forward_under_amp_matches_reference(pallas_interpret):
    """tests/test_amp.py's BERT-tiny forward: bf16 FullyConnected and
    epilogues, f32 parameters, bf16-x/f32-gamma LayerNorms."""
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT
    probe = RefBERT(num_layers=2, units=32, hidden_size=64, num_heads=4,
                    max_length=16, vocab_size=50, dropout=0.0,
                    use_pooler=False, use_decoder=False,
                    use_classifier=False, prefix="bert_")
    probe.initialize()
    probe(mx.nd.array(np.zeros((2, 12))), mx.nd.array(np.zeros((2, 12))))
    _bert_tiny.shapes = {n: p.shape
                         for n, p in probe.collect_params().items()}
    ref_f32 = _bert_tiny(mx, False)
    ref_amp_out = _bert_tiny(mx, True)
    port_amp = _bert_tiny(pt, True)
    own = _dist(ref_amp_out, ref_f32)
    assert own > 0
    assert _dist(port_amp, ref_amp_out) <= FACTOR * own
    assert _dist(port_amp, ref_f32) >= own / FACTOR
    np.testing.assert_allclose(port_amp, ref_f32, rtol=5e-2, atol=5e-2)
