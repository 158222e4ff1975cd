"""The port's ``RNN`` op, ``gluon.rnn`` layers and cells against the
reference on the CPU.

The reference's ``tests/test_rnn.py`` contracts run on the port (shapes,
layouts, the fused layer against the unrolled cell, the backward,
``hybridize``, a PTB-style truncated-BPTT step). Then parity: the same
packed weights through the reference's ``nd.RNN`` and the port's, and
the same named weights through each package's layer and cells (moved by
``params_from_numpy``), in every mode: outputs, final states and every
gradient within rtol 1e-4, atol 1e-5 (f32)."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size

RTOL, ATOL = 1e-4, 1e-5
CPU = pt.cpu()


@pytest.fixture(autouse=True, scope="module")
def _port_config_unset():
    """Unset every variable the port's config declares: other test files
    of the suite set some (MXNET_ZERO, ...) in os.environ without
    restoring them, and the port's Trainer refuses what they turn on."""
    with pytest.MonkeyPatch.context() as mp:
        for var in pt.config.VARS:
            mp.delenv(var, raising=False)
        yield


def _randn(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# -- the reference's tests/test_rnn.py, on the port ----------------------------
def test_lstm_shapes():
    layer = rnn.LSTM(hidden_size=16, num_layers=2)
    layer.initialize(ctx=CPU)
    x = pt.nd.array(_randn((5, 3, 8)), ctx=CPU)
    assert layer(x).shape == (5, 3, 16)
    states = layer.begin_state(batch_size=3, ctx=CPU)
    out, new_states = layer(x, states)
    assert out.shape == (5, 3, 16)
    assert new_states[0].shape == new_states[1].shape == (2, 3, 16)


def test_gru_rnn_shapes():
    for layer in (rnn.GRU(hidden_size=8),
                  rnn.RNN(hidden_size=8, activation="tanh")):
        layer.initialize(ctx=CPU)
        x = pt.nd.array(_randn((4, 2, 6)), ctx=CPU)
        assert layer(x).shape == (4, 2, 8)


def test_bidirectional_lstm():
    layer = rnn.LSTM(hidden_size=8, bidirectional=True)
    layer.initialize(ctx=CPU)
    assert layer(pt.nd.array(_randn((4, 2, 6)), ctx=CPU)).shape == (4, 2, 16)


def test_ntc_layout():
    layer = rnn.LSTM(hidden_size=8, layout="NTC")
    layer.initialize(ctx=CPU)
    assert layer(pt.nd.array(_randn((2, 4, 6)), ctx=CPU)).shape == (2, 4, 8)


def test_fused_matches_cell():
    """The fused layer equals the unrolled LSTMCell on the same weights."""
    H, I, T, N = 4, 3, 5, 2
    layer = rnn.LSTM(hidden_size=H, input_size=I)
    layer.initialize(ctx=CPU)
    cell = rnn.LSTMCell(hidden_size=H, input_size=I)
    cell.initialize(ctx=CPU)
    for n in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, n).set_data(getattr(layer, "l0_" + n).data())
    x = pt.nd.array(_randn((T, N, I)), ctx=CPU)
    fused = layer(x).asnumpy()
    outs, _ = cell.unroll(T, [x[t].reshape((N, I)) for t in range(T)],
                          layout="TNC")
    _close(np.stack([o.asnumpy() for o in outs], axis=0), fused)


def test_lstm_backward():
    layer = rnn.LSTM(hidden_size=8)
    layer.initialize(ctx=CPU)
    x = pt.nd.array(_randn((4, 2, 6)), ctx=CPU)
    x.attach_grad()
    with pt.autograd.record():
        out = layer(x).sum()
    out.backward()
    assert x.grad.shape == (4, 2, 6)
    assert float(np.abs(x.grad.asnumpy()).max()) > 0
    for p in layer.collect_params().values():
        assert np.isfinite(p.grad().asnumpy()).all()


def test_lstm_hybridize():
    layer = rnn.LSTM(hidden_size=8, num_layers=1)
    layer.initialize(ctx=CPU)
    x = pt.nd.array(_randn((4, 2, 6)), ctx=CPU)
    eager = layer(x).asnumpy()
    layer.hybridize()
    _close(layer(x).asnumpy(), eager)


def test_ptb_style_training_step():
    """Eight truncated-BPTT steps of a PTB-style LM lower the loss."""
    vocab, embed, hidden, T, N = 50, 16, 32, 10, 4
    rs = np.random.RandomState(0)
    gluon = pt.gluon

    class PTBModel(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = gluon.nn.Embedding(vocab, embed)
                self.lstm = rnn.LSTM(hidden_size=hidden, num_layers=2)
                self.decoder = gluon.nn.Dense(vocab, flatten=False)

        def forward(self, x, states):
            out, new_states = self.lstm(self.embedding(x), states)
            return self.decoder(out), new_states

    net = PTBModel()
    net.initialize(init=pt.initializer.Xavier(), ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.5})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    data = pt.nd.array(rs.randint(0, vocab, (T, N)).astype(np.float32),
                       ctx=CPU)
    target = pt.nd.array(rs.randint(0, vocab, (T, N)).astype(np.float32),
                         ctx=CPU)
    states = net.lstm.begin_state(batch_size=N, ctx=CPU)
    losses = []
    for _ in range(8):
        states = [s.detach() for s in states]
        with pt.autograd.record():
            out, states = net(data, states)
            loss = loss_fn(out.reshape((-1, vocab)), target.reshape((-1,)))
        loss.backward()
        trainer.step(N * T)
        losses.append(float(loss.mean().asscalar()))
    assert losses[-1] < losses[0], losses


# -- parity with the reference ------------------------------------------------
# (mode, bidirectional, layers, layout)
CONFIGS = {"lstm": ("lstm", False, 1, "TNC"), "gru": ("gru", False, 1, "TNC"),
           "rnn_tanh": ("rnn_tanh", False, 1, "TNC"),
           "rnn_relu": ("rnn_relu", False, 1, "TNC"),
           "bidirectional": ("lstm", True, 1, "TNC"),
           "two_layers": ("lstm", False, 2, "TNC"),
           "ntc": ("gru", True, 2, "NTC")}
T, N, I, H = 5, 3, 4, 6


def _op_run(lib, ctx, mode, bi, L, x, w, h0, c0, g):
    args = [lib.nd.array(v, ctx=ctx) for v in (x, w, h0, c0)]
    if mode != "lstm":
        args = args[:3]
    for a in args:
        a.attach_grad()
    with lib.autograd.record():
        out = lib.nd.RNN(*args, state_size=H, num_layers=L, mode=mode,
                         bidirectional=bi)
        loss = (out[0] * lib.nd.array(g, ctx=ctx)).sum()
        for s in out[1:]:
            loss = loss + (s * s).sum()
    loss.backward()
    return [o.asnumpy() for o in out] + [a.grad.asnumpy() for a in args]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rnn_op_matches_reference(name):
    """The same packed vector through both packages' ``RNN`` op."""
    mode, bi, L, _ = CONFIGS[name]
    D = 2 if bi else 1
    P = rnn_param_size(mode, I, H, L, bi)
    x, w = _randn((T, N, I), 1), _randn((P,), 2, 0.3)
    h0, c0 = _randn((L * D, N, H), 3), _randn((L * D, N, H), 4)
    g = _randn((T, N, D * H), 5)
    ref = _op_run(mx, mx.cpu(), mode, bi, L, x, w, h0, c0, g)
    got = _op_run(pt, CPU, mode, bi, L, x, w, h0, c0, g)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _close(a, b)


_LAYERS = {"lstm": "LSTM", "gru": "GRU", "rnn_tanh": "RNN", "rnn_relu": "RNN"}


def _layer(lib, mode, bi, L, layout):
    kw = dict(num_layers=L, bidirectional=bi, layout=layout, input_size=I,
              prefix="rnn_")
    if mode.startswith("rnn_"):
        kw["activation"] = mode[4:]
    return getattr(lib.gluon.rnn, _LAYERS[mode])(H, **kw)


def _layer_run(lib, ctx, layer, x, states, g, hybridize=False):
    if hybridize:
        layer.hybridize()
    xa = lib.nd.array(x, ctx=ctx)
    xa.attach_grad()
    sa = [lib.nd.array(s, ctx=ctx) for s in states]
    for s in sa:
        s.attach_grad()
    with lib.autograd.record():
        out, new = layer(xa, sa)
        loss = (out * lib.nd.array(g, ctx=ctx)).sum()
        for s in new:
            loss = loss + (s * s).sum()
    loss.backward()
    vals = {"out": out.asnumpy(), "dx": xa.grad.asnumpy()}
    for i, (s, a) in enumerate(zip(new, sa)):
        vals["state%d" % i] = s.asnumpy()
        vals["dstate%d" % i] = a.grad.asnumpy()
    for n, p in layer.collect_params().items():
        vals["d" + n] = p.grad().asnumpy()
    return vals


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rnn_layer_matches_reference(name, hybridize):
    """Each package's layer on the same named weights, the port's eager
    and hybridized (the reference's own hybridized layer cannot return
    its states: its symbol tracer refuses a list among the outputs)."""
    mode, bi, L, layout = CONFIGS[name]
    D = 2 if bi else 1
    ref = _layer(mx, mode, bi, L, layout)
    ref.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    arrays = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = _layer(pt, mode, bi, L, layout)
    pt.params_from_numpy(port, arrays, ctx=CPU)
    x = _randn((N, T, I) if layout == "NTC" else (T, N, I), 6)
    states = [_randn((L * D, N, H), 7 + i)
              for i in range(2 if mode == "lstm" else 1)]
    g = _randn((N, T, D * H) if layout == "NTC" else (T, N, D * H), 9)
    want = _layer_run(mx, mx.cpu(), ref, x, states, g)
    got = _layer_run(pt, CPU, port, x, states, g, hybridize)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


CELLS = ("rnn", "lstm", "gru", "residual", "sequential", "bidirectional")


def _cell(lib, kind):
    r = lib.gluon.rnn
    if kind == "rnn":
        return r.RNNCell(H, input_size=H, prefix="c_")
    if kind == "lstm":
        return r.LSTMCell(H, input_size=H, prefix="c_")
    if kind == "gru":
        return r.GRUCell(H, input_size=H, prefix="c_")
    if kind == "residual":
        return r.ResidualCell(r.LSTMCell(H, input_size=H, prefix="c_l_"),
                              prefix="c_")
    if kind == "sequential":
        seq = r.SequentialRNNCell(prefix="c_")
        with seq.name_scope():
            seq.add(r.LSTMCell(H, input_size=H, prefix="a_"))
            seq.add(r.DropoutCell(0.0, prefix="d_"))
            seq.add(r.GRUCell(H, input_size=H, prefix="b_"))
        return seq
    return r.BidirectionalCell(r.LSTMCell(H, input_size=H, prefix="c_l_"),
                               r.GRUCell(H, input_size=H, prefix="c_r_"),
                               prefix="c_")


@pytest.mark.parametrize("kind", CELLS)
def test_rnn_cell_unroll_matches_reference(kind):
    """``unroll`` (NTC, merged) of each cell on the same named weights:
    outputs, final states and every gradient."""
    x = _randn((N, T, H), 10)
    g = _randn((N, T, 2 * H if kind == "bidirectional" else H), 11)
    res = []
    for lib, ctx in ((mx, mx.cpu()), (pt, CPU)):
        cell = _cell(lib, kind)
        if lib is mx:
            cell.initialize(mx.initializer.Xavier(), ctx=ctx)
            arrays = {n: p.data().asnumpy()
                      for n, p in cell.collect_params().items()}
        else:
            pt.params_from_numpy(cell, arrays, ctx=ctx)
        xa = lib.nd.array(x, ctx=ctx)
        xa.attach_grad()
        with lib.autograd.record():
            outs, states = cell.unroll(T, xa, layout="NTC",
                                       merge_outputs=True)
            loss = (outs * lib.nd.array(g, ctx=ctx)).sum()
            for s in states:
                loss = loss + (s * s).sum()
        loss.backward()
        res.append([outs.asnumpy(), xa.grad.asnumpy()]
                   + [s.asnumpy() for s in states]
                   + [p.grad().asnumpy()
                      for _, p in sorted(cell.collect_params().items())])
    assert len(res[1]) == len(res[0])
    for a, b in zip(res[1], res[0]):
        _close(a, b)


def test_rnn_param_size_and_names_match_reference():
    from mxnet_tpu.ops.rnn_ops import rnn_param_size as ref_size
    for mode, bi, L, _ in CONFIGS.values():
        assert rnn_param_size(mode, I, H, L, bi) == ref_size(mode, I, H, L, bi)
        a = _layer(mx, mode, bi, L, "TNC")
        b = _layer(pt, mode, bi, L, "TNC")
        assert list(a.collect_params().keys()) == \
            list(b.collect_params().keys())
        assert [p.shape for p in a.collect_params().values()] == \
            [p.shape for p in b.collect_params().values()]
