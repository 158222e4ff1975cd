"""The port's Gluon surface against the reference on the CPU:
``nn.Sequential``, the forward hooks, ``zero_grad``, ``summary``, the six
activation layers, ``gluon.utils`` (``split_data``, ``split_and_load``,
``clip_global_norm`` with its warning, ``check_sha1``,
``shape_is_known``) and the ``Orthogonal`` and ``LSTMBias``
initializers. Same numpy inputs and weights (moved by name); values and
gradients within 1e-5 relative (f32: the products' sums run in another
order); the random initializers by shape and distribution, since the two
packages draw from different generators. The reference's
``clip_global_norm`` calls ``nd.minimum``, which its namespace lacks; the
tests lend it ``broadcast_minimum`` under that name. The reference's
``LSTMBias`` writes into the read-only array ``asnumpy()`` returns and
cannot run, so the port's is held to the layout it documents."""
import hashlib
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

LIBS = ((mx, mx.cpu()), (pt, pt.cpu()))
RTOL, ATOL = 1e-5, 1e-6


def _x(shape=(4, 6), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def ref_minimum(monkeypatch):
    monkeypatch.setattr(mx.nd, "minimum", mx.nd.broadcast_minimum,
                        raising=False)


def _mlp(lib, kind):
    nn = lib.gluon.nn
    net = (nn.Sequential if kind == "Sequential" else nn.HybridSequential)(
        prefix="seq_")
    with net.name_scope():
        net.add(nn.Dense(5, activation="tanh", in_units=6),
                nn.Dense(3, in_units=5))
    return net


def _carry(ref, port):
    pt.params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                ref.collect_params().items()}, ctx=pt.cpu())


def _xavier_from(rs, net):
    """Xavier's draws (uniform within sqrt(6 / (fan_in + fan_out)), zero
    biases) taken from ``rs``, so the weights do not depend on what drew
    from the package's generator before."""
    for name, p in net.collect_params().items():
        if name.endswith("weight"):
            a = np.sqrt(6.0 / sum(p.shape))
            p.set_data(mx.nd.array(rs.uniform(-a, a, p.shape)
                                   .astype(np.float32), ctx=mx.cpu()))


@pytest.mark.parametrize("kind", ["Sequential", "HybridSequential"])
def test_sequential_matches_reference(kind):
    """Forward, gradients, ``len``, indexing and slicing."""
    ref, port = _mlp(mx, kind), _mlp(pt, kind)
    ref.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    _xavier_from(np.random.RandomState(0), ref)
    _carry(ref, port)
    assert list(port.collect_params()) == list(ref.collect_params())
    outs = []
    for (lib, ctx), net in zip(LIBS, (ref, port)):
        x = lib.nd.array(_x(), ctx=ctx)
        with lib.autograd.record():
            y = net(x)
            loss = (y * y).sum()
        loss.backward()
        assert len(net) == 2 and isinstance(net[1], lib.gluon.nn.Dense)
        assert len(net[:1]) == 1
        outs.append([y.asnumpy(), net[:1](x).asnumpy()]
                    + [p.grad().asnumpy()
                       for p in net.collect_params().values()])
    for p, r in zip(outs[1], outs[0]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


def test_forward_hooks_and_zero_grad():
    """Pre-hooks see the args before, hooks the output after, in the
    reference's order; ``zero_grad`` zeroes every gradient."""
    logs = []
    for lib, ctx in LIBS:
        net = _mlp(lib, "Sequential")
        net.initialize(ctx=ctx)
        log = []
        net.register_forward_pre_hook(
            lambda b, a, log=log: log.append(("pre", b.name, a[0].shape)))
        net[0].register_forward_hook(
            lambda b, a, o, log=log: log.append(("post", b.name, o.shape)))
        net.register_forward_hook(
            lambda b, a, o, log=log: log.append(("post", b.name, o.shape)))
        x = lib.nd.array(_x(), ctx=ctx)
        with lib.autograd.record():
            loss = net(x).sum()
        loss.backward()
        assert any(np.abs(p.grad().asnumpy()).sum() > 0
                   for p in net.collect_params().values())
        net.zero_grad()
        assert all(np.abs(p.grad().asnumpy()).sum() == 0
                   for p in net.collect_params().values())
        logs.append(log)
    assert logs[1] == logs[0]
    assert [e[0] for e in logs[1]] == ["pre", "post", "post"]


def _summary_nets(lib):
    """Embedding -> Dense(6) -> relu, and the embedding with a head tied
    to its weight (counted once, then as shared)."""
    nn = lib.gluon.nn
    net = nn.Sequential(prefix="m_")
    with net.name_scope():
        emb = nn.Embedding(10, 4)
        net.add(emb, nn.Dense(6, in_units=4, flatten=False),
                nn.Activation("relu"))
    tied = nn.Sequential(prefix="t_")
    tied.add(emb, nn.Dense(10, in_units=4, flatten=False, prefix=emb.prefix,
                           params=emb.params))
    return net, tied


def test_summary_matches_reference(capsys):
    """The same rows (type, output shape, parameter counts, the tied
    head's weight counted as shared) and the same printout."""
    got = []
    for lib, ctx in LIBS:
        rows = []
        for net in _summary_nets(lib):
            net.initialize(ctx=ctx)
            rows.append(dict(net.summary(
                lib.nd.array(np.array([[1, 2, 3]], np.float32), ctx=ctx))))
        got.append((rows, capsys.readouterr().out))
    assert got[1][0] == got[0][0]
    assert got[1][1] == got[0][1]
    assert "Shared params: 40" in got[1][1]
    net, _ = _summary_nets(pt)
    net.initialize(ctx=pt.cpu())
    net.hybridize()
    with pytest.raises(AssertionError, match="before hybridize"):
        net.summary(pt.nd.ones((1, 3), ctx=pt.cpu()))


ACTS = {"LeakyReLU": lambda nn: nn.LeakyReLU(0.15),
        "PReLU": lambda nn: nn.PReLU(),
        "ELU": lambda nn: nn.ELU(0.8), "SELU": lambda nn: nn.SELU(),
        "GELU": lambda nn: nn.GELU(), "Swish": lambda nn: nn.Swish(1.5)}


@pytest.mark.parametrize("name", sorted(ACTS))
@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_activation_layer_matches_reference(name, hybridize):
    """Output and input gradient (and PReLU's alpha gradient); the
    port's hybridized layer against the reference's eager one."""
    x = _x((2, 3, 5)) * 2
    outs = []
    for lib, ctx in LIBS:
        layer = ACTS[name](lib.gluon.nn)
        layer.initialize(ctx=ctx)
        if hybridize and lib is pt:
            layer.hybridize()
        a = lib.nd.array(x, ctx=ctx)
        a.attach_grad()
        with lib.autograd.record():
            y = layer(a)
            loss = (y * y).sum()
        loss.backward()
        vals = [y.asnumpy(), a.grad.asnumpy()]
        vals += [p.grad().asnumpy() for p in layer.collect_params().values()]
        outs.append(vals)
    assert len(outs[1]) == len(outs[0])
    for p, r in zip(outs[1], outs[0]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_slice,axis,even", [(2, 0, True), (3, 1, True),
                                                (4, 0, False)])
def test_split_data_and_load(num_slice, axis, even):
    x = _x((6, 9))
    got = []
    for lib, ctx in LIBS:
        parts = lib.gluon.utils.split_data(lib.nd.array(x, ctx=ctx),
                                           num_slice, axis, even)
        loaded = lib.gluon.utils.split_and_load(x, [ctx] * num_slice, axis,
                                                even)
        got.append([p.asnumpy() for p in parts + loaded])
        assert all(a.context == ctx for a in loaded)
    assert len(got[1]) == len(got[0])
    for p, r in zip(got[1], got[0]):
        np.testing.assert_array_equal(p, r)
    for lib, ctx in LIBS:
        with pytest.raises(ValueError, match="evenly split"):
            lib.gluon.utils.split_data(lib.nd.array(_x((5, 2)), ctx=ctx), 2)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
@pytest.mark.parametrize("check_isfinite", [True, False])
def test_clip_global_norm_matches_reference(ref_minimum, max_norm,
                                            check_isfinite):
    """Arrays scaled in place by min(1, max_norm / (norm + 1e-8)); a
    float norm with ``check_isfinite``, else an array."""
    xs = [_x((3, 4), 1), _x((5,), 2), _x((2, 2, 2), 3)]
    got = []
    for lib, ctx in LIBS:
        arrs = [lib.nd.array(a, ctx=ctx) for a in xs]
        alias = arrs[0]
        norm = lib.gluon.utils.clip_global_norm(arrs, max_norm,
                                                check_isfinite)
        if check_isfinite:
            assert isinstance(norm, float)
        else:
            norm = float(norm.asscalar())
        got.append([norm] + [a.asnumpy() for a in arrs] + [alias.asnumpy()])
    np.testing.assert_allclose(got[1][0], got[0][0], rtol=RTOL)
    for p, r in zip(got[1][1:], got[0][1:]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


def test_clip_global_norm_warns_on_a_non_finite_norm(ref_minimum):
    for lib, ctx in LIBS:
        arrs = [lib.nd.array(np.array([np.inf, 1.0], np.float32), ctx=ctx)]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            norm = lib.gluon.utils.clip_global_norm(arrs, 1.0)
        assert not np.isfinite(norm)
        assert any("nan or inf" in str(m.message) for m in w)


def test_check_sha1_and_shape_is_known(tmp_path):
    f = tmp_path / "blob"
    f.write_bytes(b"mxnet" * 1000)
    good = hashlib.sha1(f.read_bytes()).hexdigest()
    for lib, _ in LIBS:
        u = lib.gluon.utils
        assert u.check_sha1(str(f), good) and not u.check_sha1(str(f), "0")
        assert u.shape_is_known((2, 3)) and not u.shape_is_known((2, 0))
        assert not u.shape_is_known(None)


@pytest.mark.parametrize("shape", [(12, 5), (4, 3, 2, 2), (6, 20)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_by_shape_and_distribution(shape, rand_type):
    """``scale`` times orthonormal rows or columns, as the reference's;
    draws of the two generators differ, so the distribution of the
    entries is compared: the same squared norm, and a spread of entries
    within 25% of the reference's."""
    vals = []
    for lib, ctx in LIBS:
        init = lib.initializer.Orthogonal(scale=1.5, rand_type=rand_type)
        arr = lib.nd.zeros(shape, ctx=ctx)
        init("l0_h2h_weight", arr)
        vals.append(arr.asnumpy())
    for v in vals:
        m = v.reshape(shape[0], -1)
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)),
                                   atol=1e-4)
    port, ref = vals[1], vals[0]
    assert port.shape == ref.shape
    np.testing.assert_allclose((port ** 2).sum(), (ref ** 2).sum(),
                               rtol=1e-4)
    assert abs(port.std() / ref.std() - 1) < 0.25
    assert abs(port.mean()) < 3 * port.std() / np.sqrt(port.size) + 0.05


@pytest.mark.parametrize("forget_bias", [1.0, 2.5])
def test_lstm_bias_by_shape(forget_bias):
    """Zeros but the forget gate's quarter ([i, f, g, o]), for a bias
    and, as the reference's, for a weight named one; and through an LSTM
    layer's ``i2h_bias_initializer``."""
    for name, shape in (("l0_i2h_bias", (16,)), ("l0_h2h_weight", (8, 3))):
        arr = pt.nd.ones(shape, ctx=pt.cpu())
        pt.initializer.LSTMBias(forget_bias)(name, arr)
        want = np.zeros(shape, np.float32)
        want[shape[0] // 4:shape[0] // 2] = forget_bias
        np.testing.assert_array_equal(arr.asnumpy(), want)
    assert pt.initializer.create("lstmbias", forget_bias=forget_bias) == \
        pt.initializer.LSTMBias(forget_bias)
    layer = pt.gluon.rnn.LSTM(4, input_size=3, i2h_bias_initializer=pt.init
                              .LSTMBias(forget_bias))
    layer.initialize(ctx=pt.cpu())
    b = layer.l0_i2h_bias.data().asnumpy()
    assert (b[4:8] == forget_bias).all() and (b[:4] == 0).all() and \
        (b[8:] == 0).all()
