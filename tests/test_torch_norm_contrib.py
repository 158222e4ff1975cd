"""The port's GroupNorm and InstanceNorm (ops and layers), ``Lambda`` and
``HybridLambda``, ``gluon.contrib.nn``, the ``Bilinear`` and ``Mixed``
initializers and ``gluon.Constant`` against the reference on the CPU,
and the new layers' parameters carried by name through
``params_from_numpy`` and through parameter files both ways.

Same numpy inputs and weights (moved by name). f32 values and gradients
within 1e-5 relative (normalizations over at most a few hundred
elements). bf16 data: the port keeps the statistics in f32 and rounds
once, the reference rounds to bf16 after each step (mean, centring,
scaling, the affine), so the two are held within ``BF16_TOL`` = 2^-6
relative and absolute, four bf16 half-ulps of the unit-scale output.
``Bilinear`` is exact (the same float64 formula rounded to f32).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as ref_amp
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.contrib import amp

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2.0 ** -6
LIBS = ((mx, mx.cpu()), (pt, pt.cpu()))


def _rs(seed):
    return np.random.RandomState(seed)


def _carry(ref, port):
    pt.params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                ref.collect_params().items()}, ctx=pt.cpu())


def _affine(shape, seed):
    rs = _rs(seed)
    return (rs.rand(shape[1]).astype(np.float32) + 0.5,
            rs.randn(shape[1]).astype(np.float32))


NORM_CASES = [
    ("GroupNorm", (4, 6, 5, 5), {"num_groups": 3}),
    ("GroupNorm", (2, 8, 7), {"num_groups": 4, "eps": 1e-3}),
    ("GroupNorm", (64, 32), {"num_groups": 8}),
    ("InstanceNorm", (4, 6, 5, 5), {}),
    ("InstanceNorm", (3, 5, 9), {"eps": 1e-5}),
]


@pytest.mark.parametrize("name,shape,kw", NORM_CASES)
def test_norm_ops_value_and_gradient(name, shape, kw):
    x = _rs(0).randn(*shape).astype(np.float32) * 2 + 1
    g, b = _affine(shape, 1)
    head = _rs(2).randn(*shape).astype(np.float32)
    res = []
    for lib, ctx in LIBS:
        arrays = [lib.nd.array(a, ctx=ctx) for a in (x, g, b)]
        for a in arrays:
            a.attach_grad()
        with lib.autograd.record():
            out = getattr(lib.nd, name)(*arrays, **kw)
            total = (out * lib.nd.array(head, ctx=ctx)).sum()
        total.backward()
        res.append([out.asnumpy()] + [a.grad.asnumpy() for a in arrays])
    for p, r in zip(res[1], res[0]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL * 10)


@pytest.mark.parametrize("affine", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,shape,kw", NORM_CASES[:1] + NORM_CASES[3:4])
def test_norm_ops_bf16_keep_f32_statistics(name, shape, kw, affine):
    """bf16 data: with bf16 gamma and beta a bf16 output equal to the
    f32 computation rounded once; with f32 ones an f32 output (the
    reference's promotion). Either within BF16_TOL of the reference."""
    import ml_dtypes
    x = (_rs(3).randn(*shape) * 2 + 1).astype(ml_dtypes.bfloat16)
    g, b = (a.astype(ml_dtypes.bfloat16).astype(affine)
            for a in _affine(shape, 4))
    outs = []
    for lib, ctx in LIBS:
        out = getattr(lib.nd, name)(lib.nd.array(x, ctx=ctx),
                                    lib.nd.array(g, ctx=ctx),
                                    lib.nd.array(b, ctx=ctx), **kw)
        assert str(out.dtype) == affine
        outs.append(out.asnumpy().astype(np.float32))
    np.testing.assert_allclose(outs[1], outs[0], rtol=BF16_TOL,
                               atol=BF16_TOL)
    f32 = getattr(pt.nd, name)(*(pt.nd.array(a.astype(np.float32),
                                             ctx=pt.cpu())
                                 for a in (x, g, b)), **kw).asnumpy()
    if affine == "bfloat16":
        f32 = f32.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(outs[1], f32)


def _norm_net(lib, kind, prefix="net_"):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(6, 3, padding=1, in_channels=3))
        if kind == "group":
            net.add(nn.GroupNorm(num_groups=2))
        else:
            net.add(nn.InstanceNorm(scale=True, epsilon=1e-3))
        net.add(nn.Activation("relu"), nn.Dense(4))
    return net


@pytest.mark.parametrize("kind", ["group", "instance"])
@pytest.mark.parametrize("hybridize", [False, True])
def test_norm_layers_match_reference(kind, hybridize):
    """Deferred shapes, the reference's parameter names, forward and
    every gradient; hybridized too."""
    ref, port = _norm_net(mx, kind), _norm_net(pt, kind)
    x = _rs(5).randn(2, 3, 6, 6).astype(np.float32)
    ref.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    ref(mx.nd.array(x))
    rs = _rs(6)
    for p in ref.collect_params().values():
        p.set_data(mx.nd.array(rs.randn(*p.shape).astype(np.float32) * 0.3
                               + (1.0 if p.name.endswith("gamma") else 0)))
    _carry(ref, port)
    assert list(port.collect_params()) == list(ref.collect_params())
    if hybridize:
        port.hybridize()
    res = []
    for (lib, ctx), net in zip(LIBS, (ref, port)):
        xa = lib.nd.array(x, ctx=ctx)
        with lib.autograd.record():
            y = net(xa)
            loss = (y * y).sum()
        loss.backward()
        res.append([y.asnumpy()] + [p.grad().asnumpy() for p in
                                    net.collect_params().values()
                                    if p.grad_req != "null"])
    assert len(res[1]) == len(res[0])
    for p, r in zip(res[1], res[0]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-5)


def test_instance_norm_scale_defaults_to_null():
    for lib, ctx in LIBS:
        layer = lib.gluon.nn.InstanceNorm()
        assert layer.gamma.grad_req == "null"
        assert layer.beta.grad_req == "write"


def test_lambda_layers():
    x = _rs(7).randn(3, 4).astype(np.float32)
    outs = []
    for lib, ctx in LIBS:
        nn = lib.gluon.nn
        blocks = [nn.Lambda("tanh"), nn.Lambda(lambda a: a * 2),
                  nn.HybridLambda("relu"),
                  nn.HybridLambda(lambda F, a: F.softmax(a) + 1)]
        hyb = nn.HybridLambda(lambda F, a, b: F.broadcast_add(a, b))
        if lib is pt:
            hyb.hybridize()
        xa = lib.nd.array(x, ctx=ctx)
        outs.append([b(xa).asnumpy() for b in blocks]
                    + [hyb(xa, xa).asnumpy()])
    for p, r in zip(*reversed(outs)):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# gluon.contrib.nn
# ---------------------------------------------------------------------------
def _concurrent(lib):
    cn = lib.gluon.contrib.nn
    net = cn.HybridConcurrent(axis=1, prefix="cc_")
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(3, in_units=4))
        net.add(cn.Identity())
        net.add(lib.gluon.nn.Dense(2, in_units=4, activation="tanh"))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_hybrid_concurrent_and_identity(hybridize):
    ref, port = _concurrent(mx), _concurrent(pt)
    ref.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    _carry(ref, port)
    assert list(port.collect_params()) == list(ref.collect_params())
    if hybridize:
        port.hybridize()
    x = _rs(8).randn(5, 4).astype(np.float32)
    res = []
    for (lib, ctx), net in zip(LIBS, (ref, port)):
        xa = lib.nd.array(x, ctx=ctx)
        xa.attach_grad()
        with lib.autograd.record():
            y = net(xa)
            loss = (y * y).sum()
        loss.backward()
        assert y.shape == (5, 9)
        res.append([y.asnumpy(), xa.grad.asnumpy()]
                   + [p.grad().asnumpy()
                      for p in net.collect_params().values()])
    for p, r in zip(res[1], res[0]):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)
    assert pt.gluon.contrib.nn.Concurrent is pt.gluon.contrib.nn \
        .HybridConcurrent


def test_sync_batch_norm_is_batch_norm_on_one_device():
    """Training mode: output, gradients and moving statistics as the
    reference's SyncBatchNorm; with more devices, outside a sharded
    step, it is the same BatchNorm."""
    x = _rs(9).randn(4, 3, 5, 5).astype(np.float32) * 3 + 1
    res = []
    for lib, ctx in LIBS:
        bn = lib.gluon.contrib.nn.SyncBatchNorm(in_channels=3, momentum=0.8,
                                               num_devices=1)
        bn.initialize(ctx=ctx)
        xa = lib.nd.array(x, ctx=ctx)
        xa.attach_grad()
        with lib.autograd.record():
            y = bn(xa)
            loss = (y * y * y).sum()
        loss.backward()
        res.append([y.asnumpy(), xa.grad.asnumpy(),
                    bn.running_mean.data().asnumpy(),
                    bn.running_var.data().asnumpy()])
    for p, r in zip(res[1], res[0]):
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4)
    bn4 = pt.gluon.contrib.nn.SyncBatchNorm(in_channels=3, momentum=0.8,
                                           num_devices=4, prefix="sbn4_")
    bn4.initialize(ctx=pt.cpu())
    xa = pt.nd.array(x, ctx=pt.cpu())
    xa.attach_grad()
    with pt.autograd.record():
        y = bn4(xa)
        loss = (y * y * y).sum()
    loss.backward()
    for p, r in zip([y.asnumpy(), xa.grad.asnumpy(),
                     bn4.running_mean.data().asnumpy(),
                     bn4.running_var.data().asnumpy()], res[1]):
        np.testing.assert_array_equal(p, r)


# ---------------------------------------------------------------------------
# initializers and Constant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 1, 5, 5),
                                   (1, 2, 3, 6)])
def test_bilinear_is_exact(shape):
    outs = []
    for lib, ctx in LIBS:
        arr = lib.nd.zeros(shape, ctx=ctx)
        lib.initializer.Bilinear()("up_weight", arr)
        outs.append(arr.asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])


def _mixed(lib):
    return lib.initializer.Mixed(
        [".*bias", ".*gamma", ".*"],
        [lib.initializer.Constant(0.5), lib.initializer.One(),
         lib.initializer.Bilinear()])


def test_mixed_matches_by_pattern():
    """The first matching pattern's initializer; no match raises."""
    for name, shape in (("up_bias", (4,)), ("bn_gamma", (3,)),
                        ("up_weight", (2, 1, 4, 4))):
        outs = []
        for lib, ctx in LIBS:
            arr = lib.nd.zeros(shape, ctx=ctx)
            _mixed(lib)(name, arr)
            outs.append(arr.asnumpy())
        np.testing.assert_array_equal(outs[1], outs[0])
    only = pt.initializer.Mixed(["conv.*"], [pt.initializer.Zero()])
    with pytest.raises(ValueError, match="did not match"):
        only("dense_weight", pt.nd.zeros((2,), ctx=pt.cpu()))


def test_mixed_through_initialize():
    """``Block.initialize(init=Mixed(...))``, as MXNet 1.x takes it;
    the reference's ``create`` reads a Mixed as a name and raises (a gap
    kept, ROADMAP.md queue 3)."""
    def mixed(lib):
        return lib.initializer.Mixed(
            [".*weight", ".*"],
            [lib.initializer.Constant(0.5), lib.initializer.One()])
    net = pt.gluon.nn.HybridSequential()
    net.add(pt.gluon.nn.Dense(3, in_units=2), pt.gluon.nn.LayerNorm(
        in_channels=3))
    net.initialize(init=mixed(pt), ctx=pt.cpu())
    params = list(net.collect_params().values())
    # a bias and a beta take zeros whatever the initializer, as the
    # reference's suffix dispatch gives them
    np.testing.assert_array_equal(params[0].data().asnumpy(),
                                  np.full((3, 2), 0.5))
    np.testing.assert_array_equal(params[1].data().asnumpy(), [0.0] * 3)
    np.testing.assert_array_equal(params[2].data().asnumpy(), [1.0] * 3)
    ref = mx.gluon.nn.Dense(3, in_units=2)
    with pytest.raises(AttributeError):
        ref.initialize(init=mixed(mx), ctx=mx.cpu())


def _scaled(lib, value):
    """A block whose output is x * scale, scale a Constant."""
    class Scaled(lib.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.scale = self.params.get_constant("scale", value)

        def hybrid_forward(self, F, x, scale):
            return F.broadcast_mul(x, scale)
    return Scaled(prefix="s_")


def test_constant():
    """Its value whatever the block's initializer, no gradient, exported
    from ``gluon``, and ``var`` waits for the symbol module."""
    value = [[1.0, 2.0, 3.0]]
    x = _rs(10).randn(2, 3).astype(np.float32)
    outs = []
    for lib, ctx in LIBS:
        assert lib.gluon.Constant is lib.gluon.parameter.Constant
        net = _scaled(lib, value)
        net.initialize(lib.initializer.Zero(), ctx=ctx)
        assert net.scale.grad_req == "null"
        assert list(net.collect_params()) == ["s_scale"]
        xa = lib.nd.array(x, ctx=ctx)
        xa.attach_grad()
        with lib.autograd.record():
            y = net(xa)
        y.backward()
        outs.append([net.scale.data().asnumpy(), y.asnumpy(),
                     xa.grad.asnumpy()])
    for p, r in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(p, r)
    c = pt.gluon.Constant("c", np.arange(4, dtype=np.int32))
    assert c.dtype == "int32" and c.shape == (4,)
    with pytest.raises(pt.MXNetError, match="item 16"):
        c.var()


# ---------------------------------------------------------------------------
# the parameters carried by name
# ---------------------------------------------------------------------------
def _carry_net(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(nn.GroupNorm(num_groups=2, in_channels=4),
                nn.InstanceNorm(scale=True, in_channels=4),
                _scaled(lib, [[[[2.0]]]]))
    return net


def test_params_from_numpy_new_layers():
    ref, port = _carry_net(mx), _carry_net(pt)
    ref.initialize(ctx=mx.cpu())
    rs = _rs(11)
    arrays = {n: rs.randn(*p.shape).astype(np.float32)
              for n, p in ref.collect_params().items()}
    for n, a in arrays.items():
        ref.collect_params()[n].set_data(mx.nd.array(a))
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    assert sorted(port.collect_params()) == sorted(arrays) == [
        "m_group_norm0_beta", "m_group_norm0_gamma",
        "m_instance_norm0_beta", "m_instance_norm0_gamma", "m_s_scale"]
    x = _rs(12).randn(2, 4, 3, 3).astype(np.float32)
    np.testing.assert_allclose(port(pt.nd.array(x, ctx=pt.cpu())).asnumpy(),
                               ref(mx.nd.array(x)).asnumpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_parameter_files_both_ways(tmp_path, writer):
    """``save_parameters`` of one package loads into the other: every
    GroupNorm, InstanceNorm and Constant array bit for bit."""
    ref, port = _carry_net(mx), _carry_net(pt)
    ref.initialize(ctx=mx.cpu())
    port.initialize(ctx=pt.cpu())
    rs = _rs(13)
    src = ref if writer == "reference" else port
    lib = mx if writer == "reference" else pt
    ctx = mx.cpu() if writer == "reference" else pt.cpu()
    for p in src.collect_params().values():
        p.set_data(lib.nd.array(rs.randn(*p.shape).astype(np.float32),
                                ctx=ctx))
    path = str(tmp_path / "net.params")
    src.save_parameters(path)
    dst = port if writer == "reference" else ref
    if dst is port:
        dst.load_parameters(path, ctx=pt.cpu())
    else:
        dst.load_parameters(path, ctx=mx.cpu())
    for (n, a), (m, b) in zip(src.collect_params().items(),
                              dst.collect_params().items()):
        assert n == m
        np.testing.assert_array_equal(a.data().asnumpy(), b.data().asnumpy())


# ---------------------------------------------------------------------------
# AMP
# ---------------------------------------------------------------------------
@pytest.fixture
def _amp_on():
    yield
    amp.reset()
    ref_amp.reset()


def test_amp_group_norm_and_softmax_output(_amp_on):
    """Under ``amp.init()`` (bf16): GroupNorm on bf16 data with f32
    gamma and beta is not cast (its output promotes to f32), and
    SoftmaxOutput runs in f32 (the f32 list); both packages, within
    BF16_TOL, with SoftmaxOutput's own gradient."""
    import ml_dtypes
    x = (_rs(14).randn(8, 4, 3, 3)).astype(ml_dtypes.bfloat16)
    g, b = _affine((8, 4), 15)
    label = _rs(16).randint(0, 36, 8).astype(np.float32)
    res = []
    for (lib, ctx), a in zip(LIBS, (ref_amp, amp)):
        a.init(target_dtype="bfloat16")
        xa = lib.nd.array(x, ctx=ctx)
        xa.attach_grad()
        with lib.autograd.record():
            h = lib.nd.GroupNorm(xa, lib.nd.array(g, ctx=ctx),
                                 lib.nd.array(b, ctx=ctx), num_groups=2)
            assert h.dtype == np.float32
            p = lib.nd.SoftmaxOutput(lib.nd.reshape(h, shape=(8, 36)),
                                     lib.nd.array(label, ctx=ctx),
                                     normalization="batch")
            assert p.dtype == np.float32
        p.backward()
        res.append([h.asnumpy().astype(np.float32), p.asnumpy(),
                    xa.grad.asnumpy().astype(np.float32)])
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
