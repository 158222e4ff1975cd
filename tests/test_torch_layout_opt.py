"""The NHWC layout pass and the conv-bias elision on the port's
hybridized path (``mxnet_tpu_torch/symbol/layout_opt.py``,
``MXNET_LAYOUT_OPT``) and the space-to-depth stem (``MXNET_CONV_S2D``)
against the reference's ``tests/test_layout_opt.py`` contracts.

Both packages run the same nets from the same numpy weights and inputs
(seeded), hybridized, with the flag set the same way. The port's plan
(``CachedOp.layout_plan()``: for each conv call, channels-last or not,
bias elided or not) is held to the reference's rewritten ``cop._sym``
conv by conv: ``layout == "NHWC"`` and a ``BlockGrad`` bias input. The
port opens an island only for tensor-core data (16-bit, or f32 while
``torch.backends.cudnn.allow_tf32``, torch's default); the reference
rewrites every dtype, so those comparisons run at the default.

Tolerances: values against the reference at ``rtol=2e-3, atol=2e-4``,
the reference's own bound for its NHWC CachedOp against its NCHW one
(``tests/test_layout_opt.py``); the two packages also sum in other
orders. An elided bias gradient is exactly zero in both. The S2D stem
against the reference's ``_stem_s2d_conv`` at ``rtol=1e-5, atol=1e-5``
(f32, 147 products a sum). Structured dropout under the pass equals its
NCHW run bit for bit (the mask is drawn in the logical shape). With the
flag off a hybridized conv net equals its eager run bit for bit; with
it on, within the reference's bound.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import nn as ref_ops_nn

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.ops import nn as port_ops_nn
from mxnet_tpu_torch.symbol import layout_opt

RTOL, ATOL = 2e-3, 2e-4
LIBS = ((mx, mx.cpu()), (pt, pt.cpu()))


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    yield


def _small_convnet(lib, prefix="net_"):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, strides=2, padding=1, use_bias=True),
                nn.BatchNorm(),
                nn.Activation("relu"),
                nn.MaxPool2D(pool_size=2),
                nn.Conv2D(16, 1),
                nn.BatchNorm(),
                nn.Activation("relu"),
                nn.GlobalAvgPool2D(),
                nn.Dense(10))
    return net


def _bottleneck(lib, prefix="blk_"):
    from_lib = lib.gluon.model_zoo.vision.resnet
    return from_lib.BottleneckV1(16, 2, downsample=True, in_channels=8,
                                 prefix=prefix)


def _grouped_prelu(lib, prefix="gp_"):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1),
                nn.PReLU(),
                nn.Conv2D(8, 3, padding=1, groups=2),
                nn.BatchNorm(),
                nn.Conv2D(4, 1),
                nn.Activation("relu"))
    return net


NETS = {"convnet": (_small_convnet, (4, 3, 16, 16)),
        "bottleneck_v1": (_bottleneck, (2, 8, 8, 8)),
        "grouped_prelu": (_grouped_prelu, (2, 4, 8, 8))}


def _pair(kind, seed=1, bias_shift=0.0):
    """The reference's and the port's net of ``kind`` with the same
    seeded weights (conv biases shifted by ``bias_shift``)."""
    make, shape = NETS[kind]
    ref, port = make(mx), make(pt)
    ref.initialize(ctx=mx.cpu())
    ref(mx.nd.zeros(shape))
    rng = np.random.RandomState(seed)
    arrays = {}
    for n, p in ref.collect_params().items():
        a = (rng.randn(*p.shape) * 0.3).astype(np.float32)
        if n.endswith("running_var"):
            a = np.abs(a) + 1.0
        if n.endswith("bias") and "conv" in n:
            a = a + bias_shift
        arrays[n] = a
        p.set_data(mx.nd.array(a))
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    return ref, port, shape


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(lib, ctx, net, x, labels=None):
    """One recorded forward and backward: the output, the loss and every
    parameter's gradient by name."""
    xa = lib.nd.array(x, ctx=ctx)
    with lib.autograd.record():
        y = net(xa)
        if labels is None:
            loss = (y * y).sum()
        else:
            lf = lib.gluon.loss.SoftmaxCrossEntropyLoss()
            loss = lf(y, lib.nd.array(labels, ctx=ctx)).sum()
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    return y.asnumpy(), loss.asnumpy(), grads


def _ref_plan(net):
    """``(nhwc, bias_blocked)`` of each conv of the reference's
    rewritten CachedOp graph, in topological order."""
    cop = net._cached_op
    rows = []
    for n in cop._sym._topo():
        if n.is_variable or n.op.name != "Convolution":
            continue
        blocked = len(n.inputs) == 3 and not \
            n.inputs[2]._entries[0][0].is_variable and \
            n.inputs[2]._entries[0][0].op.name == "BlockGrad"
        rows.append((n.attrs.get("layout") == "NHWC", blocked))
    return rows


# ---------------------------------------------------------------------------
# against the reference's hybridized runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(NETS))
def test_loss_and_grad_parity(monkeypatch, kind):
    """Output, loss and every gradient with MXNET_LAYOUT_OPT=1 against
    the reference's NHWC CachedOp (ref :54); elided biases get exactly
    zero in both."""
    monkeypatch.setenv("MXNET_LAYOUT_OPT", "1")
    ref, port, shape = _pair(kind, bias_shift=0.37)
    x = _x(shape)
    labels = np.arange(shape[0]) % 4 if kind == "convnet" else None
    got = []
    for (lib, ctx), net in zip(LIBS, (ref, port)):
        net.hybridize()
        got.append(_run(lib, ctx, net, x, labels))
    (ry, rl, rg), (py, pl, pg) = got
    np.testing.assert_allclose(py, ry, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl, rl, rtol=RTOL, atol=ATOL)
    assert set(pg) == set(rg)
    assert any(r[1] for r in _ref_plan(ref))
    for n in rg:
        np.testing.assert_allclose(pg[n], rg[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
        if n.endswith("bias"):
            # an elided bias: exactly zero in both, or in neither
            assert np.any(pg[n]) == np.any(rg[n]), n


@pytest.mark.parametrize("flag", ["1", "0"])
@pytest.mark.parametrize("kind", sorted(NETS))
def test_plan_matches_reference_graph(monkeypatch, kind, flag):
    """The port's per-conv plan equals the reference's rewritten
    ``cop._sym`` (ref :84, :214, :248): NHWC where a 2-D ungrouped conv
    starts an island, a blocked bias where its only consumer is a
    training BatchNorm; with the flag off, no plan and an untouched
    graph."""
    monkeypatch.setenv("MXNET_LAYOUT_OPT", flag)
    ref, port, shape = _pair(kind)
    x = _x(shape)
    for (lib, ctx), net in zip(LIBS, (ref, port)):
        net.hybridize()
        _run(lib, ctx, net, x)
    want = _ref_plan(ref)
    assert want, "no conv in the reference's graph"
    got = port._cached_op.layout_plan()
    if flag == "0":
        assert got is None
        assert want == [(False, False)] * len(want)
    else:
        assert got == want


def test_plan_rows_of_known_nets(monkeypatch):
    """The decisions themselves: the small convnet's two convs both run
    channels-last with their biases elided; in the grouped/PReLU net
    the grouped conv stays NCHW, and the conv before PReLU keeps its
    bias's gradient; in BottleneckV1 the 3x3 conv and the downsample
    conv have no bias."""
    monkeypatch.setenv("MXNET_LAYOUT_OPT", "1")
    rows = {}
    for kind in NETS:
        _, port, shape = _pair(kind)
        port.hybridize()
        _run(pt, pt.cpu(), port, _x(shape))
        rows[kind] = port._cached_op.layout_plan()
    assert rows["convnet"] == [(True, True)] * 2
    assert rows["grouped_prelu"] == [(True, False), (False, True),
                                     (True, False)]
    assert rows["bottleneck_v1"] == [(True, True), (True, False),
                                     (True, True), (True, False)]


def test_bias_elision_parity(monkeypatch):
    """Nonzero conv biases (ref :117): the forward is the NCHW run's,
    the elided biases' gradients are exactly zero where the true ones
    are below 1e-4, and every other gradient matches the unelided run."""
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("MXNET_LAYOUT_OPT", flag)
        _, port, shape = _pair("convnet", bias_shift=0.37)
        port.hybridize()
        runs[flag] = _run(pt, pt.cpu(), port, _x(shape),
                          np.arange(shape[0]) % 4)
    (y0, l0, g0), (y1, l1, g1) = runs["0"], runs["1"]
    np.testing.assert_allclose(y1, y0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l1, l0, rtol=RTOL, atol=ATOL)
    for n in g0:
        if n.endswith("bias") and "conv" in n:
            assert float(np.abs(g1[n]).max()) == 0.0, n
            assert float(np.abs(g0[n]).max()) < 1e-4, n
        else:
            np.testing.assert_allclose(g1[n], g0[n], rtol=RTOL, atol=ATOL,
                                       err_msg=n)


def test_flag_is_part_of_the_signature(monkeypatch):
    """Flipping MXNET_LAYOUT_OPT between calls builds a new cache entry
    and a fresh plan, never a stale graph."""
    _, port, shape = _pair("convnet")
    port.hybridize()
    x = pt.nd.array(_x(shape), ctx=pt.cpu())
    monkeypatch.setenv("MXNET_LAYOUT_OPT", "0")
    off = port(x).asnumpy()
    cop = port._cached_op
    assert cop.num_entries() == 1 and cop.layout_plan() is None
    monkeypatch.setenv("MXNET_LAYOUT_OPT", "1")
    on = port(x).asnumpy()
    assert cop.num_entries() == 2
    # elision reads BatchNorm's attributes only, as the reference's does
    assert cop.layout_plan() == [(True, True)] * 2
    np.testing.assert_allclose(on, off, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,tf32,island", [
    ("float32", True, True), ("float32", False, False),
    ("bfloat16", False, True), ("float16", False, True),
    ("float64", True, False)])
def test_islands_open_for_tensor_core_data(monkeypatch, dtype, tf32, island):
    """An island opens where cuDNN would run the conv on tensor cores:
    16-bit data, or f32 while TF32 is allowed; f32 with TF32 off and
    f64 run NCHW. The bias elision does not depend on the dtype."""
    monkeypatch.setenv("MXNET_LAYOUT_OPT", "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    _, port, shape = _pair("grouped_prelu")
    port.cast(dtype)
    port.hybridize()
    y = port(pt.nd.array(_x(shape), ctx=pt.cpu(), dtype=dtype))
    assert y.tensor().dtype == getattr(torch, dtype)
    assert port._cached_op.layout_plan() == [(island, False), (False, True),
                                             (island, False)]
    assert layout_opt.tensor_core_dtype(getattr(torch, dtype)) == island


def test_s2d_flag_is_part_of_the_signature(monkeypatch):
    """Flipping MXNET_CONV_S2D between calls builds a new cache entry,
    never a graph of the other stem."""
    nn = pt.gluon.nn
    net = nn.HybridSequential(prefix="s2d_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 7, strides=2, padding=3, in_channels=3))
    net.initialize(ctx=pt.cpu())
    net.hybridize()
    x = pt.nd.array(_x((2, 3, 16, 16)), ctx=pt.cpu())
    outs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_CONV_S2D", flag)
        outs.append(net(x).asnumpy())
    assert net._cached_op.num_entries() == 2
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(NETS))
def test_hybridized_against_eager(monkeypatch, kind):
    """With the flag off the hybridized conv net is its eager run bit
    for bit (forward and gradients); with it on, within the reference's
    bound, and the outputs leave contiguous NCHW."""
    for flag in ("0", "1"):
        monkeypatch.setenv("MXNET_LAYOUT_OPT", flag)
        _, port, shape = _pair(kind)
        x = _x(shape)
        # a fresh net for each run: BatchNorm shifts its statistics by
        # the moving mean, which a run updates
        eager = _run(pt, pt.cpu(), port, x)
        _, port, _ = _pair(kind)
        port.hybridize()
        hyb = _run(pt, pt.cpu(), port, x)
        y = port(pt.nd.array(x, ctx=pt.cpu())).tensor()
        assert y.is_contiguous()
        # by position: a second BottleneckV1 names its convs anew
        pairs = [(hyb[0], eager[0]), (hyb[1], eager[1])] + \
            list(zip(hyb[2].values(), eager[2].values()))
        for a, b in pairs:
            if flag == "0":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_structured_dropout_under_the_pass(monkeypatch):
    """Dropout(axes=(2, 3)) after a conv inside an island (ref :261):
    whole channels dropped. On one channels-last input the op's output
    is its NCHW run's bit for bit from the same seed; through the
    hybridized net the mask (the zeros) is the NCHW run's bit for bit
    and the values within the bound (the conv sums in another order)."""
    x = torch.randn(2, 8, 6, 6)
    got = []
    for t in (x, x.contiguous(memory_format=torch.channels_last)):
        pt.random.seed(11)
        got.append(port_ops_nn.dropout_op(t, p=0.5, axes=(2, 3),
                                          _train=True))
    assert torch.equal(got[1], got[0])
    outs = {}
    w = (np.random.RandomState(3).randn(8, 4, 3, 3) * 0.3).astype(
        np.float32)
    for flag in ("0", "1"):
        monkeypatch.setenv("MXNET_LAYOUT_OPT", flag)
        nn = pt.gluon.nn
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, use_bias=False, in_channels=4),
                nn.Dropout(0.5, axes=(2, 3)))
        net.initialize(ctx=pt.cpu())
        net[0].weight.set_data(pt.nd.array(w, ctx=pt.cpu()))
        net.hybridize()
        xa = pt.nd.array(_x((2, 4, 6, 6)), ctx=pt.cpu())
        xa.attach_grad()
        pt.random.seed(11)
        with pt.autograd.record():
            y = net(xa)
        y.backward()
        outs[flag] = (y.asnumpy(), xa.grad.asnumpy())
        if flag == "1":
            assert net._cached_op.layout_plan() == [(True, False)]
    y0, y1 = outs["0"][0], outs["1"][0]
    np.testing.assert_array_equal(y1 == 0, y0 == 0)
    np.testing.assert_allclose(y1, y0, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs["1"][1], outs["0"][1], rtol=RTOL,
                               atol=ATOL)
    per_channel = np.abs(y1).reshape(2, 8, -1).max(-1)
    assert (per_channel == 0).any() and (per_channel > 0).any()


def test_pooling_and_batchnorm_keep_channels_last():
    """Pooling (max, avg, sum, full convention) and BatchNorm (train
    and inference) give a channels-last input a channels-last output."""
    x = torch.randn(2, 8, 9, 9).contiguous(memory_format=torch.channels_last)
    cl = torch.channels_last
    for kw in (dict(kernel=(3, 3), stride=(2, 2), pool_type="max"),
               dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="avg", count_include_pad=False),
               dict(kernel=(2, 2), pool_type="sum",
                    pooling_convention="full")):
        out = port_ops_nn.pooling(x, **kw)
        assert out.is_contiguous(memory_format=cl), kw
        ref = port_ops_nn.pooling(x.contiguous(), **kw)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    g, b = torch.rand(8) + 0.5, torch.randn(8)
    mm, mv = torch.zeros(8), torch.ones(8)
    for train in (True, False):
        out = port_ops_nn.batch_norm(x, g, b, mm, mv, fix_gamma=False,
                                     _train=train)[0]
        assert out.is_contiguous(memory_format=cl), train


# ---------------------------------------------------------------------------
# the space-to-depth stem
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("cin", [3, 4])
def test_s2d_stem_against_reference(channels_last, cin):
    """``_stem_s2d_conv`` against the reference's on both layouts (the
    port's NHWC is a channels-last NCHW tensor, the reference's a
    transposed array), and against the plain 7x7/s2/p3 convolution."""
    rng = np.random.RandomState(cin)
    x = rng.randn(2, cin, 16, 12).astype(np.float32)
    w = (rng.randn(8, cin, 7, 7) * 0.2).astype(np.float32)
    xt = torch.from_numpy(x)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
        want = np.asarray(ref_ops_nn._stem_s2d_conv(
            jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w),
            nhwc=True)).transpose(0, 3, 1, 2)
    else:
        want = np.asarray(ref_ops_nn._stem_s2d_conv(
            jnp.asarray(x), jnp.asarray(w)))
    got = port_ops_nn._stem_s2d_conv(xt, torch.from_numpy(w))
    assert got.is_contiguous(memory_format=torch.channels_last) \
        == channels_last or got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = torch.nn.functional.conv2d(torch.from_numpy(x),
                                       torch.from_numpy(w), None, 2, 3)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", [None, "NHWC"])
def test_s2d_switch_and_eligibility(monkeypatch, layout):
    """The Convolution op takes the S2D form exactly where the
    reference's eligibility holds, in both layouts; with MXNET_CONV_S2D=0
    (or cudnn_off, or C_in > 4, or odd H) it is the plain convolution
    bit for bit."""
    rng = np.random.RandomState(5)
    kw = dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=8,
              layout=layout)

    def conv(x, w, b, **extra):
        xt = torch.from_numpy(x)
        if layout == "NHWC":
            xt = xt.permute(0, 2, 3, 1).contiguous()
        out = port_ops_nn.convolution(xt, torch.from_numpy(w),
                                      torch.from_numpy(b), **kw, **extra)
        return (out.permute(0, 3, 1, 2) if layout == "NHWC" else out)

    exact = dict(rtol=0, atol=0) if layout is None else \
        dict(rtol=1e-6, atol=1e-6)
    for cin, h, eligible in ((3, 16, True), (5, 16, False),
                             (3, 15, False)):
        x = rng.randn(2, cin, h, 16).astype(np.float32)
        w = (rng.randn(8, cin, 7, 7) * 0.2).astype(np.float32)
        b = rng.randn(8).astype(np.float32)
        plain = torch.nn.functional.conv2d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            2, 3)
        s2d = port_ops_nn._stem_s2d_conv(
            torch.from_numpy(x), torch.from_numpy(w)) + \
            torch.from_numpy(b).reshape(1, -1, 1, 1) if eligible else None
        monkeypatch.setenv("MXNET_CONV_S2D", "1")
        on = conv(x, w, b)
        off_cudnn = conv(x, w, b, cudnn_off=True)
        monkeypatch.setenv("MXNET_CONV_S2D", "0")
        off = conv(x, w, b)
        torch.testing.assert_close(off, plain, **exact)
        torch.testing.assert_close(off_cudnn, plain, **exact)
        torch.testing.assert_close(on, plain, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(on, s2d if eligible else plain, **exact)


def test_s2d_gradients_match_plain_conv(monkeypatch):
    """The S2D form's data and weight gradients are the plain conv's up
    to summation order."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 3, 16, 16).astype(np.float32))
    w = torch.from_numpy((rng.randn(8, 3, 7, 7) * 0.2).astype(np.float32))
    grads = []
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_CONV_S2D", flag)
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = port_ops_nn.convolution(xa, wa, kernel=(7, 7), stride=(2, 2),
                                    pad=(3, 3), num_filter=8, no_bias=True)
        (y * y).sum().backward()
        grads.append((xa.grad, wa.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_layout_opt_module_surface():
    """The reference's names, and the flag's default (on)."""
    assert layout_opt.layout_opt_enabled() is True
    assert pt.config.get("MXNET_CONV_S2D") is True
    plan = layout_opt.LayoutPlan()
    fn = layout_opt.convert_layout(
        layout_opt.elide_conv_bias_into_bn(lambda: [torch.ones(1)], plan),
        plan)
    assert fn()[0].item() == 1.0 and plan.rows() == []
    assert layout_opt.active() is None
