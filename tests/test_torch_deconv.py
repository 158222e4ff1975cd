"""The port's ``Deconvolution`` op and the ``Conv1DTranspose`` and
``Conv2DTranspose`` layers against the reference, on the CPU: forward
and the gradients of the data, the weight (laid out (in, out/g, k...))
and the bias over stride, pad, adj, dilate and groups with in != out,
1-D and 2-D, and the layers' parameter names, deferred shapes and
outputs.

Both packages get the same numpy inputs. Tolerance: f32 within 1e-5
relative L2 (the reference computes an input-dilated convolution with
the flipped kernel, torch a transposed convolution: the same products
summed in another order).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _deconv(lib, ctx, x, w, b, attrs):
    xs = [lib.nd.array(a, ctx=ctx) for a in (x, w) + ((b,) if b is not None
                                                       else ())]
    for a in xs:
        a.attach_grad()
    dy = np.random.RandomState(9)
    with lib.autograd.record():
        out = lib.nd.Deconvolution(*xs, **attrs)
        loss = (out * lib.nd.array(dy.randn(*out.shape).astype(np.float32),
                                   ctx=ctx)).sum()
    loss.backward()
    return [out.asnumpy()] + [a.grad.asnumpy() for a in xs]


# (in, out, groups, kernel, stride, pad, adj, dilate, spatial size)
CASES = [
    (4, 6, 1, (3, 3), (1, 1), (0, 0), (0, 0), (1, 1), (7, 7)),
    (4, 6, 1, (3, 3), (2, 2), (1, 1), (1, 1), (1, 1), (7, 6)),
    (6, 9, 3, (3, 2), (2, 1), (1, 0), (1, 0), (1, 2), (6, 7)),
    (8, 4, 2, (4, 4), (2, 2), (1, 1), (0, 0), (1, 1), (5, 5)),
    (3, 5, 1, (4, 3), (3, 2), (2, 1), (2, 1), (2, 1), (6, 5)),
    (4, 6, 2, (3,), (2,), (1,), (1,), (1,), (9,)),
    (5, 3, 1, (5,), (3,), (2,), (0,), (2,), (8,)),
]


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "in%d_out%d_g%d_k%s_s%s"
                         % (c[0], c[1], c[2], "x".join(map(str, c[3])),
                            "x".join(map(str, c[4]))))
def test_deconvolution_matches_the_reference(case, bias):
    cin, cout, g, k, s, p, a, d, size = case
    rng = np.random.RandomState(0)
    x = rng.randn(2, cin, *size).astype(np.float32)
    w = rng.randn(cin, cout // g, *k).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    attrs = dict(kernel=k, num_filter=cout, stride=s, pad=p, adj=a,
                 dilate=d, num_group=g, no_bias=not bias)
    got = _deconv(pt, pt.cpu(), x, w, b, attrs)
    ref = _deconv(mx, mx.cpu(), x, w, b, attrs)
    # the output size MXNet documents: (in - 1) s - 2 p + d (k - 1) + 1 + adj
    want = tuple((n - 1) * ss - 2 * pp + dd * (kk - 1) + 1 + aa
                 for n, ss, pp, dd, kk, aa in zip(size, s, p, d, k, a))
    assert got[0].shape == (2, cout) + want
    for g_, r_ in zip(got, ref):
        assert _rel(g_, r_) <= TOL


def test_grouped_weight_blocks_are_not_transposed():
    """With groups, input block j reaches output block j only: a weight
    that is nonzero in group 0's block alone leaves the other outputs
    at the bias (a silent transposition of the blocks would not)."""
    cin, cout, g = 6, 9, 3
    w = np.zeros((cin, cout // g, 3, 3), np.float32)
    w[:cin // g] = 1.0
    x = np.ones((1, cin, 4, 4), np.float32)
    out = pt.nd.Deconvolution(pt.nd.array(x, ctx=pt.cpu()),
                              pt.nd.array(w, ctx=pt.cpu()), kernel=(3, 3),
                              num_filter=cout, num_group=g).asnumpy()
    ref = mx.nd.Deconvolution(mx.nd.array(x, ctx=mx.cpu()),
                              mx.nd.array(w, ctx=mx.cpu()), kernel=(3, 3),
                              num_filter=cout, num_group=g).asnumpy()
    assert out[:, :cout // g].min() > 0 and not out[:, cout // g:].any()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_transposed_layers_are_the_reference_list():
    from mxnet_tpu.gluon.nn import conv_layers as rconv
    from mxnet_tpu_torch.gluon.nn import conv_layers as pconv
    assert set(pconv.__all__) == set(rconv.__all__)
    for name in ("Conv1DTranspose", "Conv2DTranspose"):
        assert name in pconv.__all__
    assert "Conv3DTranspose" not in pconv.__all__


LAYERS = [
    ("Conv2DTranspose", dict(channels=6, kernel_size=3, strides=2, padding=1,
                             output_padding=1), (2, 4, 5, 5)),
    ("Conv2DTranspose", dict(channels=8, kernel_size=(4, 2), strides=(2, 1),
                             groups=2, use_bias=False, in_channels=6),
     (2, 6, 5, 4)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, dilation=2,
                             activation="relu"), (1, 3, 6, 6)),
    ("Conv1DTranspose", dict(channels=5, kernel_size=4, strides=2, padding=1),
     (2, 3, 7)),
    ("Conv1DTranspose", dict(channels=6, kernel_size=3, groups=3,
                             output_padding=0, in_channels=9), (2, 9, 6)),
]


@pytest.mark.parametrize("name,kw,shape", LAYERS,
                         ids=["2d_s2_adj", "2d_groups", "2d_dilate_relu",
                              "1d_s2", "1d_groups"])
def test_transposed_layer_matches_the_reference(name, kw, shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    ref = getattr(mx.gluon.nn, name)(prefix="t_", **kw)
    port = getattr(pt.gluon.nn, name)(prefix="t_", **kw)
    assert [(n, p.shape) for n, p in port.collect_params().items()] == \
        [(n, p.shape) for n, p in ref.collect_params().items()]
    mx.random.seed(0)
    ref.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    ref(mx.nd.array(x, ctx=mx.cpu()))
    arrays = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    cin = shape[1]
    groups = kw.get("groups", 1)
    assert arrays["t_weight"].shape == \
        (cin, kw["channels"] // groups) + port._kwargs["kernel"]
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    outs = []
    for lib, net, ctx in ((pt, port, pt.cpu()), (mx, ref, mx.cpu())):
        xs = lib.nd.array(x, ctx=ctx)
        xs.attach_grad()
        with lib.autograd.record():
            out = net(xs)
            loss = (out * out).sum()
        loss.backward()
        outs.append([out.asnumpy(), xs.grad.asnumpy()] + [
            p.grad().asnumpy() for p in net.collect_params().values()])
    for g_, r_ in zip(*outs):
        assert _rel(g_, r_) <= TOL
