"""The port's ResNet ops and model zoo against the reference:
Convolution, Pooling, BatchNorm (with its moving statistics written back
through ``mutate_aux``), Flatten, the initializers, the conv and pooling
layers and ``gluon.model_zoo.vision.resnet`` (the Gluon training step is
tests/test_torch_resnet_train.py).

Both packages get the same numpy inputs; weights move from the
reference to the port by name with ``params_from_numpy``, the moving
statistics included. Tolerances: f32 within 1e-4 (the reference's XLA
convolutions and reductions add in another order than torch's), bf16
within 4e-2 relative L2.
"""
import ml_dtypes
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu.gluon.model_zoo import vision as rvision



def _rel(a, b, floor=0.0):
    """Relative L2 distance of ``a`` from ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor, 1e-30)


def small_resnets(kind):
    """ResNetV1 with one block per stage (bottleneck or basic), widths
    [8, 16, 32, 64, 128], 10 classes, thumbnail stem, prefix ``r_``, in
    both packages: the reference's MSRAPrelu weights carried to the port
    by name. Returns (reference net, port net, {name: array})."""
    def build(zoo):
        block = zoo.resnet.BottleneckV1 if kind == "bottleneck" else \
            zoo.resnet.BasicBlockV1
        return zoo.resnet.ResNetV1(block, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                                   classes=10, thumbnail=True, prefix="r_")
    ref = build(rvision)
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.MSRAPrelu(), ctx=mx.cpu())
    ref(mx.nd.array(np.zeros((1, 3, 16, 16), np.float32), ctx=mx.cpu()))
    arrays = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = build(pvision)
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    return ref, port, arrays


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
def _both(op, arrays, attrs):
    """Forward and input gradients of one op in both packages; returns
    [(port, ref)] over the output and each input's gradient."""
    res = []
    for lib, ctx in ((pt, pt.cpu()), (mx, mx.cpu())):
        xs = [lib.nd.array(a, ctx=ctx) for a in arrays]
        for v in xs:
            v.attach_grad()
        with lib.autograd.record():
            y = getattr(lib.nd, op)(*xs, **attrs)
        head = np.random.RandomState(0).randn(*y.shape).astype(np.float32)
        y.backward(lib.nd.array(head, ctx=ctx))
        res.append([y.asnumpy()] + [v.grad.asnumpy() for v in xs])
    return list(zip(*res))


@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), num_filter=6, pad=(1, 1)),
    dict(kernel=(3, 3), num_filter=6, stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), num_filter=6, dilate=(2, 2), pad=(2, 2)),
    dict(kernel=(3, 3), num_filter=6, num_group=2, pad=(1, 1)),
    dict(kernel=(1, 1), num_filter=6, stride=(2, 2), no_bias=True),
    dict(kernel=(7, 7), num_filter=6, stride=(2, 2), pad=(3, 3),
         no_bias=True),
    dict(kernel=(3,), num_filter=6, pad=(1,)),
], ids=["pad", "stride", "dilate", "groups", "1x1s2", "stem", "1d"])
def test_convolution_matches_reference(attrs):
    rng = np.random.RandomState(1)
    nsp = len(attrs["kernel"])
    x = rng.randn(*((2, 4) + (10,) * nsp)).astype(np.float32)
    w = rng.randn(6, 4 // attrs.get("num_group", 1),
                  *attrs["kernel"]).astype(np.float32)
    arrays = [x, w]
    if not attrs.get("no_bias"):
        arrays.append(rng.randn(6).astype(np.float32))
    for got, want in _both("Convolution", arrays, attrs):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("attrs", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
         pooling_convention="full"),
    dict(kernel=(2, 2), pool_type="avg"),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(3, 3), pool_type="sum", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(1, 1), pool_type="avg", global_pool=True),
    dict(kernel=(1, 1), pool_type="max", global_pool=True),
    dict(kernel=(3,), pool_type="max", stride=(2,)),
], ids=["max", "max_full", "avg", "avg_nopad", "avg_full_nopad", "sum",
        "global_avg", "global_max", "max_1d"])
def test_pooling_matches_reference(attrs):
    rng = np.random.RandomState(2)
    nsp = len(attrs["kernel"])
    x = rng.randn(*((2, 3) + (9,) * nsp)).astype(np.float32)
    for got, want in _both("Pooling", [x], attrs):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("use_global_stats", [False, True])
@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm_matches_reference(fix_gamma, use_global_stats, axis):
    """Training-mode BatchNorm: output, input gradients, and the moving
    statistics written back into the aux inputs. The moving mean is far
    from zero, so the statistics' shift matters."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 7) * 2 + 3).astype(np.float32)
    C = x.shape[axis]
    arrays = [x, rng.rand(C).astype(np.float32) + 0.5,
              rng.randn(C).astype(np.float32),
              (rng.randn(C) + 3).astype(np.float32),
              (rng.rand(C) + 1).astype(np.float32)]
    attrs = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma,
                 use_global_stats=use_global_stats, axis=axis)
    outs = []
    for lib, ctx in ((pt, pt.cpu()), (mx, mx.cpu())):
        xs = [lib.nd.array(a, ctx=ctx) for a in arrays]
        for v in xs[:3]:
            v.attach_grad()
        with lib.autograd.record():
            y = lib.nd.BatchNorm(*xs, **attrs)
        assert not isinstance(y, tuple)   # the aux outputs are not visible
        y.backward(lib.nd.array(np.cos(arrays[0]), ctx=ctx))
        outs.append([y.asnumpy()] + [v.grad.asnumpy() for v in xs[:3]]
                    + [xs[3].asnumpy(), xs[4].asnumpy()])
    for i, (got, want) in enumerate(zip(*outs)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=str(i))
    if not use_global_stats:
        assert not np.allclose(outs[0][4], arrays[3])   # stats moved


def test_batch_norm_write_back_stays_off_the_tape():
    x = pt.nd.array(np.random.RandomState(4).randn(8, 3, 2, 2), ctx=pt.cpu())
    g, b, mm, mv = (pt.nd.array(v, ctx=pt.cpu()) for v in (
        np.ones(3), np.zeros(3), np.zeros(3), np.ones(3)))
    x.attach_grad()
    with pt.autograd.record():
        y = pt.nd.BatchNorm(x, g, b, mm, mv, fix_gamma=False)
    assert y.tensor().requires_grad
    assert not mm.tensor().requires_grad and mm.tensor().grad_fn is None
    assert not mv.tensor().requires_grad and mv.tensor().grad_fn is None
    assert np.abs(mm.asnumpy()).sum() > 0
    y.backward()
    assert np.isfinite(x.grad.asnumpy()).all()


def test_flatten_matches_reference():
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    for got, want in _both("Flatten", [x], {}):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,init,std", [
    ("w_weight", pt.init.Normal(0.5), 0.5),
    ("w_weight", pt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                magnitude=2.0), np.sqrt(2.0 / (16 * 9))),
    ("w_weight", pt.init.MSRAPrelu(), np.sqrt(2.0 / 1.0625 / (24 * 9))),
    ("w_weight", pt.init.Xavier(), np.sqrt(3.0 / (24 * 9)) / np.sqrt(3)),
])
def test_initializers_draw_the_reference_distribution(name, init, std):
    """Shape-derived scales as the reference computes them, drawn from an
    explicit generator: the same seed gives the same draw."""
    x = pt.nd.zeros((32, 16, 3, 3), ctx=pt.cpu())
    pt.random.seed(11)
    init(name, x)
    a = x.asnumpy()
    assert abs(a.std() / std - 1) < 0.05 and abs(a.mean()) < 0.05 * std
    pt.random.seed(11)
    init(name, x)
    np.testing.assert_array_equal(x.asnumpy(), a)
    for aux, v in (("bn_running_mean", 0.0), ("bn_running_var", 1.0)):
        y = pt.nd.zeros((4,), ctx=pt.cpu())
        init(aux, y)
        np.testing.assert_array_equal(y.asnumpy(), np.full(4, v))


# ---------------------------------------------------------------------------
# the model zoo
# ---------------------------------------------------------------------------
def test_bf16_eval_rounds_where_the_reference_promotes():
    """In inference, the reference's BatchNorm promotes a bf16 input to
    f32 and its next convolution then refuses the mixed dtypes; the port
    rounds BatchNorm's output to the data's dtype (ROADMAP.md queue 3).
    The port's bf16 forward is held against the reference's f32 forward
    of the same bf16-rounded weights."""
    ref, port, arrays = small_resnets("bottleneck")
    x = np.random.RandomState(7).randn(4, 3, 16, 16).astype(np.float32)
    ref.cast("bfloat16")
    with pytest.raises(TypeError, match="same dtypes"):
        ref(mx.nd.array(x, ctx=mx.cpu()).astype("bfloat16"))
    port.cast("bfloat16")
    got = port(pt.nd.array(x, ctx=pt.cpu()).astype("bfloat16"))
    assert got.dtype == ml_dtypes.bfloat16
    ref.cast("float32")
    xb = mx.nd.array(x, ctx=mx.cpu()).astype("bfloat16").astype("float32")
    assert _rel(got.asnumpy(), ref(xb).asnumpy()) <= 4e-2


def test_resnet50_v1_forward_matches_reference():
    """The whole resnet50_v1 at 2x3x32x32 in f32: the parameter names
    and shapes, and the logits."""
    ref = rvision.resnet50_v1(prefix="resnet50_")
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.MSRAPrelu(), ctx=mx.cpu())
    x = np.random.RandomState(8).randn(2, 3, 32, 32).astype(np.float32)
    want = ref(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    arrays = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = pvision.get_model("resnet50_v1", prefix="resnet50_")
    assert list(port.collect_params().keys()) == list(arrays)
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    for n, p in port.collect_params().items():
        assert p.shape == arrays[n].shape, n
    got = port(pt.nd.array(x, ctx=pt.cpu())).asnumpy()
    assert got.shape == (2, 1000)
    assert _rel(got, want) <= 1e-4


def test_params_from_numpy_carries_the_moving_statistics():
    _, port, arrays = small_resnets("basic")
    stats = [n for n in arrays if "running" in n]
    assert len(stats) == 24     # 12 BatchNorms, 3 per stage
    for n in stats:
        p = port.collect_params()[n]
        assert p._is_aux and p.grad_req == "null"
        np.testing.assert_array_equal(p.data().asnumpy(), arrays[n])
    port.cast("bfloat16")
    for n in stats:   # BatchNorm stays f32 under a bf16 cast
        assert port.collect_params()[n].data().dtype == np.float32
