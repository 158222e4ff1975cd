"""The port's vision model zoo against the reference, on the CPU:
``get_model``'s names, ``pretrained=True``, every constructor's parameter
names and declared shapes, one model of each family at full size (its
shapes inferred by a forward in the port, by the reference's symbols),
and each family's forward and gradients at batch 2 and the smallest
input it takes (``family_parity``). The families whose reference runs
take longest have files of their own (``test_torch_vision_zoo_*.py``),
which import the helper from here.

Both packages get the same numpy input; the reference's Xavier weights,
with biases and BatchNorm betas drawn from the same seed, move to the
port by name with ``params_from_numpy``. (Zero biases would leave exact
zeros under the ReLUs, where the reference's ``jnp.maximum`` gradient is
0.5 and MXNet's, the port's, 0: ROADMAP queue 3.) The step is a
recorded forward with every Dropout at rate 0, so both packages compute
the same function, and a backward of ``sum(out * w)`` for a fixed ``w``.
Tolerance: the output and every gradient within 1e-4 relative L2 (f32;
the reference's XLA convolutions and reductions add in another order
than torch's), against at least a thousandth of the largest gradient.

BatchNorm runs on batch statistics (training mode) where the net is
shallow: AlexNet, VGG with and without BatchNorm, SqueezeNet. MobileNet,
DenseNet and Inception v3 run it on its moving statistics: the training
form's f32 variance, E[x^2] - E[x]^2 shifted by the moving mean, and its
backward's sum(dy x) - mean sum(dy) cancel where a channel's mean is
far above its spread (the ReLU maps of an unnormalised input), which
moves both packages' gradients by up to 8% from each other over
Inception's 94 layers (1e-3 at MobileNet's 27), a property of the
shared formula and not of either package. The training form is held
on VGG-BN here, at the op level in ``test_torch_resnet.py``, and every
family's full-width training step against its float64 twin on the card
(``chip_smoke.py`` phase 15). The nets whose max pools take ReLU maps
with dead regions, SqueezeNet and Inception v3, hold their gradients
within POOL_TOL = 5e-3: where two values of a window are within the
forwards' rounding of each other, the two packages route the window's
gradient to different inputs (readings: 2.5e-3 for SqueezeNet 1.0 at
224, 5.3e-4 for 1.1, 1.1e-3 for one weight of Inception v3; every other
gradient within 1e-4).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as rvision

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision

TOL = 1e-4
POOL_TOL = 5e-3
# the first model of each family at its full input size
FULL_SIZE = [("alexnet", 224), ("vgg11", 224), ("vgg11_bn", 224),
             ("mobilenet1_0", 224), ("mobilenet_v2_1_0", 224),
             ("densenet121", 224), ("squeezenet1_0", 224),
             ("squeezenet1_1", 224), ("inception_v3", 299)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _zero_dropout(block):
    """Every Dropout of ``block`` at rate 0 (either package)."""
    if type(block).__name__ == "Dropout":
        block._rate = 0.0
    for child in block._children.values():
        _zero_dropout(child)


def _ref_parts(net):
    """The reference blocks whose parameters are initialized together:
    the net, or AlexNet's features and output apart, since the
    reference's AlexNet holds ``dense0`` twice (ROADMAP queue 3)."""
    if isinstance(net, rvision.AlexNet):
        return [net.features, net.output]
    return [net]


def _alexnet_name(name, part):
    return name.replace("dense0", "dense2") if part == 1 else name


def _ref_params(net):
    """[(the port's name, reference Parameter)] in order."""
    out = []
    for i, part in enumerate(_ref_parts(net)):
        for n, p in part.collect_params().items():
            out.append((_alexnet_name(n, i) if len(_ref_parts(net)) > 1
                        else n, p))
    return out


def family_parity(build, shape, seed=0, grad_tol=TOL, train=True):
    """``build(zoo)`` in both packages: the port's forward within TOL and
    every gradient within ``grad_tol`` of the reference's at input
    ``shape``; BatchNorm on batch statistics if ``train``, else on its
    moving statistics."""
    ref = build(rvision)
    _zero_dropout(ref)
    mx.random.seed(seed)
    for part in _ref_parts(ref):
        part.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    ref(mx.nd.array(x, ctx=mx.cpu()))       # the deferred shapes
    rparams = _ref_params(ref)
    for n, p in rparams:
        if n.endswith(("_bias", "_beta")):
            p.set_data(mx.nd.array(rng.uniform(-0.1, 0.1, p.shape).astype(
                np.float32), ctx=mx.cpu()))
    arrays = {n: p.data().asnumpy() for n, p in rparams}
    port = build(pvision)
    _zero_dropout(port)
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())

    outs, grads = [], []
    for lib, net, params, ctx in (
            (mx, ref, rparams, mx.cpu()),
            (pt, port, list(port.collect_params().items()), pt.cpu())):
        xs = lib.nd.array(x, ctx=ctx)
        with lib.autograd.record(train_mode=train):
            out = net(xs)
            w = lib.nd.array(np.random.RandomState(seed + 1).randn(
                *out.shape).astype(np.float32), ctx=ctx)
            loss = (out * w).sum()
        loss.backward()
        outs.append(out.asnumpy())
        grads.append({n: p.grad().asnumpy() for n, p in params
                      if p.grad_req != "null"})
    assert _rel(outs[1], outs[0]) <= TOL
    assert np.std(outs[0]) > 0                # not a dead net
    assert grads[0].keys() == grads[1].keys() and grads[0]
    # a bias straight before a BatchNorm has a zero gradient, so its
    # reading is rounding noise: distances are taken against at least a
    # thousandth of the largest gradient
    floor = 1e-3 * max(np.linalg.norm(g) for g in grads[0].values())
    worst = max((np.linalg.norm(grads[1][n] - grads[0][n])
                 / max(np.linalg.norm(grads[0][n]), floor), n)
                for n in grads[0])
    assert worst[0] <= grad_tol, worst


# ---------------------------------------------------------------------------
# names and shapes
# ---------------------------------------------------------------------------
def test_get_model_knows_the_reference_names():
    assert set(pvision._models) == set(rvision._models)
    assert len(pvision._models) == 34
    for name in ("VGG16", "ResNet50_v1", "Inception_V3"):
        assert type(pvision.get_model(name, prefix="n_")).__name__ == \
            type(rvision.get_model(name, prefix="n_")).__name__
    for zoo in (rvision, pvision):
        with pytest.raises(ValueError, match="not found"):
            zoo.get_model("vgg17")


@pytest.mark.parametrize("name", sorted(rvision._models))
def test_pretrained_raises_as_the_reference(name):
    raised = []
    for zoo in (rvision, pvision):
        with pytest.raises(Exception) as e:
            zoo.get_model(name, pretrained=True, prefix="n_")
        raised.append(type(e.value))
    assert raised[0] is raised[1]


@pytest.mark.parametrize("name", sorted(rvision._models))
def test_declared_parameters_match_the_reference(name):
    """Every constructor: the same parameter names in the same order,
    the same declared shapes (0 where the input decides)."""
    ref = [(n, p.shape) for n, p in _ref_params(
        rvision.get_model(name, prefix="n_"))]
    port = [(n, p.shape) for n, p in pvision.get_model(
        name, prefix="n_").collect_params().items()]
    assert port == ref


def _ref_full_shapes(net, size):
    """{port name: shape} of the reference net at (1, 3, size, size),
    from its symbols (no compute)."""
    shapes, data = {}, (1, 3, size, size)
    for i, part in enumerate(_ref_parts(net)):
        sym = part(mx.sym.var("data"))
        args, outs, aux = sym.infer_shape(data=data)
        for n, s in zip(sym.list_arguments() + sym.list_auxiliary_states(),
                        list(args) + list(aux)):
            if n != "data":
                shapes[_alexnet_name(n, i) if len(_ref_parts(net)) > 1
                       else n] = tuple(s)
        data = tuple(outs[0])
    return shapes


@pytest.mark.parametrize("name,size", FULL_SIZE)
def test_full_size_shapes_match_the_reference(name, size):
    ref = rvision.get_model(name, classes=1000, prefix="n_")
    want = _ref_full_shapes(ref, size)
    port = pvision.get_model(name, classes=1000, prefix="n_")
    port.initialize(pt.initializer.Zero(), ctx=pt.cpu())
    out = port(pt.nd.zeros((1, 3, size, size), ctx=pt.cpu()))
    assert out.shape == (1, 1000)
    got = {n: tuple(p.shape) for n, p in port.collect_params().items()}
    assert got == want


def test_alexnet_names_are_mxnet_names():
    """The port's AlexNet names its three Dense layers dense0-2 (MXNet
    1.x's names); the reference's holds dense0 twice and cannot collect
    its parameters."""
    names = list(pvision.alexnet(prefix="n_").collect_params())
    assert [n for n in names if "dense" in n] == [
        "n_dense%d_%s" % (i, k) for i in range(3) for k in ("weight", "bias")]
    with pytest.raises(ValueError, match="conflicting"):
        rvision.alexnet(prefix="n_").collect_params()


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------
def test_alexnet_matches_the_reference():
    # 63 is the least input that leaves a 1 x 1 map before the classifier
    family_parity(lambda z: z.AlexNet(classes=10, prefix="a_"),
                  (2, 3, 63, 63))


@pytest.mark.parametrize("bn", [False, True], ids=["vgg", "vgg_bn"])
def test_vgg_matches_the_reference(bn):
    # VGG's own class at one conv a stage and narrow widths: the same code
    # as vgg11-19, the classifier at its 4096 units
    family_parity(lambda z: z.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                                  classes=10, batch_norm=bn, prefix="v_"),
                  (2, 3, 32, 32))
