"""The port's ``ops/tensor_tail.py`` against the reference's on the CPU:
all 37 names (``add_n``, the same-shape binaries and comparisons, the
scalar tail, ``rcbrt``, ``relu6``, ``reverse``, ``diag``, the ravel
pair, ``_split_v2``, ``cast_storage``, the scatter-writes,
``index_array``, ``moments``, the masked softmaxes and the legacy
layers), with the aliases, mirroring the reference's
``tests/test_operator_tail.py``.

The same numpy inputs from seeded generators go through ``mx.nd`` and
``pt.nd``; outputs by dtype, shape and value, and gradients through each
package's autograd (a fixed random head on every output) wherever the
reference differentiates. f32 within 1e-5 relative and 1e-6 absolute:
the math is the same, only the order of f32 sums may differ.

:func:`parity` and :func:`run_op` are shared by
``test_torch_matrix_linalg.py`` and ``test_torch_vision_ops.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.ops as port_ops

RTOL, ATOL = 1e-5, 1e-6
LIBS = {"ref": (mx, mx.cpu()), "port": (pt, pt.cpu())}


def _r(*shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _head(shape, k):
    """The fixed head gradient of output k."""
    rs = np.random.RandomState(1000 + k)
    return rs.uniform(0.5, 1.5, shape).astype(np.float32)


def run_op(which, name, inputs, attrs=None, grad=()):
    """``nd.<name>(*inputs, **attrs)`` in one package on its CPU; returns
    (outputs, gradients of the inputs listed in ``grad``) as numpy."""
    lib, ctx = LIBS[which]
    arrays = [lib.nd.array(a, ctx=ctx, dtype=a.dtype) for a in inputs]
    for i in grad:
        arrays[i].attach_grad()
    with lib.autograd.record():
        out = getattr(lib.nd, name)(*arrays, **(attrs or {}))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        total = None
        if grad:
            for k, o in enumerate(outs):
                if not np.issubdtype(np.dtype(o.dtype), np.floating):
                    continue
                w = lib.nd.array(_head(o.shape, k), ctx=ctx, dtype=o.dtype)
                term = (o * w).sum()
                total = term if total is None else total + term
    if grad:
        total.backward()
    return ([o.asnumpy() for o in outs],
            [arrays[i].grad.asnumpy() for i in grad])


def parity(name, inputs, attrs=None, grad=(), rtol=RTOL, atol=ATOL,
           grad_rtol=None, grad_atol=None):
    """The port's outputs and gradients against the reference's; returns
    the port's outputs."""
    ref_out, ref_grad = run_op("ref", name, inputs, attrs, grad)
    out, g = run_op("port", name, inputs, attrs, grad)
    assert len(out) == len(ref_out), name
    for o, r in zip(out, ref_out):
        assert o.dtype == r.dtype, (name, o.dtype, r.dtype)
        assert o.shape == r.shape, (name, o.shape, r.shape)
        np.testing.assert_allclose(o, r, rtol=rtol, atol=atol, err_msg=name)
    for o, r in zip(g, ref_grad):
        np.testing.assert_allclose(
            o, r, rtol=grad_rtol if grad_rtol is not None else rtol,
            atol=grad_atol if grad_atol is not None else atol,
            err_msg=name + " gradient")
    return out


# ---------------------------------------------------------------------------
# add_n / same-shape binaries / the scalar tail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["add_n", "ElementWiseSum", "_sum_of"])
def test_add_n(name):
    xs = [_r(3, 4, seed=i) for i in range(4)]
    parity(name, xs, grad=(0, 1, 2, 3))


BINARIES = [
    ("_maximum", _r(3, 4, seed=1), _r(3, 4, seed=2)),
    ("_minimum", _r(3, 4, seed=1), _r(3, 4, seed=2)),
    ("_power", np.abs(_r(3, 4, seed=1)) + 0.5, _r(3, 4, seed=2)),
    ("_hypot", _r(3, 4, seed=1), _r(3, 4, seed=2)),
    ("_mod", _r(3, 4, seed=1), np.abs(_r(3, 4, seed=2)) + 0.5),
]


@pytest.mark.parametrize("name,a,b", BINARIES,
                         ids=[c[0] for c in BINARIES])
def test_strict_binary(name, a, b):
    parity(name, [a, b], grad=(0, 1))
    for which in LIBS:
        with pytest.raises(Exception):
            run_op(which, name, [np.ones((2, 3), np.float32),
                                 np.ones((3, 2), np.float32)])


CMPS = ["_equal", "_not_equal", "_greater", "_greater_equal", "_lesser",
        "_lesser_equal", "_logical_and", "_logical_or", "_logical_xor"]


@pytest.mark.parametrize("name", CMPS)
def test_strict_comparison(name):
    """0/1 in the lhs's dtype; identical shapes only."""
    a = np.round(_r(3, 4, seed=3))
    b = np.round(_r(3, 4, seed=4))
    parity(name, [a, b])
    parity(name, [a.astype(np.int32), b.astype(np.int32)])
    with pytest.raises(ValueError):
        run_op("port", name, [a, b[:2]])


@pytest.mark.parametrize("name,scalar", [
    ("_hypot_scalar", 2.0), ("_logical_and_scalar", 1.0),
    ("_logical_or_scalar", 0.0), ("_logical_xor_scalar", 1.0)])
def test_scalar_tail(name, scalar):
    a = np.round(_r(3, 4, seed=5)) if "logical" in name else _r(3, 4, seed=5)
    parity(name, [a], {"scalar": scalar},
           grad=(0,) if name == "_hypot_scalar" else ())


def test_unary_tail():
    a = _r(3, 4, lo=0.5, hi=2.0, seed=6)
    parity("rcbrt", [a], grad=(0,))
    parity("rcbrt", [-a], grad=(0,))
    # away from the kinks at 0 and 6
    b = np.where(np.abs(a * 5 - 6) < 0.05, 3.0, a * 5).astype(np.float32)
    parity("relu6", [b - 2.0], grad=(0,))


# ---------------------------------------------------------------------------
# reverse / diag / ravel / split_v2 / cast_storage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [1, (0, 2), -1])
def test_reverse(axis):
    parity("reverse", [_r(2, 3, 4, seed=7)], {"axis": axis}, grad=(0,))


def test_reverse_is_its_own_op():
    """The reference registers ``reverse`` as an op of its own besides
    ``flip``'s alias; the registries agree on its name."""
    assert port_ops.get_op("reverse").name == "reverse"
    assert mx.ops.get_op("reverse").name == "reverse"
    assert port_ops.get_op("flip").name == "flip"


@pytest.mark.parametrize("shape,attrs", [
    ((5,), {}), ((5,), {"k": 1}), ((5,), {"k": -2}),
    ((4, 5), {}), ((4, 5), {"k": -1}), ((4, 5), {"k": 2}),
    ((2, 3, 4), {"axis1": 1, "axis2": 2}),
    ((2, 3, 4), {"k": 1, "axis1": 0, "axis2": 2})])
def test_diag(shape, attrs):
    parity("diag", [_r(*shape, seed=8)], attrs, grad=(0,))


@pytest.mark.parametrize("name", ["_ravel_multi_index", "ravel_multi_index"])
def test_ravel(name):
    shape = (3, 4, 5)
    flat = np.array([0, 7, 23, 59, 31], np.int64)
    coords = np.stack(np.unravel_index(flat, shape)).astype(np.float32)
    out = parity(name, [coords], {"shape": shape})
    np.testing.assert_array_equal(out[0], flat)


@pytest.mark.parametrize("name", ["_unravel_index", "unravel_index"])
def test_unravel(name):
    shape = (3, 4, 5)
    flat = np.array([0, 7, 23, 59, 31], np.float32)
    out = parity(name, [flat], {"shape": shape})
    np.testing.assert_array_equal(out[0], np.stack(np.unravel_index(
        flat.astype(np.int64), shape)))
    parity(name, [flat.astype(np.int32)], {"shape": shape})


@pytest.mark.parametrize("attrs", [
    {"sections": 3}, {"indices": (1, 3), "axis": 0},
    {"sections": 6, "squeeze_axis": True},
    {"indices": (2,), "axis": 1}, {"sections": 2, "axis": -1}])
def test_split_v2(attrs):
    parity("_split_v2", [_r(6, 4, seed=10)], attrs, grad=(0,))
    parity("split_v2", [_r(6, 4, seed=10)], attrs)


def test_cast_storage_dense():
    parity("cast_storage", [_r(3, 3, seed=11)], {"stype": "default"},
           grad=(0,))


# ---------------------------------------------------------------------------
# scatter-writes and index ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("idx", [[[1, 3], [0, 2]], [[-1, 0], [2, -3]],
                                 [[1], [1]]])
def test_scatter_set_nd(idx):
    lhs = _r(4, 3, seed=12)
    ind = np.array(idx, np.float32)
    rhs = _r(ind.shape[1], seed=13)
    parity("_scatter_set_nd", [lhs, rhs, ind], {"shape": (4, 3)},
           grad=(0, 1))


def test_scatter_set_nd_rows():
    """A partial index writes whole rows."""
    lhs = _r(4, 3, seed=14)
    ind = np.array([[0, 2]], np.float32)
    parity("_scatter_set_nd", [lhs, _r(2, 3, seed=15), ind], grad=(0, 1))


def test_index_copy():
    old = _r(5, 3, seed=16)
    new = _r(2, 3, seed=17)
    for idx in ([1, 3], [4, 0]):
        parity("_contrib_index_copy", [old, np.array(idx, np.float32), new],
               grad=(0, 2))


@pytest.mark.parametrize("name", ["_contrib_index_array", "index_array"])
@pytest.mark.parametrize("axes", [None, (1,), (2, 0)])
def test_index_array(name, axes):
    attrs = {} if axes is None else {"axes": axes}
    parity(name, [np.ones((2, 3, 4), np.float32)], attrs)


# ---------------------------------------------------------------------------
# moments / masked softmax family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attrs", [{"axes": (0,)}, {"axes": (0, 1),
                                                    "keepdims": True},
                                   {"axes": (1, 2)}, {}])
def test_moments(attrs):
    parity("moments", [_r(4, 5, 3, seed=18)], attrs, grad=(0,))


def _mask(lengths, n):
    return (np.arange(n)[None, :] < np.array(lengths)[:, None]).astype(
        np.float32)


@pytest.mark.parametrize("attrs", [{}, {"temperature": 2.5},
                                   {"axis": 0}])
def test_masked_softmax(attrs):
    x = _r(4, 5, seed=19)
    mask = _mask([2, 5, 3, 1], 5)
    if attrs.get("axis") == 0:
        mask = _mask([1, 4, 2, 3, 4], 4).T.copy()
    out = parity("masked_softmax", [x, mask], attrs, grad=(0,))
    assert (out[0][mask == 0] == 0).all()
    lout = parity("masked_log_softmax", [x, mask], attrs, grad=(0,))
    assert np.isneginf(lout[0][mask == 0]).all()


def test_masked_softmax_fully_masked_row():
    """A row with nothing to attend to gives zeros (log: -inf)."""
    x = _r(2, 4, seed=20)
    mask = _mask([0, 3], 4)
    parity("masked_softmax", [x, mask], grad=(0,))
    parity("masked_log_softmax", [x, mask])


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation(mode):
    parity("SoftmaxActivation", [_r(2, 3, 4, seed=21)], {"mode": mode},
           grad=(0,))


def test_svm_output_and_kl_reg_pass_the_gradient_through():
    """Gap kept on purpose (ROADMAP.md queue 3): both are the identity
    in the reference, gradient included; MXNet 1.x adds a hinge and a KL
    term to the gradient."""
    a = _r(2, 3, seed=22)
    parity("SVMOutput", [a, np.zeros(2, np.float32)], grad=(0,))
    out, g = run_op("port", "SVMOutput", [a, np.zeros(2, np.float32)],
                    grad=(0,))
    np.testing.assert_array_equal(g[0], _head(a.shape, 0))
    b = _r(2, 3, 4, seed=23)
    parity("IdentityAttachKLSparseReg", [b], {"penalty": 0.01}, grad=(0,))
    out, g = run_op("port", "IdentityAttachKLSparseReg", [b], grad=(0,))
    np.testing.assert_array_equal(g[0], _head(b.shape, 0))


@pytest.mark.parametrize("args", [
    ({"offset": (1, 2), "h_w": (3, 4), "num_args": 1}, False),
    ({"num_args": 2, "center_crop": True}, True),
    ({"num_args": 2, "offset": (2, 1)}, True)])
def test_crop(args):
    attrs, like = args
    a = _r(1, 2, 6, 8, seed=24)
    inputs = [a] + ([np.zeros((1, 2, 2, 3), np.float32)] if like else [])
    parity("Crop", inputs, attrs, grad=(0,))


@pytest.mark.parametrize("alias,target", [
    ("SwapAxis", "swapaxes"), ("SliceChannel", "split"),
    ("BatchNorm_v1", "BatchNorm"), ("Convolution_v1", "Convolution"),
    ("Pooling_v1", "Pooling"), ("MakeLoss", "make_loss")])
def test_legacy_aliases(alias, target):
    assert port_ops.get_op(alias).name == mx.ops.get_op(alias).name == target
