"""The port's NDArray methods, operators, indexing and the ops behind
them, each case run on the same numpy inputs in the port and in the
reference on the CPU (cases after the reference's own
``tests/test_ndarray.py``). Results compared in value and dtype: within
1e-6 relative (f32; exact for the integer-valued and reordering ops,
which need no rounding), and for the differentiable ops the gradient of
a weighted sum too, within 1e-5 relative."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

LIBS = ((mx, mx.cpu()), (pt, pt.cpu()))


def _x(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


X = _x()
X3 = _x((2, 3, 4), 1)
POS = np.abs(_x((3, 4), 2)) + 0.5
IDX = np.array([[0, 2], [3, -1]], np.float32)


def _arr(lib, ctx, a):
    return lib.nd.array(a, ctx=ctx)


# name -> fn(lib, ctx, arr) with arr(numpy) -> the lib's NDArray
CASES = {
    # shape and copies
    "T": lambda lib, c, A: A(X3).T,
    "transpose": lambda lib, c, A: A(X3).transpose((1, 0, 2)),
    "transpose_args": lambda lib, c, A: A(X3).transpose(2, 0, 1),
    "reshape_tuple": lambda lib, c, A: A(X3).reshape((6, 4)),
    "reshape_args": lambda lib, c, A: A(X3).reshape(4, -1),
    "reshape_0_-1": lambda lib, c, A: A(X3).reshape((0, -1)),
    "reshape_-2": lambda lib, c, A: A(X3).reshape((-2,)),
    "reshape_-3": lambda lib, c, A: A(X3).reshape((-3, 4)),
    "reshape_-4": lambda lib, c, A: A(X3).reshape((-4, 1, 2, 3, 4)),
    "reshape_reverse": lambda lib, c, A: A(X3).reshape((-1, 0),
                                                       reverse=True),
    "reshape_like": lambda lib, c, A: A(X3).reshape_like(A(_x((6, 4)))),
    "copy": lambda lib, c, A: A(X).copy(),
    "copyto_ctx": lambda lib, c, A: A(X).copyto(c),
    "copyto_array": lambda lib, c, A: A(X).copyto(A(np.zeros((3, 4)))),
    "copyto_array_dtype": lambda lib, c, A: A(X).copyto(
        A(np.zeros((2, 2))).astype("float16")),
    "as_in_ctx": lambda lib, c, A: A(X).as_in_ctx(c),
    "as_nd_ndarray": lambda lib, c, A: A(X).as_nd_ndarray(),
    "expand_dims": lambda lib, c, A: A(X).expand_dims(1),
    "squeeze": lambda lib, c, A: A(_x((3, 1, 4, 1))).squeeze(),
    "squeeze_axis": lambda lib, c, A: A(_x((3, 1, 4, 1))).squeeze(axis=1),
    "flatten": lambda lib, c, A: A(X3).flatten(),
    "tile": lambda lib, c, A: A(X).tile((2, 1, 3)),
    "broadcast_to": lambda lib, c, A: A(_x((3, 1))).broadcast_to((3, 5)),
    "broadcast_to_0": lambda lib, c, A: A(_x((3, 1))).broadcast_to((0, 5)),
    "zeros_like": lambda lib, c, A: A(X).zeros_like(),
    "ones_like": lambda lib, c, A: A(X).ones_like(),
    "nd_zeros_like": lambda lib, c, A: lib.nd.zeros_like(A(X)),
    "astype_like": lambda lib, c, A: A(X).astype_like(
        A(X).astype("float16")),
    # scalars and host
    "asscalar": lambda lib, c, A: A(np.array([2.5], np.float32)).asscalar(),
    "item": lambda lib, c, A: A(np.array([[7.0]], np.float32)).item(),
    "tolist": lambda lib, c, A: A(X).tolist(),
    "float": lambda lib, c, A: float(A(np.array([3.5], np.float32))),
    "int": lambda lib, c, A: int(A(np.array([3.5], np.float32))),
    "bool": lambda lib, c, A: bool(A(np.array([0.0], np.float32))),
    "stype": lambda lib, c, A: A(X).stype,
    # reductions and index reductions
    "max": lambda lib, c, A: A(X).max(),
    "max_axis": lambda lib, c, A: A(X3).max(axis=(0, 2), keepdims=True),
    "min_axis": lambda lib, c, A: A(X3).min(axis=1),
    "prod": lambda lib, c, A: A(POS).prod(axis=1),
    "prod_axes": lambda lib, c, A: A(X3).prod(axis=(0, 2)),
    "argmax": lambda lib, c, A: A(X).argmax(),
    "argmax_axis": lambda lib, c, A: A(X).argmax(axis=1),
    "argmin_keepdims": lambda lib, c, A: A(X).argmin(axis=0, keepdims=True),
    # elementwise methods
    "abs": lambda lib, c, A: A(X).abs(),
    "exp": lambda lib, c, A: A(X).exp(),
    "log": lambda lib, c, A: A(POS).log(),
    "sqrt": lambda lib, c, A: A(POS).sqrt(),
    "square": lambda lib, c, A: A(X).square(),
    "sigmoid": lambda lib, c, A: A(X).sigmoid(),
    "tanh": lambda lib, c, A: A(X).tanh(),
    "relu": lambda lib, c, A: A(X).relu(),
    "softmax": lambda lib, c, A: A(X).softmax(),
    "log_softmax": lambda lib, c, A: A(X).log_softmax(axis=0),
    "clip": lambda lib, c, A: A(X).clip(-0.5, 0.5),
    "__abs__": lambda lib, c, A: abs(A(X)),
    "__pow__": lambda lib, c, A: A(POS) ** 1.5,
    "__pow__array": lambda lib, c, A: A(POS) ** A(X),
    "__rpow__": lambda lib, c, A: 2.0 ** A(X),
    "__mod__": lambda lib, c, A: A(X * 3) % 1.5,
    "__mod__array": lambda lib, c, A: A(X * 3) % A(POS),
    "__rmod__": lambda lib, c, A: 2.0 % A(POS),
    # gathers
    "one_hot": lambda lib, c, A: A(np.array([0, 2, 5, -1], np.float32))
    .one_hot(4),
    "one_hot_values": lambda lib, c, A: lib.nd.one_hot(
        A(np.array([1, 3], np.float32)), depth=4, on_value=5.0,
        off_value=-1.0),
    "take_clip": lambda lib, c, A: A(X).take(A(IDX)),
    "take_wrap": lambda lib, c, A: A(X).take(A(IDX * 3), axis=1,
                                             mode="wrap"),
    "slice_axis": lambda lib, c, A: A(X3).slice_axis(2, 1, 3),
    "slice_axis_neg": lambda lib, c, A: A(X3).slice_axis(-1, -3, -1),
    "gather_nd": lambda lib, c, A: lib.nd.gather_nd(
        A(X3), A(np.array([[0, 1, 1], [2, 0, 1]], np.float32))),
    # indexing
    "index_ndarray": lambda lib, c, A: A(X)[A(np.array([2, 0], np.float32))],
    "index_list": lambda lib, c, A: A(X)[[0, 2, 2]],
    "index_none": lambda lib, c, A: A(X)[None],
    "index_int_none": lambda lib, c, A: A(X)[1, None],
    "index_ellipsis": lambda lib, c, A: A(X3)[..., 1],
    "index_ellipsis_mid": lambda lib, c, A: A(X3)[0, ..., 2],
    "index_bool_mask": lambda lib, c, A: A(X)[np.array([True, False, True])],
    "index_numpy": lambda lib, c, A: A(X)[np.array([1, 1])],
    # the ops
    "dot": lambda lib, c, A: lib.nd.dot(A(X), A(_x((4, 5), 3))),
    "dot_transpose": lambda lib, c, A: lib.nd.dot(
        A(_x((4, 3), 3)), A(_x((5, 4), 4)), transpose_a=True,
        transpose_b=True),
    "dot_3d": lambda lib, c, A: lib.nd.dot(A(X3), A(_x((4, 2), 5))),
    "dot_1d": lambda lib, c, A: lib.nd.dot(A(X[0]), A(X[1])),
    "batch_dot": lambda lib, c, A: lib.nd.batch_dot(A(X3), A(_x((2, 4, 5)))),
    "batch_dot_t": lambda lib, c, A: lib.nd.batch_dot(
        A(X3), A(_x((2, 5, 4))), transpose_b=True),
    "where": lambda lib, c, A: lib.nd.where(A((X > 0).astype(np.float32)),
                                            A(X), A(POS)),
    "slice": lambda lib, c, A: lib.nd.slice(A(X3), begin=(0, 1),
                                            end=(2, 3)),
    "slice_step": lambda lib, c, A: lib.nd.slice(
        A(X3), begin=(None, None, 3), end=(None, None, 0),
        step=(1, 2, -1)),
    "SequenceMask": lambda lib, c, A: lib.nd.SequenceMask(
        A(X3.transpose(1, 0, 2)), A(np.array([1, 3], np.float32)),
        use_sequence_length=True, value=-2.0),
    "SequenceMask_axis1": lambda lib, c, A: lib.nd.SequenceMask(
        A(X3), A(np.array([2, 1], np.float32)), use_sequence_length=True,
        axis=1),
    "topk_indices": lambda lib, c, A: lib.nd.topk(A(X), k=2),
    "topk_value_asc": lambda lib, c, A: lib.nd.topk(
        A(X), axis=0, k=2, ret_typ="value", is_ascend=True),
    "topk_both": lambda lib, c, A: lib.nd.topk(A(X3), axis=1, k=2,
                                               ret_typ="both"),
    "sort": lambda lib, c, A: lib.nd.sort(A(X)),
    "sort_desc": lambda lib, c, A: lib.nd.sort(A(X), axis=0,
                                               is_ascend=False),
    "argsort": lambda lib, c, A: lib.nd.argsort(A(X), axis=1),
    "concat": lambda lib, c, A: lib.nd.concat(A(X), A(POS), dim=0),
    "Concat": lambda lib, c, A: lib.nd.Concat(A(X), A(POS), A(X), dim=1),
    "swapaxes": lambda lib, c, A: lib.nd.swapaxes(A(X3), dim1=0, dim2=2),
    "SwapAxis": lambda lib, c, A: lib.nd.SwapAxis(A(X3), dim1=1, dim2=2),
    "split": lambda lib, c, A: lib.nd.split(A(X3), num_outputs=3, axis=1),
    "split_squeeze": lambda lib, c, A: lib.nd.split(
        A(X3), num_outputs=2, axis=0, squeeze_axis=True),
    "repeat": lambda lib, c, A: lib.nd.repeat(A(X), repeats=2, axis=1),
    "flip": lambda lib, c, A: lib.nd.flip(A(X3), axis=(0, 2)),
    "broadcast_like": lambda lib, c, A: lib.nd.broadcast_like(
        A(_x((1, 4))), A(X)),
    "broadcast_axis": lambda lib, c, A: lib.nd.broadcast_axis(
        A(_x((3, 1))), axis=1, size=4),
    "nansum": lambda lib, c, A: lib.nd.nansum(
        A(np.where(X > 1, np.nan, X).astype(np.float32)), axis=1),
    "nanprod": lambda lib, c, A: lib.nd.nanprod(
        A(np.where(X > 1, np.nan, POS).astype(np.float32))),
    "hypot": lambda lib, c, A: lib.nd.broadcast_hypot(A(X), A(POS)),
    "logical_and": lambda lib, c, A: lib.nd.broadcast_logical_and(
        A((X > 0).astype(np.float32)), A((POS > 1).astype(np.float32))),
    "elemwise_add": lambda lib, c, A: lib.nd.elemwise_add(A(X), A(POS)),
    "hard_sigmoid": lambda lib, c, A: lib.nd.hard_sigmoid(A(X * 3)),
    "softsign": lambda lib, c, A: lib.nd.softsign(A(X)),
    "softrelu": lambda lib, c, A: lib.nd.softrelu(A(X)),
    "smooth_l1": lambda lib, c, A: lib.nd.smooth_l1(A(X * 2), scalar=1.5),
    "BlockGrad": lambda lib, c, A: lib.nd.BlockGrad(A(X)),
    "leaky": lambda lib, c, A: lib.nd.LeakyReLU(A(X), slope=0.1),
    "elu": lambda lib, c, A: lib.nd.LeakyReLU(A(X), act_type="elu",
                                              slope=0.7),
    "selu": lambda lib, c, A: lib.nd.LeakyReLU(A(X), act_type="selu"),
    "gelu": lambda lib, c, A: lib.nd.LeakyReLU(A(X), act_type="gelu"),
    "rrelu": lambda lib, c, A: lib.nd.LeakyReLU(A(X), act_type="rrelu"),
    "prelu": lambda lib, c, A: lib.nd.LeakyReLU(
        A(_x((2, 3, 4))), A(np.array([0.1, 0.2, 0.3], np.float32)),
        act_type="prelu"),
    "concatenate": lambda lib, c, A: lib.nd.concatenate([A(X), A(POS)]),
    "stack_list": lambda lib, c, A: lib.nd.stack_list([A(X), A(POS)],
                                                      axis=1),
    "moveaxis": lambda lib, c, A: lib.nd.moveaxis(A(X3), 0, 2),
}


def _np(v):
    if isinstance(v, (tuple, list)) and v and hasattr(v[0], "asnumpy"):
        return [(x.asnumpy(), x.dtype) for x in v]
    if hasattr(v, "asnumpy"):
        return [(v.asnumpy(), v.dtype)]
    return [(v, type(v))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_matches_reference(case):
    got = []
    for lib, ctx in LIBS:
        got.append(_np(CASES[case](lib, ctx,
                                   lambda a, lib=lib, ctx=ctx:
                                   _arr(lib, ctx, a))))
    ref, port = got
    assert len(port) == len(ref)
    for (p, pdt), (r, rdt) in zip(port, ref):
        if isinstance(r, np.ndarray):
            assert p.shape == r.shape
            assert pdt == rdt
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7)
        else:
            assert p == r and pdt == rdt


# name -> fn(lib, x) over one differentiable input x
GRAD_CASES = {
    "dot": lambda lib, x: lib.nd.dot(x, x, transpose_b=True),
    "batch_dot": lambda lib, x: lib.nd.batch_dot(
        x.reshape((3, 2, 2)), x.reshape((3, 2, 2)), transpose_a=True),
    "take": lambda lib, x: x.take(lib.nd.array(IDX, ctx=x.context)),
    "where": lambda lib, x: lib.nd.where(x > 0, x * 2, x * x),
    "slice": lambda lib, x: lib.nd.slice(x, begin=(1, 0), end=(3, 3)),
    "concat_split": lambda lib, x: lib.nd.split(
        lib.nd.concat(x, x * 3, dim=1), num_outputs=2, axis=1)[1],
    "SequenceMask": lambda lib, x: lib.nd.SequenceMask(
        x, lib.nd.array(np.array([1, 2, 3, 0], np.float32), ctx=x.context),
        use_sequence_length=True),
    "max": lambda lib, x: x.max(axis=1),
    "prod": lambda lib, x: x.prod(axis=0),
    "clip": lambda lib, x: x.clip(-0.5, 0.5),
    "pow": lambda lib, x: x ** 2 + 2.0 ** x,
    "topk_value": lambda lib, x: lib.nd.topk(x, k=2, ret_typ="value"),
    "softmax": lambda lib, x: x.softmax(axis=0),
    "elu": lambda lib, x: lib.nd.LeakyReLU(x, act_type="elu"),
    "selu": lambda lib, x: lib.nd.LeakyReLU(x, act_type="selu"),
    "gelu": lambda lib, x: lib.nd.LeakyReLU(x, act_type="gelu"),
    "index_ndarray": lambda lib, x: x[lib.nd.array(
        np.array([2, 0, 2], np.float32), ctx=x.context)],
    "setitem": lambda lib, x: _set_row(x),
}


def _set_row(x):
    y = x * 2.0
    y[1] = x[0] * 3.0
    return y


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradient_matches_reference(case):
    vals = []
    for lib, ctx in LIBS:
        x = lib.nd.array(X, ctx=ctx)
        x.attach_grad()
        with lib.autograd.record():
            out = GRAD_CASES[case](lib, x)
            g = lib.nd.array(_x(out.shape, 7), ctx=ctx)
            loss = (out * g).sum()
        loss.backward()
        vals.append((out.asnumpy(), x.grad.asnumpy()))
    for p, r in zip(vals[1], vals[0]):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def test_setitem_and_views_write_through():
    """The reference's ``test_setitem`` and ``test_indexing_views``."""
    got = []
    for lib, ctx in LIBS:
        a = lib.nd.zeros((3, 3), ctx=ctx)
        a[1, 1] = 7.0
        a[0] = np.array([1, 2, 3])
        a[2] = lib.nd.array([4, 5, 6], ctx=ctx)
        a[:, 2] = 0.5
        a[lib.nd.array([0, 2], ctx=ctx)] = -1.0
        b = lib.nd.array(np.arange(12).reshape(3, 4), ctx=ctx)
        v = b[1]
        v[:] = 0
        s = b[0:2]
        s[:] = s + 10
        vv = b[0:2][1]
        vv[:] = 5.0
        got.append((a.asnumpy(), b.asnumpy()))
    for p, r in zip(got[1], got[0]):
        np.testing.assert_array_equal(p, r)


def test_waitall_num_gpus_and_pinned_context():
    """``nd.waitall``/``mx.waitall`` return once the queue is empty;
    ``num_gpus`` counts the cards torch sees; a ``cpu_pinned`` array is
    host memory (page-locked where a card exists) with its own context."""
    a = pt.nd.ones((8, 8), ctx=pt.cpu())
    for _ in range(5):
        a = a * 1.5
    pt.nd.waitall()
    pt.waitall()
    assert a.asnumpy()[0, 0] == pytest.approx(1.5 ** 5)
    import torch
    assert pt.num_gpus() == torch.cuda.device_count()
    ctx = pt.cpu_pinned()
    assert ctx.device_type == "cpu_pinned" and ctx.devtype2id[
        "cpu_pinned"] == mx.cpu_pinned().devtype2id["cpu_pinned"]
    p = pt.nd.array(X, ctx=ctx)
    assert p.context == ctx and p.tensor().device.type == "cpu"
    np.testing.assert_array_equal(p.asnumpy(), X)
    np.testing.assert_array_equal(
        pt.nd.array(X, ctx=pt.cpu()).as_in_context(ctx).asnumpy(), X)
