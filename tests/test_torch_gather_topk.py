"""``nd.gather_nd`` with indices out of range and ``nd.topk`` with
``axis=None``, on the CPU with the same numpy inputs in both packages.

``gather_nd`` is held to the reference exactly (a gather moves values):
a negative index on an axis of n gets n added, then every index is
clamped to [0, n - 1], for index tuples over one, two and three axes.
``topk(axis=None)`` takes MXNet 1.x's form, the top k of the flattened
array with shape (k,), which the port's ``sort`` and ``argsort`` take
too; the reference drops the ``None`` and answers along the last axis, a
gap kept on purpose and pinned here."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

LIBS = ((mx, mx.cpu()), (pt, pt.cpu()))


def _data(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (data shape, indices): in range, negative, below -n and at or past n
GATHER_CASES = {
    "probe": ((3, 4), [[3, -1, -5], [0, 4, 1]]),
    "one_axis": ((5, 3), [[0, 4, -1, -5, -6, 5, 9, -100]]),
    "two_axes": ((3, 4, 2), [[0, 2, -3, -4, 3, 7, -1],
                             [3, -4, 0, 4, -5, 1, -1]]),
    "three_axes": ((2, 3, 4), [[1, -1, -3, 2, 0, 5],
                               [2, 0, -4, -1, 3, 1],
                               [3, -2, 4, -5, 0, -1]]),
    "nested": ((4, 3), [[[0, -1], [5, -5]], [[2, 3], [-4, 7]]]),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_nd_clamps_as_the_reference(case):
    shape, indices = GATHER_CASES[case]
    x = _data(shape)
    idx = np.array(indices, dtype=np.float32)
    got = [lib.nd.gather_nd(lib.nd.array(x, ctx=ctx),
                            lib.nd.array(idx, ctx=ctx)).asnumpy()
           for lib, ctx in LIBS]
    np.testing.assert_array_equal(got[1], got[0])


def test_gather_nd_probe_values():
    """The indices [[3, -1, -5], [0, 4, 1]] on arange(12).reshape(3, 4):
    rows 2, 2, 0 and columns 0, 3, 1."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = pt.nd.array([[3, -1, -5], [0, 4, 1]], ctx=pt.cpu())
    np.testing.assert_array_equal(
        pt.nd.gather_nd(pt.nd.array(x, ctx=pt.cpu()), idx).asnumpy(),
        [8, 11, 1])


@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("ret_typ", ["value", "indices", "both"])
def test_topk_axis_none_flattens(ret_typ, is_ascend):
    """Shape (k,), the k largest (smallest) of all elements in order, and
    indices that are positions in the flattened array."""
    x = _data((3, 4, 5))
    flat = x.reshape(-1)
    order = np.argsort(flat if is_ascend else -flat, kind="stable")[:3]
    out = pt.nd.topk(pt.nd.array(x, ctx=pt.cpu()), axis=None, k=3,
                     ret_typ=ret_typ, is_ascend=is_ascend)
    outs = out if ret_typ == "both" else (out,)
    for o in outs:
        assert o.shape == (3,)
    if ret_typ in ("value", "both"):
        np.testing.assert_array_equal(outs[0].asnumpy(), flat[order])
    if ret_typ in ("indices", "both"):
        ids = outs[-1].asnumpy()
        assert ids.dtype == np.float32
        np.testing.assert_array_equal(ids, order.astype(np.float32))


@pytest.mark.parametrize("ret_typ", ["value", "indices"])
def test_topk_axis_none_differs_from_the_reference(ret_typ):
    """The kept gap: the reference answers along the last axis (shape
    (3, 4, 3)), where the port, as MXNet 1.x, flattens (shape (3,)).
    Along the last axis the two agree."""
    x = _data((3, 4, 5))
    ref = mx.nd.topk(mx.nd.array(x, ctx=mx.cpu()), axis=None, k=3,
                     ret_typ=ret_typ).asnumpy()
    got = pt.nd.topk(pt.nd.array(x, ctx=pt.cpu()), axis=None, k=3,
                     ret_typ=ret_typ).asnumpy()
    assert ref.shape == (3, 4, 3) and got.shape == (3,)
    last = pt.nd.topk(pt.nd.array(x, ctx=pt.cpu()), axis=-1, k=3,
                      ret_typ=ret_typ).asnumpy()
    np.testing.assert_array_equal(last, ref)
