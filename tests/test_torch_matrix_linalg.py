"""The rest of the port's ``ops/matrix.py`` (33 names: ``L2Normalization``,
``shape_array``/``size_array``, ``_view_index``/``_slice_assign``,
``Pad``, ``scatter_nd``, the sequence ops, ``depth_to_space``/
``space_to_depth``, ``batch_take``, ``UpSampling``, ``khatri_rao``,
``im2col``/``col2im`` and the 17 ``linalg_*`` with their ``_linalg_*``
aliases) and the five contrib ops (the encoder-decoder attention
products, ``div_sqrt_dim``, ``arange_like``, ``boolean_mask``) against
the reference on the CPU, mirroring the matching parts of the
reference's ``tests/test_operator.py`` and ``tests/test_operator_tail.py``.

Values and gradients within 1e-5 relative and 1e-6 absolute where the
math is the same. The linalg factorisations run LAPACK in both packages
but not the same routines in the same order: values within 1e-4
relative and 1e-5 absolute on well-conditioned (4, 4) matrices (f32
condition numbers below 30), their gradients within 1e-3 relative and
1e-4 absolute (the backward formulas of a factorisation differ between
torch and JAX in their order of f32 products). ``syevd``'s eigenvectors
and ``gelqf``'s Q take the same signs in both packages on the CPU here,
so they are compared by value. The gaps kept on purpose (``gelqf``'s
output order, ``SequenceLast(axis=1)``, ``arange_like``'s ``repeat``,
``boolean_mask`` in a hybridized call) are pinned below.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.ops as port_ops
from mxnet_tpu.ndarray.ndarray import _encode_index
from mxnet_tpu_torch.base import MXNetError

from test_torch_tensor_tail import _r, parity, run_op

LA_RTOL, LA_ATOL = 1e-4, 1e-5
LA_GRAD_RTOL, LA_GRAD_ATOL = 1e-3, 1e-4


# ---------------------------------------------------------------------------
# layout, index and sequence ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["L2Normalization", "l2normalization"])
@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(name, mode):
    parity(name, [_r(2, 3, 4, 5, seed=1)], {"mode": mode}, grad=(0,))


@pytest.mark.parametrize("shape", [(2, 3, 4), (5,), ()])
def test_shape_and_size_array(shape):
    """int32, the reference's dtype."""
    x = np.ones(shape, np.float32)
    for name in ("shape_array", "size_array"):
        out = parity(name, [x])
        assert out[0].dtype == np.int32


INDEXES = [(1, slice(0, 3)), (slice(None, None, -1),),
           (None, slice(1, None, 2)), (-1, slice(3, 0, -2)),
           (slice(None), 2, None), (slice(4, None, -3), slice(None, 2))]


@pytest.mark.parametrize("key", range(len(INDEXES)))
def test_view_index(key):
    parity("_view_index", [_r(4, 5, seed=2)],
           {"index": _encode_index(INDEXES[key])}, grad=(0,))


@pytest.mark.parametrize("key", range(len(INDEXES)))
def test_slice_assign(key):
    """d(data) is zero in the assigned region, d(val) the region's."""
    data = _r(4, 5, seed=3)
    region = data[INDEXES[key]]
    val = _r(*region.shape, seed=4) if region.shape else _r(1, seed=4)[0:1]
    if not region.shape:
        val = val.reshape(())
    parity("_slice_assign", [data, val],
           {"index": _encode_index(INDEXES[key])}, grad=(0, 1))


@pytest.mark.parametrize("name", ["Pad", "pad"])
@pytest.mark.parametrize("mode,value", [("constant", 0.0), ("constant", 1.5),
                                        ("edge", 0.0), ("reflect", 0.0)])
def test_pad(name, mode, value):
    parity(name, [_r(1, 2, 4, 5, seed=5)],
           {"mode": mode, "pad_width": (0, 0, 0, 0, 1, 2, 3, 1),
            "constant_value": value}, grad=(0,))


def test_pad_every_axis():
    parity("Pad", [_r(2, 3, 4, seed=6)],
           {"mode": "constant", "pad_width": (1, 0, 0, 2, 2, 1)}, grad=(0,))


@pytest.mark.parametrize("idx,shape,dshape", [
    ([[0, 2], [1, 0]], (3, 2), (2,)),
    ([[1, 3]], (4, 3), (2, 3)),
    ([[-1, 0], [2, -2]], (3, 4), (2,))])
def test_scatter_nd(idx, shape, dshape):
    parity("scatter_nd", [_r(*dshape, seed=7), np.array(idx, np.float32)],
           {"shape": shape}, grad=(0,))


@pytest.mark.parametrize("name", ["SequenceLast", "sequencelast",
                                  "SequenceReverse", "sequencereverse"])
@pytest.mark.parametrize("lengths", [None, [2, 5, 1], [5, 0, 3]])
def test_sequence_ops(name, lengths):
    x = _r(5, 3, 2, seed=8)
    if lengths is None:
        parity(name, [x], grad=(0,))
        parity(name, [x], {"axis": 1} if "last" in name.lower() else {},
               grad=(0,))
        return
    parity(name, [x, np.array(lengths, np.float32)],
           {"use_sequence_length": True}, grad=(0,))


def test_sequence_last_axis_one_gap():
    """Found in the reference (ROADMAP.md queue 3): with lengths and
    axis=1 its take_along_axis indexes the wrong axis and it raises. The
    port takes each sequence's last valid step, as MXNet 1.x does."""
    x = _r(3, 5, 2, seed=9)
    lens = np.array([2, 5, 1], np.float32)
    with pytest.raises(ValueError):
        run_op("ref", "SequenceLast", [x, lens],
               {"use_sequence_length": True, "axis": 1})
    out, _ = run_op("port", "SequenceLast", [x, lens],
                    {"use_sequence_length": True, "axis": 1})
    np.testing.assert_array_equal(out[0], x[[0, 1, 2], [1, 4, 0]])


@pytest.mark.parametrize("block", [2, 3])
def test_depth_space(block):
    x = _r(2, 2 * block * block, 3, 4, seed=10)
    y = parity("depth_to_space", [x], {"block_size": block}, grad=(0,))
    parity("space_to_depth", [y[0]], {"block_size": block}, grad=(0,))


@pytest.mark.parametrize("idx", [[1, 3, 0], [5, -1, 2]])
def test_batch_take(idx):
    parity("batch_take", [_r(3, 4, seed=11), np.array(idx, np.float32)],
           grad=(0,))


@pytest.mark.parametrize("name", ["UpSampling", "upsampling"])
@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_nearest(name, scale):
    parity(name, [_r(2, 3, 4, 5, seed=12)], {"scale": scale}, grad=(0,))


def test_upsampling_nearest_multi_input():
    parity("UpSampling", [_r(1, 2, 4, 4, seed=13), _r(1, 3, 2, 2, seed=14)],
           {"scale": 2, "num_args": 2}, grad=(0, 1))


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_bilinear(scale):
    """The grouped Deconvolution, the second input its weight."""
    k = 2 * scale - scale % 2
    parity("UpSampling", [_r(2, 3, 4, 5, seed=15), _r(3, 1, k, k, seed=16)],
           {"scale": scale, "sample_type": "bilinear", "num_args": 2,
            "num_filter": 3}, grad=(0, 1))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_khatri_rao(n):
    arrays = [_r(r, 2, seed=17 + r) for r in (3, 4, 2)[:n]]
    parity("khatri_rao", arrays, grad=tuple(range(n)))


IM2COL = [((3, 2), (1, 1), (1, 1), (0, 0), (2, 3, 6, 7)),
          ((3, 2), (2, 2), (1, 1), (1, 1), (2, 3, 6, 7)),
          ((3, 2), (1, 2), (2, 1), (1, 0), (2, 3, 6, 7)),
          ((3,), (2,), (1,), (1,), (2, 3, 9)),
          ((2, 2, 2), (1, 2, 1), (1, 1, 2), (0, 1, 1), (1, 2, 4, 5, 5))]


@pytest.mark.parametrize("case", range(len(IM2COL)))
def test_im2col_col2im(case):
    kernel, stride, dilate, pad, shape = IM2COL[case]
    attrs = {"kernel": kernel, "stride": stride, "dilate": dilate,
             "pad": pad}
    cols = parity("im2col", [_r(*shape, seed=20)], attrs, grad=(0,))
    parity("col2im", [_r(*cols[0].shape, seed=21)],
           dict(attrs, output_size=shape[2:]), grad=(0,))


def test_view_ops_resolve_to_their_names():
    for n in ("Pad", "SequenceLast", "SequenceReverse", "UpSampling",
              "L2Normalization"):
        assert port_ops.get_op(n.lower()).name == n


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------
def _spd(seed, n=4, batch=(3,)):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-1, 1, batch + (n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


def _lower(seed, n=4, batch=(3,)):
    rs = np.random.RandomState(seed)
    a = np.tril(rs.uniform(-1, 1, batch + (n, n))) + 2 * np.eye(n)
    return a.astype(np.float32)


def _la(name, inputs, attrs=None, grad=()):
    return parity(name, inputs, attrs, grad=grad, rtol=LA_RTOL,
                  atol=LA_ATOL, grad_rtol=LA_GRAD_RTOL,
                  grad_atol=LA_GRAD_ATOL)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_linalg_gemm(ta, tb):
    A, B, C = _r(3, 4, 5, seed=30), _r(3, 5, 2, seed=31), _r(3, 4, 2, seed=32)
    a = np.swapaxes(A, -1, -2).copy() if ta else A
    b = np.swapaxes(B, -1, -2).copy() if tb else B
    attrs = {"transpose_a": ta, "transpose_b": tb, "alpha": 2.0}
    parity("linalg_gemm", [a, b, C], dict(attrs, beta=0.5), grad=(0, 1, 2))
    parity("linalg_gemm2", [a, b], attrs, grad=(0, 1))
    with pytest.raises(NotImplementedError):
        run_op("port", "linalg_gemm", [a, b, C], dict(attrs, axis=-2))


def test_linalg_cholesky_family():
    spd = _spd(33)
    _la("linalg_potrf", [spd], grad=(0,))
    L = _lower(34)
    _la("linalg_potri", [L], grad=(0,))


def test_linalg_potrf_not_positive_definite_is_nan():
    """The reference's factor of a matrix that is not positive definite
    is NaN in its lower triangle; so is the port's (no status read on
    the host)."""
    bad = np.concatenate([-_spd(35, batch=(1,)), _spd(36, batch=(1,))])
    out = parity("linalg_potrf", [bad], rtol=LA_RTOL, atol=LA_ATOL)
    assert np.isnan(out[0][0][np.tril_indices(4)]).all()
    assert np.isfinite(out[0][1]).all()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rightside", [False, True])
@pytest.mark.parametrize("lower", [False, True])
def test_linalg_trsm_trmm(transpose, rightside, lower):
    A = _lower(36)
    if not lower:
        A = np.swapaxes(A, -1, -2).copy()
    # a junk opposite triangle is ignored by both ops
    A = A + (np.triu(np.ones((4, 4)), 1) if lower
             else np.tril(np.ones((4, 4)), -1)).astype(np.float32) * 0.3
    B = _r(3, 4, 3, seed=37) if not rightside else _r(3, 3, 4, seed=37)
    attrs = {"transpose": transpose, "rightside": rightside,
             "lower": lower, "alpha": 1.5}
    _la("linalg_trsm", [np.tril(A) if lower else np.triu(A), B], attrs,
        grad=(0, 1))
    _la("linalg_trmm", [A, B], attrs, grad=(0, 1))


@pytest.mark.parametrize("transpose", [False, True])
def test_linalg_syrk(transpose):
    parity("linalg_syrk", [_r(3, 4, 5, seed=38)],
           {"transpose": transpose, "alpha": 0.7}, grad=(0,))


def test_linalg_gelqf_order_gap():
    """Gap kept on purpose (ROADMAP.md queue 3): the port returns MXNet
    1.x's documented order, ``Q, L = gelqf(A)``; the reference returns
    (L, Q). The factors themselves agree, signs included."""
    A = _r(3, 3, 5, seed=39)
    (l_ref, q_ref), _ = run_op("ref", "linalg_gelqf", [A])
    (q, l), _ = run_op("port", "linalg_gelqf", [A])
    np.testing.assert_allclose(q, q_ref, rtol=LA_RTOL, atol=LA_ATOL)
    np.testing.assert_allclose(l, l_ref, rtol=LA_RTOL, atol=LA_ATOL)
    np.testing.assert_allclose(l @ q, A, rtol=LA_RTOL, atol=LA_ATOL)
    np.testing.assert_allclose(q @ np.swapaxes(q, -1, -2),
                               np.broadcast_to(np.eye(3), (3, 3, 3)),
                               atol=LA_ATOL)
    # gradients, each factor's head matched to its own output
    lib_grads = {}
    for which, order in (("ref", ("l", "q")), ("port", ("q", "l"))):
        lib, ctx = {"ref": (mx, mx.cpu()), "port": (pt, pt.cpu())}[which]
        a = lib.nd.array(A, ctx=ctx)
        a.attach_grad()
        heads = {"l": _r(3, 3, 3, seed=40), "q": _r(3, 3, 5, seed=41)}
        with lib.autograd.record():
            outs = dict(zip(order, lib.nd.linalg_gelqf(a)))
            total = (outs["l"] * lib.nd.array(heads["l"], ctx=ctx)).sum() + \
                (outs["q"] * lib.nd.array(heads["q"], ctx=ctx)).sum()
        total.backward()
        lib_grads[which] = a.grad.asnumpy()
    np.testing.assert_allclose(lib_grads["port"], lib_grads["ref"],
                               rtol=LA_GRAD_RTOL, atol=LA_GRAD_ATOL)


def test_linalg_syevd():
    """Eigenvalues ascending; the eigenvector rows take the reference's
    signs on the CPU (both run LAPACK's syevd)."""
    spd = _spd(42)
    U, lam = _la("linalg_syevd", [spd])
    recon = np.swapaxes(U, -1, -2) @ (lam[..., None] * U)
    np.testing.assert_allclose(recon, spd, rtol=LA_RTOL, atol=1e-4)
    # the eigenvalues' gradient (unique up to nothing)
    _, g_ref = run_op("ref", "linalg_syevd", [spd], grad=(0,))
    _, g = run_op("port", "linalg_syevd", [spd], grad=(0,))
    np.testing.assert_allclose(g[0], g_ref[0], rtol=LA_GRAD_RTOL,
                               atol=LA_GRAD_ATOL)


@pytest.mark.parametrize("name", ["linalg_det", "linalg_slogdet",
                                  "linalg_inverse", "linalg_sumlogdiag"])
def test_linalg_reductions(name):
    _la(name, [_spd(43)], grad=(0,))


def test_linalg_det_signs():
    a = _spd(44)
    a[1] = -a[1][::-1]
    _la("linalg_det", [a], grad=(0,))
    _la("linalg_slogdet", [a], grad=(0,))


@pytest.mark.parametrize("offset", [0, 1, -2])
def test_linalg_diag_makers(offset):
    parity("linalg_extractdiag", [_r(3, 4, 4, seed=45)], {"offset": offset},
           grad=(0,))
    parity("linalg_makediag", [_r(3, 4, seed=46)], {"offset": offset},
           grad=(0,))


@pytest.mark.parametrize("lower,offset", [(True, 0), (True, -1), (False, 0),
                                          (False, 1), (False, 2)])
def test_linalg_trian_makers(lower, offset):
    attrs = {"lower": lower, "offset": offset}
    packed = parity("linalg_extracttrian", [_r(2, 4, 4, seed=47)], attrs,
                    grad=(0,))
    parity("linalg_maketrian", [packed[0]], attrs, grad=(0,))


LINALG = ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
          "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
          "extracttrian", "maketrian", "det", "slogdet", "inverse")


@pytest.mark.parametrize("n", LINALG)
def test_linalg_reference_names_resolve(n):
    assert port_ops.get_op("_linalg_" + n) is port_ops.get_op("linalg_" + n)


# ---------------------------------------------------------------------------
# the five contrib ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heads,hd", [(2, 3), (4, 8)])
def test_interleaved_encdec(heads, hd):
    Lq, Lk, N = 5, 6, 2
    q = _r(Lq, N, heads * hd, seed=50)
    kv = _r(Lk, N, heads * 2 * hd, seed=51)
    scores = parity("_contrib_interleaved_matmul_encdec_qk", [q, kv],
                    {"heads": heads}, grad=(0, 1))
    att = np.exp(scores[0]) / np.exp(scores[0]).sum(-1, keepdims=True)
    parity("_contrib_interleaved_matmul_encdec_valatt",
           [kv, att.astype(np.float32)], {"heads": heads}, grad=(0, 1))


def test_div_sqrt_dim():
    parity("_contrib_div_sqrt_dim", [_r(2, 3, 16, seed=52)], grad=(0,))


@pytest.mark.parametrize("attrs", [{}, {"start": 2.0, "step": 0.5},
                                   {"axis": 1}, {"axis": -1, "start": -3.0},
                                   {"repeat": 2}])
def test_arange_like(attrs):
    """``repeat`` is taken and ignored, as in the reference (ROADMAP.md
    queue 3)."""
    parity("_contrib_arange_like", [_r(2, 3, 4, seed=53)], attrs)
    parity("_contrib_arange_like",
           [np.zeros((3, 5), np.float16)], attrs)


@pytest.mark.parametrize("axis,mask", [(0, [1, 0, 1, 1]), (1, [0, 1, 1]),
                                       (0, [0, 0, 0, 0])])
def test_boolean_mask(axis, mask):
    data = _r(4, 3, seed=54)
    parity("_contrib_boolean_mask", [data, np.array(mask, np.float32)],
           {"axis": axis}, grad=(0,))


class _MaskBlock(pt.gluon.HybridBlock):
    def hybrid_forward(self, F, x, m):
        return F._contrib_boolean_mask(x, m)


def test_boolean_mask_refuses_a_captured_call():
    """Its output shape depends on the data: inside a hybridized call it
    raises MXNetError (the reference's jit raises too), while the eager
    twin answers."""
    blk = _MaskBlock()
    x = pt.nd.array(_r(4, 3, seed=55), ctx=pt.cpu())
    m = pt.nd.array([1, 0, 1, 0], ctx=pt.cpu())
    assert blk(x, m).shape == (2, 3)
    blk.hybridize()
    with pytest.raises(MXNetError, match="hybridized"):
        blk(x, m)
    from mxnet_tpu_torch import cached_op
    with cached_op.eager():
        assert blk(x, m).shape == (2, 3)
