"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: f32 within 1e-5 (abs + rel) — the kernel and the plain
version differ only in the order of f32 sums; for a sum over rows
(dgamma, dbeta, db) the absolute part is 1e-5 of the largest sum; bf16
and f16 within 1e-2 (abs + rel) or one ulp of the output.
"""
import contextlib

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import (cuda_attention, cuda_build, cuda_dropout,
                                 cuda_epilogue, cuda_fused, cuda_norm)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(g, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _assert_close(got, ref, reduced=False):
    """``reduced``: a sum over many rows (dgamma, dbeta, db), which the
    kernel adds in another order; its f32 error scales with the largest
    sum, not with each one."""
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    assert np.isfinite(g).all()
    err = np.abs(g - r)
    if ref.dtype == torch.float32:
        scale = np.abs(r).max() if reduced else 1.0
        tol = 1e-5 * scale + 1e-5 * np.abs(r)
    else:
        bits = 8 if ref.dtype == torch.bfloat16 else 11
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -24)))
                      - (bits - 1))
        tol = np.maximum(1e-2 + 1e-2 * np.abs(r), ulp)
    assert (err <= tol).all(), "max err %g" % err.max()


def _assert_equal_share(got, ref, least=0.99):
    """The attention kernels keep their plain versions' rounding points
    at hd = 64 (scale 2^-3): all but a few elements come out bit-equal
    (f32 sums in another order flip a bf16 rounding now and then)."""
    torch.cuda.synchronize()
    share = float((got == ref).float().mean())
    assert share >= least, "bit-equal share %.5f < %g" % (share, least)


DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# attention shapes (L, N, heads, hd) that launch every tile edge and
# template of csrc/selfatt.cu: ragged L, L past the single-pass backward
# (128) and the one-sweep softmax chunk, hd 32 (its own template)
ATT_EDGES = [(77, 4, 12, 64), (200, 2, 3, 64), (512, 2, 4, 64),
             (77, 4, 6, 32), (200, 2, 3, 32), (512, 2, 2, 32)]


# LayerNorm forward: the least bf16 share of elements of y bit-equal to the
# plain version. The kernel keeps the plain version's operations and
# rounding points (no multiply-add contraction); only its row sums (mean,
# variance) run in another order, which now and then moves a statistic by
# an ulp and flips a bf16 rounding. chip_epilogue.py read, over seeds 0-4
# on an H100 (the lesser of bf16 and f32 gamma/beta): 1 at (1, 768) and
# (33, 100); 0.999967-0.999977 at (1024, 768); 0.999971-0.999975 at
# (4096, 768); 0.999969-1 at (64, 1024); 0.999878-1 at (8, 2048), two
# elements of 16384 at seed 1; 0.999963-0.999972 on the shifted view.
# The floor is the least reading rounded down.
LN_EQUAL = 0.99987
# LayerNorm forward shapes: BERT's rows served and trained, the widest
# register-path row (1024), the chunked path (100 in bf16, 2048)
LN_SHAPES = [(1, 768), (1024, 768), (33, 100), (4096, 768), (64, 1024),
             (8, 2048)]


def _layer_norm_check(x, g, b, what):
    for gg, bb in ((g, b), (g.float(), b.float())):
        # gamma/beta also in f32 under a bf16 activation
        got = cuda_norm.layer_norm_cuda(x, gg, bb, 1e-5)
        ref = cuda_norm.layer_norm_plain(x, gg, bb, 1e-5)
        _assert_close(got, ref)
        _bf16_equal_share("layer_norm_fwd y %s %s, gamma %s" % (
            what, x.dtype, gg.dtype), got, ref, x.dtype, LN_EQUAL)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("M,C", LN_SHAPES)
def test_layer_norm_kernel(card, dtype, M, C):
    x = _randn(card, (M, C), dtype, 3.0) + 1
    g, b = _randn(card, (C,), dtype), _randn(card, (C,), dtype)
    _layer_norm_check(x, g, b, (M, C))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_layer_norm_kernel_on_a_shifted_view(card, dtype):
    """BERT's serving rows as a view one element off 16-byte alignment:
    the chunked path's input."""
    x = _shifted(card, 1024, 768, dtype, 3.0, 1.0)
    g, b = _randn(card, (768,), dtype), _randn(card, (768,), dtype)
    _layer_norm_check(x, g, b, "shift")


@pytest.mark.parametrize("L,N,heads,hd", [
    (1, 1, 1, 16), (127, 4, 5, 64), (128, 8, 12, 64), (16, 3, 4, 24),
    (64, 2, 3, 128), (33, 2, 2, 256), (1024, 2, 2, 64)] + ATT_EDGES)
def test_selfatt_kernel(card, L, N, heads, hd):
    qkv = _randn(card, (L, N, heads * 3 * hd), torch.bfloat16, 2.0)
    got = cuda_attention.selfatt_cuda(qkv, heads)
    ref = cuda_attention.selfatt_plain(qkv, heads)
    _assert_close(got, ref)
    if hd == 64:
        _assert_equal_share(got, ref)


def test_selfatt_dispatch_by_dtype(card):
    """f16 input is rounded to bf16 and served by the kernel; f32 takes
    the unfused composition and launches nothing, as in the reference."""
    from mxnet_tpu_torch.ops.contrib_ops import sdp_selfatt
    qkv = _randn(card, (33, 2, 4 * 3 * 16), torch.float16)
    cuda_build.reset_launch_counts()
    _assert_close(sdp_selfatt(qkv, heads=4),
                  cuda_attention.selfatt_plain(qkv, 4))
    assert cuda_build.launch_counts()["selfatt_fwd"] == 1
    out = sdp_selfatt(qkv.float(), heads=4)
    assert out.dtype == torch.float32
    assert cuda_build.launch_counts()["selfatt_fwd"] == 1


def _shifted(card, M, C, dtype, scale=1.0, offset=0.0):
    """An (M, C) view whose data pointer lies one element, 2 bytes in
    bf16, past a 16-byte boundary: the element path's input."""
    base = _randn(card, (M * C + 1,), dtype, scale) + offset
    t = base[1:].view(M, C)
    assert t.data_ptr() % 16 != 0
    return t


def _bf16_equal_share(what, got, ref, dtype, floor):
    """In bf16, the share of elements bit-equal to the plain version
    (printed), at least ``floor``."""
    if dtype != torch.bfloat16:
        return
    torch.cuda.synchronize()
    share = float((got == ref).float().mean())
    print("[equal] %s: %.6f bit-equal (floor %g)" % (what, share, floor))
    assert share >= floor, "%s: bit-equal share %.6f" % (what, share)


# bias+GeLU: the least bf16 share of elements of y and dx bit-equal to the
# plain version. chip_epilogue.py read 1 (every element) at every shape
# below for seeds 0-4 on an H100: the kernels keep the plain version's
# operations and their order, and erff/expf are the ones PyTorch calls.
GELU_EQUAL = 1.0
# shapes of the bias+GeLU kernels: BERT's (serving, training), ragged
# rows on the element path (7 and 300 in bf16), and "shift", BERT's
# serving shape as a view 2 bytes off 16-byte alignment (element path)
GELU_SHAPES = [(1024, 3072), (5, 7), (4096, 3072), (129, 300), "shift"]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", GELU_SHAPES, ids=str)
def test_epilogue_kernels(card, dtype, shape):
    M, C = (1024, 3072) if shape == "shift" else shape
    if shape == "shift":
        x = _shifted(card, M, C, dtype, 2.0)
    else:
        x = _randn(card, (M, C), dtype, 2.0)
    r = _randn(card, (M, C), dtype)
    b = _randn(card, (C,), dtype)
    got = cuda_epilogue.bias_gelu_cuda(x, b)
    ref = cuda_epilogue.bias_gelu_plain(x, b)
    _assert_close(got, ref)
    _bf16_equal_share("bias_gelu_fwd y %s %s" % (shape, dtype), got, ref,
                      dtype, GELU_EQUAL)
    # bias+residual: the plain version's two adds in its order, so every
    # element bit for bit in every dtype
    got = cuda_epilogue.bias_residual_cuda(x, b, r)
    ref = cuda_epilogue.bias_residual_plain(x, b, r)
    _assert_close(got, ref)
    assert torch.equal(got, ref), "bias_residual_fwd %s %s: %.6f bit-equal" % (
        shape, dtype, float((got == ref).float().mean()))


def test_bias_gelu_paths(card):
    """The launchers' C twins agree with the wrappers' helpers: the
    vector/element choice over C and dtype, the backward's scratch rows
    over shapes, dtypes, alignment and SM counts; a misaligned view takes
    the element path, and a scratch of another shape is refused before
    any launch."""
    lib = cuda_epilogue._lib()
    for C in (1, 7, 8, 300, 768, 3072, 3076, 4100):
        for dtype in DTYPES:
            code = cuda_build.DTYPE_CODES[dtype]
            assert lib.mxt_bias_col_vector(C, code) == \
                cuda_epilogue.col_vector(C, dtype), (C, dtype)
            for M in (1, 5, 129, 1024, 4096, 100000):
                for aligned in (True, False):
                    for sms in (1, 132):
                        vec = cuda_epilogue.col_vector(C, dtype, aligned)
                        assert lib.mxt_bias_gelu_bwd_strips(M, C, vec, sms) \
                            == cuda_epilogue.bwd_scratch_shape(
                                M, C, dtype, aligned, sms)[0], \
                            (M, C, dtype, aligned, sms)
    assert cuda_epilogue.col_vector(3072, torch.bfloat16) == 8
    assert cuda_epilogue.col_vector(300, torch.bfloat16) == 1
    x = _shifted(card, 64, 3072, torch.bfloat16)
    assert not cuda_epilogue.aligned16(x)
    assert cuda_epilogue.col_vector(3072, torch.bfloat16,
                                     cuda_epilogue.aligned16(x)) == 1
    dy = _randn(card, (64, 3072), torch.bfloat16)
    b = _randn(card, (3072,), torch.bfloat16)
    dx, db = torch.empty_like(dy), torch.empty_like(b)
    sms = cuda_build.sm_count(dy.device)
    strips = cuda_epilogue.bwd_scratch_shape(64, 3072, torch.bfloat16, True,
                                             sms)[0]
    part = torch.empty((strips + 1, 3072), dtype=torch.float32,
                       device="cuda")
    code = cuda_build.DTYPE_CODES[torch.bfloat16]
    rc = lib.mxt_bias_gelu_bwd(dy.data_ptr(), dy.data_ptr(), b.data_ptr(),
                               dx.data_ptr(), part.data_ptr(), strips + 1,
                               db.data_ptr(), 64, 3072, sms, code, code,
                               cuda_build.stream_of(dy))
    assert rc != 0


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = _randn(card, (8, 16), torch.bfloat16)
    b = _randn(card, (16,), torch.bfloat16)
    with pytest.raises(MXNetError, match="contiguous"):
        cuda_norm.layer_norm_cuda(x.t(), b[:8], b[:8], 1e-5)
    with pytest.raises(MXNetError, match="dtype"):
        cuda_epilogue.bias_gelu_cuda(x.double(), b)
    with pytest.raises(MXNetError, match="bias must be"):
        cuda_epilogue.bias_gelu_cuda(x, b[:4])
    with pytest.raises(MXNetError, match="dtype"):
        cuda_attention.selfatt_cuda(x.float().reshape(2, 2, 32), 1)


def test_served_bert_runs_the_kernels(card):
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    mx.random.seed(0)
    net = BERTModel(num_layers=2, units=64, hidden_size=128, num_heads=4,
                    max_length=32, vocab_size=100, prefix="bert_",
                    dropout=0.0)
    net.initialize(ctx=mx.gpu(0))
    net.cast("bfloat16")
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (3, 11)).astype(np.int32)
    tok = np.zeros((3, 11), np.int32)
    cuda_build.reset_launch_counts()
    sess = net.serve_session(mx.nd.array(ids, ctx=mx.gpu(0)),
                             mx.nd.array(tok, ctx=mx.gpu(0)), seq_axis=1,
                             max_batch=4, max_seq=16)
    outs = sess.infer(ids, tok)
    counts = cuda_build.launch_counts()
    # 3 forwards through the wrappers (the session's first, the bucket's
    # eager warm-up and its graph capture), 2 layers each; serving
    # launches no backward or dropout kernel
    assert counts == dict({k: 0 for k in cuda_build.KERNELS},
                          layer_norm_fwd=3 * 6, selfatt_fwd=3 * 2,
                          bias_gelu_fwd=3 * 2, bias_residual_fwd=3 * 4)
    # the next request replays the bucket's graph: no wrapper runs
    np.testing.assert_array_equal(sess.infer(ids, tok)[0], outs[0])
    assert cuda_build.launch_counts() == counts
    # the plain versions, eagerly: the replayed kernels against them
    from mxnet_tpu_torch import cached_op
    with mock.patch.object(cuda_norm, "layer_norm",
                           cuda_norm.layer_norm_plain), \
            mock.patch.object(cuda_attention, "selfatt",
                              cuda_attention.selfatt_plain), \
            mock.patch.object(cuda_epilogue, "bias_gelu",
                              cuda_epilogue.bias_gelu_plain), \
            mock.patch.object(cuda_epilogue, "bias_residual",
                              cuda_epilogue.bias_residual_plain), \
            cached_op.eager():
        refs = sess.infer(ids, tok)
    assert cuda_build.launch_counts() == counts
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and np.isfinite(o).all()
        np.testing.assert_allclose(o, r, rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# training: backward kernels, dropout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("M,C", [(1, 768), (4096, 768), (33, 100),
                                 (70, 1536), (4096, 1024), (5, 4100)])
def test_layer_norm_bwd_kernel(card, dtype, M, C):
    x = _randn(card, (M, C), dtype, 3.0) + 1
    dy = _randn(card, (M, C), dtype)
    g = _randn(card, (C,), dtype)
    # gamma also in f32 under a bf16 activation, as under AMP: dgamma and
    # dbeta then come back in f32
    for gg in (g, g.float()):
        got = cuda_norm.layer_norm_bwd_cuda(dy, x, gg, 1e-5)
        ref = cuda_norm.layer_norm_bwd_plain(dy, x, gg, 1e-5)
        assert got[1].dtype == got[2].dtype == gg.dtype
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_close(a, b, reduced=i > 0)


def test_layer_norm_bwd_paths(card):
    """The launcher takes the register path and the chunked path where
    the wrapper's reg_vectors says: BERT's rows (768) and 1024 in
    registers, rows of 1536 and 4100 and the unaligned bf16 rows of 100
    chunked; and the grid is two blocks an SM."""
    lib = cuda_norm._lib()
    for C in (100, 768, 1024, 1536, 4100):
        for dtype in DTYPES:
            assert lib.mxt_layer_norm_vectors(
                C, cuda_build.DTYPE_CODES[dtype]) == \
                cuda_norm.reg_vectors(C, dtype), (C, dtype)
    assert cuda_norm.reg_vectors(768, torch.bfloat16) == 3
    assert cuda_norm.reg_vectors(100, torch.bfloat16) == 0
    sms = cuda_build.sm_count(torch.device("cuda"))
    assert cuda_norm.bwd_blocks(4096, sms) == 2 * sms


def test_layer_norm_fwd_paths(card):
    """The forward's C twins agree with the wrapper's helpers: its path
    (the backward's reg_vectors, and the chunked path for an unaligned
    pointer) and its grid over rows, widths, dtypes, alignment and SM
    counts; BERT's rows take the register path unless shifted; a shift
    of gamma outside (0, C) is refused before any launch."""
    lib = cuda_norm._lib()
    for C in (8, 100, 768, 1024, 1028, 2048):
        for dtype in DTYPES:
            code = cuda_build.DTYPE_CODES[dtype]
            for M in (1, 33, 1024, 4096, 100000):
                for aligned in (True, False):
                    for sms in (1, 132):
                        assert lib.mxt_layer_norm_fwd_blocks(
                            M, C, code, int(aligned), sms) == \
                            cuda_norm.fwd_blocks(M, C, dtype, aligned, sms), \
                            (M, C, dtype, aligned, sms)
    sms = cuda_build.sm_count(torch.device("cuda"))
    assert cuda_norm.fwd_blocks(1024, 768, torch.bfloat16, True, sms) == \
        min(256, 4 * sms)
    x = _shifted(card, 64, 768, torch.bfloat16)
    g = _randn(card, (768,), torch.bfloat16)
    assert cuda_norm.reg_vectors(768, x.dtype,
                                 cuda_epilogue.aligned16(x, g)) == 0
    y = torch.empty_like(x)
    code = cuda_build.DTYPE_CODES[torch.bfloat16]
    for shift in (-1, 768):
        rc = lib.mxt_layer_norm_fwd_gamma_shift(
            x.data_ptr(), g.data_ptr(), g.data_ptr(), y.data_ptr(), 64, 768,
            1e-5, code, code, sms, shift, cuda_build.stream_of(x))
        assert rc != 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(4096, 3072), (5, 7), (129, 300),
                                   (1024, 3072), "shift"], ids=str)
def test_bias_gelu_bwd_kernel(card, dtype, shape):
    M, C = (1024, 3072) if shape == "shift" else shape
    if shape == "shift":
        x = _shifted(card, M, C, dtype, 2.0)
    else:
        x = _randn(card, (M, C), dtype, 2.0)
    dy = _randn(card, (M, C), dtype)
    b = _randn(card, (C,), dtype)
    got = cuda_epilogue.bias_gelu_bwd_cuda(dy, x, b)
    ref = cuda_epilogue.bias_gelu_bwd_plain(dy, x, b)
    for i, (a, b_) in enumerate(zip(got, ref)):
        _assert_close(a, b_, reduced=i > 0)
    _bf16_equal_share("bias_gelu_bwd dx %s %s" % (shape, dtype), got[0],
                      ref[0], dtype, GELU_EQUAL)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 4095, 4097, 1120 * 650,
                               4096 * 768])
def test_dropout_kernel_is_the_plain_version(card, dtype, n, p):
    """Sizes below one 16-byte access, with a tail of every length, and
    the main path's; the 16-byte variant, bit for bit."""
    x = torch.rand(n, generator=card, device="cuda").to(dtype) + 1
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    scalar = cuda_dropout.scalar_launches
    got = cuda_dropout.dropout_cuda(x, p, seed)
    ref = cuda_dropout.dropout_plain(x, p, seed)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert cuda_dropout.scalar_launches == scalar


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_dropout_kernel_on_an_offset_view(card, dtype, offset):
    """x a view 1-3 elements into a larger tensor (off 16-byte
    alignment): the one-element variant, counted apart, bit for bit with
    the plain version; its aligned copy takes the 16-byte variant and
    gives the same values."""
    n = 1120 * 650 + 5
    big = torch.rand(n + offset, generator=card, device="cuda").to(dtype) + 1
    x = big[offset:]
    assert x.data_ptr() % 16 != 0
    seed = torch.tensor([777], dtype=torch.int32, device="cuda")
    scalar = cuda_dropout.scalar_launches
    launches = cuda_build.launch_counts()["dropout"]
    got = cuda_dropout.dropout_cuda(x, 0.5, seed)
    assert cuda_dropout.scalar_launches == scalar + 1
    copy = cuda_dropout.dropout_cuda(x.clone(), 0.5, seed)
    assert cuda_dropout.scalar_launches == scalar + 1
    assert cuda_build.launch_counts()["dropout"] == launches + 2
    torch.cuda.synchronize()
    ref = cuda_dropout.dropout_plain(x, 0.5, seed)
    assert torch.equal(got, ref) and torch.equal(copy, ref)


def test_dropout_kernel_past_2_32_elements(card):
    """n = 2^32 + 4096 bf16 (about 17 GB with the output): the elements on
    both sides of 2^32, where the index's high word joins the seed,
    against hash_bits of those indices; the first 2^20 against the plain
    version."""
    n, w, big = (1 << 32) + 4096, 1 << 14, 1 << 32
    free, _ = torch.cuda.mem_get_info()
    if free < 2 * n * 2 + (1 << 30):
        pytest.skip("needs %.1f GB free on the card, has %.1f"
                    % ((2 * n * 2 + (1 << 30)) / 1e9, free / 1e9))
    seed = torch.tensor([2 ** 31 - 5], dtype=torch.int32, device="cuda")
    x = torch.full((n,), 1.5, dtype=torch.bfloat16, device="cuda")
    x[:1 << 20] = torch.rand(1 << 20, generator=card, device="cuda") + 1
    x[big - w:] = torch.rand(n - big + w, generator=card, device="cuda") + 1
    y = cuda_dropout.dropout_cuda(x, 0.1, seed)
    torch.cuda.synchronize()
    head = cuda_dropout.dropout_plain(x[:1 << 20], 0.1, seed)
    assert torch.equal(y[:1 << 20], head)
    idx = torch.arange(big - w, n, dtype=torch.int64, device="cuda")
    s = (seed.to(torch.int64) + (idx >> 32)) & 0xFFFFFFFF
    keep = cuda_dropout.hash_bits(idx & 0xFFFFFFFF, s) >= \
        cuda_dropout.keep_threshold(0.1)
    want = torch.where(keep, x[big - w:].float() * cuda_dropout._scale(0.1),
                       0.0).to(torch.bfloat16)
    assert torch.equal(y[big - w:], want)
    del x, y
    torch.cuda.empty_cache()


@pytest.mark.parametrize("L,N,heads,hd", [
    (1, 1, 1, 16), (127, 4, 5, 64), (128, 8, 12, 64), (33, 2, 3, 128),
    (33, 2, 2, 256), (1024, 2, 2, 64)] + ATT_EDGES)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_selfatt_fwd_bwd_kernels(card, L, N, heads, hd, p):
    """Each output within tol(ref) + |ref - wit| of the plain version
    ``ref`` at every element (chip_smoke.order_limit): tol is
    _assert_close's bound and ``wit`` the plain version with its products,
    softmax denominators and dS row sums summed in float64, so the limit
    widens only where another f32 summation order moves the plain version
    itself. The tensor cores sum
    Q.K^T and dO.V^T in another order than cuBLAS, which now and then
    flips the bf16 rounding of a large dS that dQ and dK carry; where the
    two plain orders agree the bound is _assert_close's."""
    import chip_smoke
    qkv = _randn(card, (L, N, heads * 3 * hd), torch.bfloat16, 2.0)
    dout = _randn(card, (L, N, heads * hd), torch.bfloat16)
    plan = cuda_attention.selfatt_plan(L, heads, N)
    seeds = torch.randint(0, 2 ** 31 - 1, (plan["n_blocks"],),
                          generator=card, device="cuda", dtype=torch.int32)
    args = (heads, p, seeds, plan["bbh"])
    f64 = {"sum_dtype": torch.float64}
    triples = [("fwd", cuda_attention.selfatt_cuda(qkv, *args),
                cuda_attention.selfatt_plain(qkv, *args),
                cuda_attention.selfatt_plain(qkv, *args, **f64)),
               ("bwd", cuda_attention.selfatt_bwd_cuda(qkv, dout, *args),
                cuda_attention.selfatt_bwd_plain(qkv, dout, *args),
                cuda_attention.selfatt_bwd_plain(qkv, dout, *args, **f64))]
    for name, got, ref, wit in triples:
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        beyond, apart, there = chip_smoke.order_limit(got, ref, wit)
        print("[order] %s L=%d N=%d heads=%d hd=%d p=%g: plain f32 and "
              "float64-summed apart beyond tol at %d elements, |got - ref| "
              "there up to %g; beyond the limit %d"
              % (name, L, N, heads, hd, p, apart, there, beyond))
        assert beyond == 0, "%d elements beyond the order limit" % beyond
        if hd == 64:
            _assert_equal_share(got, ref)


def test_selfatt_bwd_routes_and_pd_terms(card):
    """L <= 128 at hd <= 64 takes the single-pass backward, longer L the
    two passes; on both, dV from the bf16 Pd (one term, through the
    debug entry mxt_selfatt_bwd_pd_terms) leaves too few elements
    bit-equal, the kernel's three terms enough."""
    import chip_smoke
    single = cuda_attention._lib().mxt_selfatt_bwd_single_pass
    assert single(128, 64) == 1 and single(77, 32) == 1
    assert single(129, 64) == 0 and single(128, 128) == 0
    for L in (128, 256):
        qkv = _randn(card, (L, 8, 4 * 3 * 64), torch.bfloat16)
        dout = _randn(card, (L, 8, 4 * 64), torch.bfloat16)
        plan = cuda_attention.selfatt_plan(L, 4, 8)
        seeds = torch.randint(0, 2 ** 31 - 1, (plan["n_blocks"],),
                              generator=card, device="cuda",
                              dtype=torch.int32)
        args = (4, 0.1, seeds, plan["bbh"])
        ref = cuda_attention.selfatt_bwd_plain(qkv, dout, *args)
        _assert_equal_share(cuda_attention.selfatt_bwd_cuda(qkv, dout, *args),
                            ref)
        bad = chip_smoke._selfatt_bwd_pd_terms(qkv, dout, *args, 1)
        torch.cuda.synchronize()
        assert float((bad == ref).float().mean()) < 0.99


def test_selfatt_dropout_mask_is_the_plain_mask(card):
    """q = 0 makes P uniform (1/64) and v one-hot per key makes the
    context the dropped probabilities themselves, so its zeros are the
    mask."""
    L, N, heads, hd = 64, 2, 3, 64
    qkv = torch.zeros(L, N, heads, 3, hd, device="cuda")
    qkv[:, :, :, 2] = torch.eye(L, device="cuda")[:, None, None, :]
    qkv = qkv.reshape(L, N, heads * 3 * hd).to(torch.bfloat16)
    plan = cuda_attention.selfatt_plan(L, heads, N)
    seeds = torch.arange(plan["n_blocks"], dtype=torch.int32,
                         device="cuda") * 7919 + 3
    out = cuda_attention.selfatt_cuda(qkv, heads, 0.25, seeds, plan["bbh"])
    mask = cuda_attention.keep_mask(seeds, N, heads, L, 0.25, plan["bbh"])
    got = out.reshape(L, N, heads, hd).permute(1, 2, 0, 3) != 0
    torch.cuda.synchronize()
    assert torch.equal(got, mask)


def test_training_step_runs_the_kernels(card):
    """A 2-layer BERT + BERTMLMLoss step at dropout 0.1 launches every
    kernel of the path the expected number of times, and its loss and
    gradients match the same step with the plain versions (same seeds,
    same masks)."""
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss, BERTModel
    net = BERTModel(num_layers=2, units=64, hidden_size=128, num_heads=4,
                    max_length=32, vocab_size=100, prefix="bert_",
                    dropout=0.1, use_pooler=False, use_classifier=False,
                    use_decoder=False)
    mlm = BERTMLMLoss(vocab_size=100, units=64, mode="dense", prefix="mlm_")
    net.initialize(ctx=mx.gpu(0))
    mlm.initialize(ctx=mx.gpu(0))
    rng = np.random.RandomState(0)
    ids, tok, lab = (mx.nd.array(rng.randint(0, hi, (4, 16)), ctx=mx.gpu(0))
                     for hi in (100, 2, 100))
    net(ids, tok)
    net.cast("bfloat16")
    mlm.cast("bfloat16")
    params = net.collect_params()
    params.update(mlm.collect_params())

    def step():
        mx.random.seed(1)
        with mx.autograd.record():
            loss = mlm(net(ids, tok)[0], lab).mean()
        loss.backward()
        return loss.asnumpy(), {n: p.grad().asnumpy()
                                for n, p in params.items()}

    cuda_build.reset_launch_counts()
    loss, grads = step()
    assert cuda_build.launch_counts() == {
        "layer_norm_fwd": 6, "layer_norm_bwd": 6, "selfatt_fwd": 2,
        "selfatt_bwd": 2, "bias_gelu_fwd": 2, "bias_gelu_bwd": 2,
        "bias_residual_fwd": 2, "dropout": 6, "dual_bwd": 0}
    with mock.patch.object(cuda_norm, "layer_norm",
                           cuda_norm.layer_norm_plain), \
            mock.patch.object(cuda_norm, "layer_norm_bwd",
                              cuda_norm.layer_norm_bwd_plain), \
            mock.patch.object(cuda_attention, "selfatt",
                              cuda_attention.selfatt_plain), \
            mock.patch.object(cuda_attention, "selfatt_bwd",
                              cuda_attention.selfatt_bwd_plain), \
            mock.patch.object(cuda_epilogue, "bias_gelu",
                              cuda_epilogue.bias_gelu_plain), \
            mock.patch.object(cuda_epilogue, "bias_gelu_bwd",
                              cuda_epilogue.bias_gelu_bwd_plain), \
            mock.patch.object(cuda_epilogue, "bias_residual",
                              cuda_epilogue.bias_residual_plain), \
            mock.patch.object(cuda_dropout, "dropout",
                              cuda_dropout.dropout_plain):
        before = cuda_build.launch_counts()
        ref_loss, ref_grads = step()
        assert cuda_build.launch_counts() == before
    # the kernels agree with their plain versions to a bf16 ulp or so
    # per element, so each gradient tensor stays within 2e-2 relative L2
    # (a zeroed gradient reads 1)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-2, atol=0)
    for n, g in ref_grads.items():
        err = np.linalg.norm(grads[n] - g) / np.linalg.norm(g)
        assert err <= 2e-2, (n, err)


# ---------------------------------------------------------------------------
# ResNet: the fused BN-backward dual-matmul kernel
# ---------------------------------------------------------------------------
def _dual_inputs(g, M, I, O, mask_mode, has_addend, emit_next):
    bf = torch.bfloat16
    jg, y = _randn(g, (M, O), bf), _randn(g, (M, O), bf)
    x = _randn(g, (M, I), bf)
    w = _randn(g, (I, O), bf, I ** -0.5)
    coef = torch.zeros(8, O, device="cuda")
    coef[:5] = torch.randn(5, O, generator=g, device="cuda") * torch.tensor(
        [[1.0], [0.1], [0.1], [1.0], [0.5]], device="cuda")
    kw = {}
    if mask_mode == "out":
        kw["mask"] = _randn(g, (M, O), bf)
    if has_addend:
        kw["addend"] = _randn(g, (M, I), bf)
    if emit_next:
        kw["y3p"] = _randn(g, (M, I), bf)
        kw["mprev"] = torch.randn(I, generator=g, device="cuda") * 0.1
    return (jg, y, x, w, coef, mask_mode), kw


@pytest.mark.parametrize("M,I,O", [(256, 32, 64), (1000, 64, 256),
                                   (1568, 2048, 512), (333, 70, 130),
                                   (6272, 256, 1024), (1568, 512, 2048),
                                   (520, 48, 200)])
@pytest.mark.parametrize("emit_next", [False, True])
@pytest.mark.parametrize("emit_jg", [False, True])
@pytest.mark.parametrize("has_addend", [False, True])
@pytest.mark.parametrize("mask_mode", ["none", "scale_shift", "out"])
def test_dual_bwd_kernel(card, mask_mode, has_addend, emit_jg, emit_next,
                         M, I, O):
    """Every variant at ResNet-50's widest head shape and its stage 3
    and 4 tails (whose dx depth the kernel splits into slices), at a row
    count that is a multiple of no tile, at widths that are not
    multiples of the kernel's tiles (element loads in place of 16-byte
    ones), and where one block takes both products ((1000, 64, 256);
    (520, 48, 200) with I and O short of that block's); the masked jg is
    a select and must be exact, and at least 99% of dx's elements
    bit-equal (the kernel and cuBLAS add the f32 products in another
    order)."""
    args, kw = _dual_inputs(card, M, I, O, mask_mode, has_addend,
                            emit_next)
    plan = cuda_fused.dual_plan(M, I, O,
                                cuda_build.sm_count(torch.device("cuda")),
                                emit_next)
    if (M, I, O) in ((6272, 256, 1024), (1568, 512, 2048)):
        assert plan["splits_x"] > 1
    assert plan["fused"] == ((M, I, O) in ((1000, 64, 256), (520, 48, 200))
                             and not emit_next)
    got = cuda_fused.dual_bwd_cuda(*args, emit_jg=emit_jg, **kw)
    ref = cuda_fused.dual_bwd_plain(*args, emit_jg=emit_jg, **kw)
    _assert_close(got[0], ref[0])
    assert float((got[0] == ref[0]).float().mean()) >= 0.99
    _assert_close(got[1], ref[1], reduced=True)
    if emit_jg:
        assert torch.equal(got[2], ref[2])
    else:
        assert got[2] is None
    if emit_next:
        # the sums are of the kernel's own rounded dx, whose one-ulp flips
        # against the plain dx they must carry
        dxf = got[0].float()
        want = torch.stack([dxf.sum(0), (dxf * (kw["y3p"].float()
                                                - kw["mprev"])).sum(0)])
        _assert_close(got[3], want, reduced=True)
    else:
        assert got[3] is None


def test_dual_bwd_refuses_what_the_kernel_does_not_take(card):
    args, kw = _dual_inputs(card, 64, 16, 32, "out", False, False)
    with pytest.raises(MXNetError, match="mask is required"):
        cuda_fused.dual_bwd_cuda(*args)
    with pytest.raises(MXNetError, match="dtype"):
        cuda_fused.dual_bwd_cuda(args[0].float(), *args[1:], **kw)
    with pytest.raises(MXNetError, match="w must be"):
        cuda_fused.dual_bwd_cuda(args[0], args[1], args[2], args[3][:8],
                                 *args[4:], **kw)
    with pytest.raises(MXNetError, match="unknown mask_mode"):
        cuda_fused.dual_bwd_cuda(*args[:5], "relu")


@pytest.mark.parametrize("fmt", ["NHWC", "HWNC"])
def test_fused_stage_runs_the_kernel(card, fmt):
    """A 3-block stage with a downsampling first block launches the
    kernel 3 + 2 + 2 times per backward, and its outputs and gradients
    match the same stage with the plain version."""
    from unittest import mock
    rng = np.random.RandomState(0)
    I, C, O = 64, 16, 64

    def w(i, o, k=1):
        shape = (i, o) if k == 1 else (k, k, i, o)
        return torch.tensor(rng.randn(*shape) * np.sqrt(2.0 / (i * k * k)),
                            dtype=torch.float32, device="cuda",
                            requires_grad=True)

    def bn(c):
        return [torch.tensor(rng.rand(c) + 0.5, dtype=torch.float32,
                             device="cuda", requires_grad=True),
                torch.tensor(rng.randn(c) * 0.1, dtype=torch.float32,
                             device="cuda", requires_grad=True)]

    blocks = []
    for i in range(3):
        b = [w(I if i == 0 else O, C), *bn(C), w(C, C, 3), *bn(C), w(C, O),
             *bn(O)]
        if i == 0:
            b += [w(I, O), *bn(O)]
        blocks.append(b)
    shape = (4, 8, 8, I) if fmt == "NHWC" else (8, 8, 4, I)
    x = torch.tensor(rng.randn(*shape), dtype=torch.bfloat16,
                     device="cuda", requires_grad=True)
    head = torch.randn(shape[:3] + (O,), generator=card, device="cuda")
    leaves = [x] + [p for b in blocks for p in b]

    def run():
        out, _ = cuda_fused.fused_stage(x, blocks, data_format=fmt,
                                        ds_first=True)
        loss = (out.float() * head).sum()
        return [out.detach()] + list(torch.autograd.grad(loss, leaves))

    cuda_build.reset_launch_counts()
    got = run()
    assert cuda_build.launch_counts()["dual_bwd"] == 7
    with mock.patch.object(cuda_fused, "dual_bwd",
                           cuda_fused.dual_bwd_plain):
        ref = run()
    assert cuda_build.launch_counts()["dual_bwd"] == 7
    _assert_close(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        err = float((a.float() - b.float()).norm() / b.float().norm())
        assert err <= 2e-2, err


# ---------------------------------------------------------------------------
# mx.rtc: the user module of chip_smoke.py, compiled at runtime
# ---------------------------------------------------------------------------
def _rtc_modules():
    import chip_smoke
    import mxnet_tpu_torch as mx
    plain = chip_smoke.rtc_plain()
    return (chip_smoke, mx.rtc.CudaModule(chip_smoke.RTC_SOURCE, plain=plain),
            mx.rtc.CudaModule(chip_smoke.RTC_SOURCE, num_outputs=2,
                              plain=plain), plain)


@pytest.mark.parametrize("shape", [(1,), (257,), (64, 128), (64, 64),
                                   (1 << 20,)])
def test_rtc_user_kernels_match_their_plain_functions(card, shape):
    """saxpy within 2^-23 of each element (an FMA against two roundings,
    non-negative inputs); the others bit for bit; counted as rtc:<name>."""
    from mxnet_tpu_torch.ndarray import NDArray
    cs, mod, mod2, plain = _rtc_modules()
    x = torch.rand(shape, generator=card, device="cuda")
    y = torch.rand(shape, generator=card, device="cuda")
    xs = torch.randn(shape, generator=card, device="cuda")
    xs.view(-1)[::3] = 0.0
    cuda_build.reset_launch_counts()
    got = mod.get_kernel("saxpy", alpha=2.0).launch(
        [NDArray(x), NDArray(y)]).tensor()
    ref = torch.empty_like(x)
    plain["saxpy"](x, y, ref, alpha=2.0)
    torch.cuda.synchronize()
    assert ((got - ref).abs() <= 2.0 ** -23 * ref.abs()).all()
    a, b = mod2.get_kernel("twoout").launch([NDArray(x)])
    assert torch.equal(a.tensor(), x * 2) and torch.equal(b.tensor(), x + 1)
    h = mod.get_kernel("relu_fwd").launch([NDArray(xs)]).tensor()
    rh = torch.empty_like(xs)
    plain["relu_fwd"](xs, rh)
    assert torch.equal(h, rh)
    dx = mod.get_kernel("relu_bwd").launch([NDArray(y - 0.5), NDArray(h)])
    rdx = torch.empty_like(xs)
    plain["relu_bwd"](y - 0.5, h, rdx)
    assert torch.equal(dx.tensor(), rdx)
    assert cs._rtc_counts() == {k: 1 for k in cs.RTC_KERNELS}


def test_rtc_module_reuse_and_launch_options(card):
    from mxnet_tpu_torch.ndarray import NDArray
    cs, mod, mod2, _ = _rtc_modules()
    path = mod.build()
    stamp = path.stat().st_mtime_ns
    assert mod2.build() == path and path.stat().st_mtime_ns == stamp
    # an explicit grid and block cover the array as the default does
    x = torch.rand(1000, generator=card, device="cuda")
    k = mod.get_kernel("relu_fwd")
    got = k.launch([NDArray(x)], grid=(8,), block=128).tensor()
    assert torch.equal(got, x)
    # a launch that is refused raises with the CUDA error
    with pytest.raises(MXNetError, match="CUDA launch failed"):
        k.launch([NDArray(x)], shared_mem=1 << 30)
    empty = k.launch([NDArray(x[:0])]).tensor()
    assert empty.shape == (0,)


def test_rtc_binding_errors_on_cuda_tensors(card):
    from mxnet_tpu_torch.ndarray import NDArray
    cs, mod, mod2, _ = _rtc_modules()
    x = torch.rand(64, generator=card, device="cuda")
    before = cuda_build.launch_counts()
    cases = [
        (lambda: mod2.get_kernel("saxpy", alpha=1.0), "points to const"),
        (lambda: mod.get_kernel("relu_fwd").launch([NDArray(x.half())]),
         "got dtype torch.float16"),
        (lambda: mod.get_kernel("relu_bwd").launch([NDArray(x)]),
         "takes 2 inputs"),
        (lambda: mod.get_kernel("relu_bwd").launch(
            [NDArray(x), NDArray(x.cpu())]), "several devices"),
        (lambda: mod.get_kernel("relu_fwd").launch(
            [NDArray(x)], out_dtypes=["float64"]), "got dtype torch.float64")]
    for fn, match in cases:
        with pytest.raises(MXNetError, match=match):
            fn()
    assert cuda_build.launch_counts() == before


def test_mnist_custom_op_step_equals_its_twin_on_the_card(card):
    """Two SGD steps of the MLP with the rtc custom op against the
    Dense(relu) twin: bit for bit, two launches of each relu kernel per
    step."""
    import mxnet_tpu_torch as mx
    cs, mod, _, _ = _rtc_modules()
    cs.register_rtc_relu(mx, mod)
    X, y, _, _ = cs.mnist_synthetic(256)
    mx.random.seed(0)
    net = cs.mnist_mlp(mx, True)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.zeros((1, 1, 28, 28), ctx=mx.gpu(0)))
    init = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    nets = cs._mnist_nets(mx, init, mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(X, y),
                                      batch_size=64)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for step, (data, label) in zip(range(2), loader):
            assert data.context == mx.gpu(0)
            cuda_build.reset_launch_counts()
            _, loss = cs._mnist_step(*nets["custom"], loss_fn, data, label)
            assert cs._rtc_counts()["relu_fwd"] == 2
            assert cs._rtc_counts()["relu_bwd"] == 2
            _, tloss = cs._mnist_step(*nets["twin"], loss_fn, data, label)
            assert cs._mnist_diff(nets, loss, tloss) is None, step
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------------------------
# the LM-head cross entropies (torch products, no kernel of the port)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adt,bdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float16)],
                         ids=str)
def test_f32_product_out_dtype_matches_the_widened_product(card, adt, bdt):
    """The head's product on the card (cuBLAS with f32 output for
    low-precision operands) against the f32 product of the widened
    operands with TF32 off: a product of two bf16 or f16 values is exact
    in f32, so the two differ only in the order of f32 sums."""
    from mxnet_tpu_torch.ops.contrib_ops import _f32_product
    a = _randn(card, (512, 768), adt)
    b = _randn(card, (768, 1000), bdt)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = _f32_product(a, b)
        ref = torch.mm(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert got.dtype == torch.float32
    _assert_close(got, ref, reduced=True)


@pytest.mark.parametrize("hdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=str)
def test_chunked_head_matches_the_full_vocab_head(card, hdt, wdt):
    """The chunked head (chunk 1024 over a vocab of 5000, the last chunk
    padded) against the full-vocab head on the card, at the tolerances
    of tests/test_chunked_ce.py: f32 loss within rtol 1e-6 (atol 1e-6)
    and gradients within rtol 5e-5 (atol 1e-5 of the largest); with bf16
    hidden states the loss within 1e-5 and each gradient's max abs error
    below 1e-2 of its largest magnitude. Both heads run with CUDA's sync
    debug mode set to error: no op of either makes the host wait for
    the card."""
    from mxnet_tpu_torch.ops import contrib_ops
    T, U, V = 512, 256, 5000
    h = _randn(card, (T, U), hdt)
    w = _randn(card, (V, U), wdt, 0.3)
    b = _randn(card, (V,), torch.float32, 0.1)
    lab = torch.randint(0, V, (T,), generator=card, device="cuda")
    dy = torch.rand(T, generator=card, device="cuda")
    runs = []
    for op, kw in ((contrib_ops.chunked_lm_head_ce, {"chunk_size": 1024}),
                   (contrib_ops.fused_lm_head_ce, {})):
        ts = [t.clone().requires_grad_() for t in (h, w, b)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = op(*ts, lab, **kw)
            runs.append([loss] + list(torch.autograd.grad(loss, ts, dy)))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    (cl, *cg), (fl, *fg) = runs
    assert cl.dtype == torch.float32
    if hdt == torch.float32:
        torch.testing.assert_close(cl, fl, rtol=1e-6, atol=1e-6)
        for a, r in zip(cg, fg):
            torch.testing.assert_close(a, r, rtol=5e-5,
                                       atol=1e-5 * r.abs().max().item())
        return
    torch.testing.assert_close(cl, fl, rtol=1e-5, atol=1e-5)
    for a, r in zip(cg, fg):
        assert a.dtype == r.dtype
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err < 1e-2, err.item()



# ---------------------------------------------------------------------------
# hybridize(): CachedOp graphs and the fused SGD step, captured and replayed
# ---------------------------------------------------------------------------
def _small_bert(mx, dropout, seed=0):
    """A 2-layer BERT and its dense MLM loss in bf16 on gpu(0), and a
    (4, 16) batch: every BERT kernel runs (the dropout kernel at
    dropout > 0)."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss, BERTModel
    mx.random.seed(seed)
    net = BERTModel(num_layers=2, units=64, hidden_size=128, num_heads=4,
                    max_length=32, vocab_size=100, prefix="bert_",
                    dropout=dropout, use_pooler=False, use_classifier=False,
                    use_decoder=False)
    mlm = BERTMLMLoss(vocab_size=100, units=64, mode="dense", prefix="mlm_")
    net.initialize(ctx=mx.gpu(0))
    mlm.initialize(ctx=mx.gpu(0))
    rng = np.random.RandomState(seed)
    batch = [mx.nd.array(rng.randint(0, hi, (4, 16)), ctx=mx.gpu(0))
             for hi in (100, 2, 100)]
    net(*batch[:2])
    net.cast("bfloat16")
    mlm.cast("bfloat16")
    params = net.collect_params()
    params.update(mlm.collect_params())
    return net, mlm, params, batch


def _bert_step(mx, net, mlm, params, batch, head):
    ids, tok, lab = batch
    with mx.autograd.record():
        seq = net(ids, tok)
        seq = seq if isinstance(seq, mx.nd.NDArray) else seq[0]
        per_position = mlm(seq, lab)
        loss = per_position if head == "plan" else per_position.mean()
    loss.backward()
    return per_position.asnumpy(), {n: p.grad().asnumpy()
                                    for n, p in params.items()}


@pytest.mark.parametrize("head", ["plan", "nodes"])
def test_hybridized_bert_replays_equal_eager(card, head):
    """The BERT model and its loss hybridized: the first step is the
    eager warm-up, the second captures, the fourth replays only. Every step's
    loss and gradients equal the eager step's bit for bit at dropout 0
    (the same kernels in the same order), but for the two embedding
    tables, held to 2^-8 * sqrt(64) relative L2: a bf16 rounding an add,
    in a random walk over the 64 tokens a row can receive (token_type's
    two rows read 0.0106 on an H100 when the backward was
    ``index_add_``, whose atomics added the rows in an order that
    changed from run to run). ``plan``: the
    backward of the two nodes is one plan (its own graph from the third
    step); ``nodes``: the loss's mean makes each node replay its own
    backward graph."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    net, mlm, params, batch = _small_bert(mx, 0.0)
    want = _bert_step(mx, net, mlm, params, batch, head)
    for block in (net, mlm):
        block.hybridize(static_alloc=True, static_shape=True)
    cuda_build.reset_launch_counts()
    for step in range(4):
        if step == 3:
            cached_op.reset_replay_counts()
            cuda_build.reset_launch_counts()
        got = _bert_step(mx, net, mlm, params, batch, head)
        np.testing.assert_array_equal(got[0], want[0])
        for n in want[1]:
            if n.endswith("embed_weight"):
                err = np.linalg.norm(got[1][n] - want[1][n]) / \
                    np.linalg.norm(want[1][n])
                assert err <= 2.0 ** -8 * 64 ** 0.5, (n, err)
            else:
                np.testing.assert_array_equal(got[1][n], want[1][n],
                                              err_msg=n)
        if step == 1:
            counts = cuda_build.launch_counts()
            cuda_build.reset_launch_counts()
    for k in ("layer_norm_fwd", "layer_norm_bwd", "selfatt_fwd",
              "selfatt_bwd", "bias_gelu_fwd", "bias_gelu_bwd",
              "bias_residual_fwd"):
        assert counts[k] > 0, (k, counts)
    # the fourth step replays graphs only (the plan's own graph is
    # captured at its second run, the third step): no kernel wrapper runs
    assert not any(cuda_build.launch_counts().values())
    # the plan never runs a node's own backward, so none is captured
    bwds = [e.bwd for b in (net, mlm)
            for lst in b._cached_op._entries.values() for e in lst]
    assert all((g is None) == (head == "plan") for g in bwds)
    reps = cached_op.replay_counts()
    assert reps == {"forward": 2, "backward": 0 if head == "plan" else 2,
                    "tape": 1 if head == "plan" else 0, "chunk": 0}


def test_hybridized_dropout_replays_draw_new_masks(card):
    """A hybridized Dropout(0.1) in train mode: each replay draws new
    seeds on the card, so two replays keep different elements, each
    keeping within 5 binomial sigma of 0.9; a reseed makes the next
    replay draw the first replay's mask again."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    drop = nn.Dropout(0.1)
    drop.hybridize(static_alloc=True, static_shape=True)
    x = mx.nd.ones((4096, 768), ctx=mx.gpu(0), dtype="bfloat16")
    masks = []
    for i in range(4):
        if i == 1:
            mx.random.seed(7)
        with mx.autograd.train_mode():
            masks.append(drop(x).tensor() != 0)
    n = x.size
    sigma = (n * 0.9 * 0.1) ** 0.5
    for m in masks:
        assert abs(m.sum().item() - 0.9 * n) <= 5 * sigma
    assert not torch.equal(masks[2], masks[3])
    mx.random.seed(7)
    with mx.autograd.train_mode():
        assert torch.equal(drop(x).tensor() != 0, masks[1])


def _sgd_loop(mx, fused, lrs, monkeypatch):
    from mxnet_tpu_torch.gluon import nn
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1" if fused else "0")
    mx.random.seed(3)
    net = nn.HybridSequential(prefix="sgd_")
    with net.name_scope():
        net.add(nn.Dense(64, activation="relu"), nn.Dense(10))
    net.initialize(ctx=mx.gpu(0))
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(32, 20), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 10, (32,)), ctx=mx.gpu(0))
    net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    lf.hybridize(static_alloc=True, static_shape=True)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": lrs[0], "momentum": 0.9})
    losses = []
    for lr in lrs:
        tr.set_learning_rate(lr)
        with mx.autograd.record():
            loss = lf(net(x), y)
        loss.backward()
        tr.step(32)
        losses.append(loss.asnumpy())
    mx.autograd.disarm_fused_update()
    return losses, [p.data().asnumpy() for p in net.collect_params().values()]


def test_fused_sgd_replay_reads_the_new_learning_rate(card, monkeypatch):
    """A learning rate changed after the fused step was captured (step
    3) takes effect in the next replay: six steps at six learning rates
    equal the same steps with the separate update, bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    lrs = [0.1, 0.05, 0.2, 0.01, 0.3, 0.0]
    cached_op.reset_replay_counts()
    got = _sgd_loop(mx, True, lrs, monkeypatch)
    assert cached_op.replay_counts()["tape"] == 4
    want = _sgd_loop(mx, False, lrs, monkeypatch)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


def test_fused_sgd_second_trainer_replays_its_own_step(card, monkeypatch):
    """Two SGD Trainers without momentum, one after the other, over one
    hybridized net: the second builds the same plan and update math as
    the first, whose step is captured by then, yet replays a step of its
    own that reads its rate and rescale; both equal the separate update
    bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.gluon import nn

    def run(fused):
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE",
                           "1" if fused else "0")
        mx.random.seed(3)
        net = nn.HybridSequential(prefix="two_")
        with net.name_scope():
            net.add(nn.Dense(64, activation="relu"), nn.Dense(10))
        net.initialize(ctx=mx.gpu(0))
        rng = np.random.RandomState(0)
        x = mx.nd.array(rng.randn(32, 20), ctx=mx.gpu(0))
        y = mx.nd.array(rng.randint(0, 10, (32,)), ctx=mx.gpu(0))
        net(x)
        net.hybridize(static_alloc=True, static_shape=True)
        lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        lf.hybridize(static_alloc=True, static_shape=True)
        out = []
        for lr, batch in ((0.1, 32), (0.02, 16)):
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": lr})
            for _ in range(4):
                with mx.autograd.record():
                    loss = lf(net(x), y)
                loss.backward()
                tr.step(batch)
                out.append(loss.asnumpy())
        mx.autograd.disarm_fused_update()
        return out + [p.data().asnumpy()
                      for p in net.collect_params().values()]

    cached_op.reset_replay_counts()
    got = run(True)
    # each Trainer: consumed at steps 2-4, captured at 3, replayed at 3-4
    assert cached_op.replay_counts()["tape"] == 4
    for a, b in zip(got, run(False)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fused_backward", ["1", "0"])
def test_backward_after_release_names_the_op(card, monkeypatch,
                                             fused_backward):
    """A tape recorded on a captured graph whose block is cast before the
    backward (the graphs are released) raises MXNetError naming the op,
    through the tape plan and node by node."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import nn
    monkeypatch.setenv("MXNET_FUSED_BACKWARD", fused_backward)
    net = nn.HybridSequential(prefix="rel_")
    net.add(nn.Dense(16))
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.ones((4, 8), ctx=mx.gpu(0))
    net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    # the input's gradient makes the engine reach the node after the cast
    x.attach_grad()
    for _ in range(2):                 # the warm-up, then a captured call
        with mx.autograd.record():
            out = net(x)
    net.cast("float16")
    with pytest.raises(MXNetError, match="CachedOp rel: .*released"):
        out.backward()


def test_recorded_instances_are_capped(card):
    """Recorded calls whose backward has not run each hold a graph
    instance; the call past MAX_INSTANCES raises instead of capturing
    another, and a backward frees its instance for the next call."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="cap_")
    net.add(nn.Dense(16))
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.ones((4, 8), ctx=mx.gpu(0))
    net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    with mx.autograd.record():
        outs = [net(x) for _ in range(1 + cached_op.MAX_INSTANCES)]
        with pytest.raises(MXNetError, match="CachedOp cap: .*hold their residuals"):
            net(x)
    outs[-1].backward()
    with mx.autograd.record():
        net(x)
    assert net._cached_op.num_entries() == 1


def test_weight_changed_in_place_is_seen_by_the_replay(card):
    """An eval graph reads the parameters in place (static_alloc): a
    set_data after capture changes the next replay's output, which then
    equals the eager forward with the new weight."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dense(8))
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.array(np.random.RandomState(1).randn(16, 24), ctx=mx.gpu(0))
    net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    net(x)                       # warm-up and capture
    before = net(x).asnumpy()    # a replay
    w = net[1].weight
    w.set_data(w.data().asnumpy() * -2)
    cached_op.reset_replay_counts()
    after = net(x).asnumpy()
    assert cached_op.replay_counts()["forward"] == 1
    with cached_op.eager():
        want = net(x).asnumpy()
    np.testing.assert_array_equal(after, want)
    assert not np.array_equal(after, before)


def test_capture_failure_names_the_op(card):
    """A forward that makes the host wait for the card cannot be
    captured: the call raises MXNetError naming the last op before the
    failure, and nothing runs eagerly instead."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import HybridBlock

    class Syncs(HybridBlock):
        def hybrid_forward(self, F, x):
            y = F.relu(x)
            return y * float(y.asnumpy().sum())

    blk = Syncs()
    blk.hybridize()
    x = mx.nd.ones((4, 4), ctx=mx.gpu(0))
    # the eager warm-up runs, then the eval capture fails
    with pytest.raises(MXNetError, match="capture failed at op relu"):
        blk(x)
    with pytest.raises(MXNetError, match="capture failed at op relu"):
        blk(x)


# ---------------------------------------------------------------------------
# the PTB slice: the RNN op, the dropout kernel at its shapes, the
# hybridized LSTM with its carried states
# ---------------------------------------------------------------------------
@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _rnn_grads(mx, ctx, mode, bi, layers, arrays):
    args = [mx.nd.array(a, ctx=ctx) for a in arrays]
    if mode != "lstm":
        args = args[:3]
    for a in args:
        a.attach_grad()
    with mx.autograd.record():
        out = mx.nd.RNN(*args, state_size=arrays[2].shape[-1],
                        num_layers=layers, mode=mode, bidirectional=bi)
        loss = sum((o * o).sum() for o in out)
    loss.backward()
    return [o.tensor().detach() for o in out] + \
        [a.grad.tensor() for a in args]


@pytest.mark.parametrize("mode,bi,layers", [
    ("lstm", False, 2), ("gru", True, 1), ("rnn_tanh", False, 1),
    ("rnn_relu", True, 2)])
def test_rnn_op_on_the_card_matches_the_cpu_run(card, no_tf32, mode, bi,
                                                layers):
    """The RNN op on the card against the same op on the CPU (the
    reference's math, as the CPU tests hold it), TF32 off: outputs,
    final states and every gradient within the f32 tolerance."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size
    T, N, I, H = 7, 5, 12, 16
    D = 2 if bi else 1
    rs = np.random.RandomState(0)
    arrays = [rs.randn(T, N, I).astype(np.float32),
              (rs.randn(rnn_param_size(mode, I, H, layers, bi)) * 0.2)
              .astype(np.float32),
              rs.randn(layers * D, N, H).astype(np.float32),
              rs.randn(layers * D, N, H).astype(np.float32)]
    got = _rnn_grads(mx, mx.gpu(0), mode, bi, layers, arrays)
    want = _rnn_grads(mx, mx.cpu(), mode, bi, layers, arrays)
    for g, w in zip(got, want):
        _assert_close(g, w.cuda())


@pytest.mark.parametrize("shape", [(35, 32, 650), (35 * 32, 650),
                                   (3, 5, 7)])
def test_dropout_kernel_at_ptb_shapes(card, shape):
    """PTB's dropout shapes (a last axis that is not a multiple of 128),
    f32 at p 0.5: forward and backward bit for bit with the plain
    version, the backward's mask the forward's."""
    x = (torch.rand(shape, generator=card, device="cuda") + 1) \
        .requires_grad_()
    dy = torch.rand(shape, generator=card, device="cuda") + 1
    seed = torch.tensor([20251017], dtype=torch.int32, device="cuda")
    y = cuda_dropout.dropout_fn(x, 0.5, seed)
    y.backward(dy)
    torch.cuda.synchronize()
    assert torch.equal(y, cuda_dropout.dropout_plain(x.detach(), 0.5, seed))
    assert torch.equal(x.grad, cuda_dropout.dropout_plain(dy, 0.5, seed))
    assert torch.equal(y == 0, x.grad == 0)
    n = y.numel()
    assert abs((y != 0).sum().item() - n / 2) <= 5 * (n / 4) ** 0.5


def test_hybridized_lstm_with_states_replays_equal_eager(card, no_tf32):
    """A 2-layer LSTM called with its states, hybridized: its output and
    final states, and the gradients of the input, the states and every
    parameter, equal the eager call's bit for bit from the warm-up to a
    replay (the same products in the same order)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    layer = mx.gluon.rnn.LSTM(32, 2, input_size=16, prefix="lstm_")
    layer.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rs = np.random.RandomState(1)
    x = mx.nd.array(rs.randn(9, 4, 16), ctx=mx.gpu(0))
    states = [mx.nd.array(rs.randn(2, 4, 32), ctx=mx.gpu(0))
              for _ in range(2)]

    def step():
        xa = x.copy()
        xa.attach_grad()
        sa = [s.copy() for s in states]
        for s in sa:
            s.attach_grad()
        with mx.autograd.record():
            out, new = layer(xa, sa)
            loss = (out * out).sum() + (new[0] * new[1]).sum()
        loss.backward()
        return [out.asnumpy(), new[0].asnumpy(), new[1].asnumpy(),
                xa.grad.asnumpy()] + [s.grad.asnumpy() for s in sa] + \
            [p.grad().asnumpy() for p in layer.collect_params().values()]

    want = step()
    layer.hybridize(static_alloc=True, static_shape=True)
    for i in range(3):
        if i == 2:
            cached_op.reset_replay_counts()
        got = step()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert cached_op.replay_counts()["forward"] == 1


# ---------------------------------------------------------------------------
# checkpoints on the card
# ---------------------------------------------------------------------------
def _ckpt_net(mx, prefix):
    from mxnet_tpu_torch.gluon import nn
    mx.random.seed(5)
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(64, activation="relu"), nn.BatchNorm(),
                nn.Dense(10))
    net.initialize(ctx=mx.gpu(0))
    return net


def _ckpt_step(mx, net, lf, tr, x, y):
    with mx.autograd.record():
        loss = lf(net(x), y)
    loss.backward()
    tr.step(32)
    return loss.asnumpy()


def test_load_into_captured_trainer_replays_the_loaded_values(
        card, monkeypatch, tmp_path):
    """Parameters and SGD momenta loaded into a hybridized net and a
    Trainer whose fused step is captured are written into the tensors
    the graphs read: the next steps replay the same graphs (no new
    runner) and equal the steps first taken from those values, bit for
    bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    net = _ckpt_net(mx, "ckg_")
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(32, 20), ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 10, (32,)), ctx=mx.gpu(0))
    net(x)
    net.hybridize(static_alloc=True, static_shape=True)
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    lf.hybridize(static_alloc=True, static_shape=True)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    for _ in range(3):
        _ckpt_step(mx, net, lf, tr, x, y)
    net.save_parameters(str(tmp_path / "p"))
    tr.save_states(str(tmp_path / "s"))
    first = [_ckpt_step(mx, net, lf, tr, x, y) for _ in range(3)]
    after = [p.data().asnumpy() for p in net.collect_params().values()]
    runners = dict(tr.optimizer.step_runners)
    net.load_parameters(str(tmp_path / "p"))
    tr.load_states(str(tmp_path / "s"))
    cached_op.reset_replay_counts()
    again = [_ckpt_step(mx, net, lf, tr, x, y) for _ in range(3)]
    assert cached_op.replay_counts()["tape"] == 3
    assert tr.optimizer.step_runners == runners
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    for a, p in zip(after, net.collect_params().values()):
        np.testing.assert_array_equal(a, p.data().asnumpy())
    mx.autograd.disarm_fused_update()


def test_load_that_does_not_fit_closes_the_captured_step(card, monkeypatch):
    """A blob whose states cannot be written into the captured Trainer's
    tensors (index 0's momentum missing, so it starts anew) closes the
    captured fused step, whose graph read the old tensors: the step
    drops its graph and leaves the optimizer, the next steps capture
    their own, and the run equals the fused step off, bit for bit."""
    import pickle
    import mxnet_tpu_torch as mx

    def run(fused):
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE",
                           "1" if fused else "0")
        net = _ckpt_net(mx, "nf%d_" % fused)
        rng = np.random.RandomState(0)
        x = mx.nd.array(rng.randn(32, 20), ctx=mx.gpu(0))
        y = mx.nd.array(rng.randint(0, 10, (32,)), ctx=mx.gpu(0))
        net(x)
        net.hybridize(static_alloc=True, static_shape=True)
        lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        lf.hybridize(static_alloc=True, static_shape=True)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        for _ in range(4):
            _ckpt_step(mx, net, lf, tr, x, y)
        runners = tr.optimizer.step_runners
        old = list(runners.values())
        if fused:
            assert len(old) == 1 and old[0].graph is not None
        kept = {i: mx.nd.array(s.asnumpy(), ctx=mx.cpu())
                for i, s in tr._updater.states.items() if i != 0}
        tr.load_states_blob(pickle.dumps(kept))
        assert runners == {}
        assert all(r.closed and r.graph is None for r in old)
        out = [_ckpt_step(mx, net, lf, tr, x, y) for _ in range(3)]
        assert len(runners) == len(old)
        if fused:
            new = next(iter(runners.values()))
            assert new is not old[0] and new.graph is not None
        mx.autograd.disarm_fused_update()
        return out + [p.data().asnumpy()
                      for p in net.collect_params().values()]

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)


def _reference_style_blob(mx, states):
    """A states blob as the reference writes it: protocol 2, each array
    through ``mxnet_tpu.ndarray.ndarray._unpickle`` with cpu(0) (the
    reference package is not imported: the global is renamed in the
    pickle)."""
    import pickle
    host = {i: tuple(mx.nd.array(a, ctx=mx.cpu()) for a in s)
            if isinstance(s, tuple) else mx.nd.array(s, ctx=mx.cpu())
            for i, s in states.items()}
    raw = pickle.dumps(host, protocol=2)
    port = b"cmxnet_tpu_torch.ndarray.ndarray\n_unpickle\n"
    assert port in raw
    return raw.replace(port, b"cmxnet_tpu.ndarray.ndarray\n_unpickle\n")


def test_loaded_reference_blob_places_its_states_on_the_card(card):
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(1)
    shapes = [(7, 5), (5,)]
    params = []
    for i, s in enumerate(shapes):
        p = mx.gluon.Parameter("ck%d" % i, shape=s)
        p.initialize(ctx=mx.gpu(0))
        params.append(p)
    tr = mx.gluon.Trainer(params, "adam", {"learning_rate": 0.01})
    states = {i: (rng.randn(*s).astype(np.float32),
                  rng.rand(*s).astype(np.float32))
              for i, s in enumerate(shapes)}
    tr.load_states_blob(_reference_style_blob(mx, states))
    for p in params:
        p.grad()[:] = 1.0
    tr.step(1)
    for i, (m, v) in tr._updater.states.items():
        for arr in (m, v):
            assert arr.tensor().is_cuda and arr.context == mx.gpu(0)
            assert arr._tdtype == torch.float32
    assert tr.optimizer.num_update == 1


def test_save_states_waits_for_the_card_once_a_file(card, tmp_path):
    """Every state array is copied to the host asynchronously, then one
    wait: under ``torch.cuda.set_sync_debug_mode`` the save warns of one
    synchronising call however many arrays it writes (nd.save too)."""
    import warnings
    import mxnet_tpu_torch as mx
    params = []
    for i in range(6):
        p = mx.gluon.Parameter("sync%d" % i, shape=(64, 32))
        p.initialize(ctx=mx.gpu(0))
        params.append(p)
    tr = mx.gluon.Trainer(params, "lamb", {"learning_rate": 0.01})
    for p in params:
        p.grad()[:] = 0.5
    tr.step(1)
    torch.cuda.synchronize()
    for what, save in (
            ("save_states", lambda: tr.save_states(str(tmp_path / "s"))),
            ("nd.save", lambda: mx.nd.save(str(tmp_path / "p"),
                                           [p.data() for p in params]))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                save()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        assert len(syncs) == 1, (what, [str(w.message) for w in caught])


@pytest.mark.parametrize("ids_shape", [(35, 32), (32, 128)])
def test_embedding_backward_is_the_same_from_run_to_run(card, ids_shape):
    """The Embedding's weight gradient on the card (repeated ids, as
    text gives them) is the same in every run, at PTB's batch and at
    BERT's 4096 ids: ``index_put_(accumulate=True)`` sorts the ids,
    where index_add_'s atomics change the order of the adds from run to
    run (and ``F.embedding``'s backward does past 3072 ids); it equals
    the CPU's within f32 sums in another order."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import get_op
    emb = get_op("Embedding").impl
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 50, ids_shape, generator=g).float()
    w = torch.randn(100, 64, generator=g)
    dy = torch.randn(*ids_shape, 64, generator=g)
    grads = []
    for dev in ("cuda",) * 4 + ("cpu",):
        wt = w.to(dev).requires_grad_()
        emb(ids.to(dev), wt, input_dim=100, output_dim=64).backward(
            dy.to(dev))
        grads.append(wt.grad.cpu())
    for gr in grads[1:4]:
        assert torch.equal(gr, grads[0])
    _assert_close(grads[0], grads[4])


def test_gather_nd_out_of_range_on_the_card(card):
    """``nd.gather_nd`` with indices past either end of each axis gives
    the CPU's values on the card, and the CUDA context stays usable:
    the indices are clamped on the tensor, so torch's index kernel never
    asserts."""
    import mxnet_tpu_torch as mx
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    cases = ([[3, -1, -5], [0, 4, 1]],
             [[1, -1, -3, 2, 0, 5], [2, 0, -4, -1, 3, 1],
              [3, -2, 4, -5, 0, -1]])
    for idx in cases:
        idx = np.array(idx, dtype=np.float32)
        data = x.reshape(-1, 4)[:3] if idx.shape[0] == 2 else x
        got = [mx.nd.gather_nd(mx.nd.array(data, ctx=ctx),
                               mx.nd.array(idx, ctx=ctx)).asnumpy()
               for ctx in (mx.gpu(0), mx.cpu())]
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(
        mx.nd.gather_nd(mx.nd.array(x[0], ctx=mx.gpu(0)),
                        mx.nd.array(cases[0], ctx=mx.gpu(0))).asnumpy(),
        [8, 11, 1])
    assert float((torch.ones(4, device="cuda") * 2).sum()) == 8.0


@pytest.mark.parametrize("ret_typ", ["value", "indices", "both"])
def test_topk_axis_none_on_the_card(card, ret_typ):
    """``nd.topk(axis=None)`` flattens on the card as on the CPU: shape
    (k,), the same values and flat positions."""
    import mxnet_tpu_torch as mx
    x = np.random.RandomState(0).randn(3, 4, 5).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        o = mx.nd.topk(mx.nd.array(x, ctx=ctx), axis=None, k=3,
                       ret_typ=ret_typ)
        outs.append([a.asnumpy() for a in (o if ret_typ == "both" else (o,))])
    for g, c in zip(*outs):
        assert g.shape == (3,)
        np.testing.assert_array_equal(g, c)


# ---------------------------------------------------------------------------
# MXNET_SCAN_STEPS: K steps as one captured graph a chunk
# ---------------------------------------------------------------------------
def _scan_bert(mx, seed=0):
    """A 2-layer BERT 128 wide at dropout 0.1 and its dense MLM loss in
    bf16 on gpu(0), hybridized, and a (4, 16) batch."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss, BERTModel
    mx.random.seed(seed)
    net = BERTModel(num_layers=2, units=128, hidden_size=256, num_heads=2,
                    max_length=32, vocab_size=100, prefix="sbert_",
                    dropout=0.1, use_pooler=False, use_classifier=False,
                    use_decoder=False)
    mlm = BERTMLMLoss(vocab_size=100, units=128, mode="dense",
                      prefix="smlm_")
    net.initialize(ctx=mx.gpu(0))
    mlm.initialize(ctx=mx.gpu(0))
    rng = np.random.RandomState(seed)
    batch = [mx.nd.array(rng.randint(0, hi, (4, 16)), ctx=mx.gpu(0))
             for hi in (100, 2, 100)]
    net(*batch[:2])
    net.cast("bfloat16")
    mlm.cast("bfloat16")
    for b in (net, mlm):
        b.hybridize(static_alloc=True, static_shape=True)
    params = net.collect_params()
    params.update(mlm.collect_params())
    return net, mlm, params, batch


def _scan_run(mx, monkeypatch, k, steps, guard=False, plant=None,
              probe=None):
    """``steps`` SGD steps (momentum 0.9, wd 0.01, a PolyScheduler) of
    the small BERT at MXNET_SCAN_STEPS=k from seed 0, backward from the
    loss block's output; ``plant``: the step index whose gradient gets a
    NaN; ``probe(i)`` wraps step i. Returns (losses, parameters,
    momenta, the guard, the Trainer)."""
    from mxnet_tpu_torch import faultinject
    monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    faultinject.reset()
    net, mlm, params, batch = _scan_bert(mx)
    sched = mx.lr_scheduler.PolyScheduler(max_update=100, base_lr=0.01,
                                          warmup_steps=2, pwr=1)
    tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.01,
                                          "momentum": 0.9, "wd": 0.01,
                                          "lr_scheduler": sched})
    if guard:
        tr.grad_guard = mx.guardrails.GradGuard(nonfinite="skip_step")
    mx.random.seed(5)
    ids, tok, lab = batch
    losses = []
    for i in range(steps):
        if plant is not None and i == plant - 1:
            faultinject.set_fault("nan_grad", 1.0, max_fires=1)

        def step():
            with mx.autograd.record():
                seq = net(ids, tok)
                seq = seq if isinstance(seq, mx.nd.NDArray) else seq[0]
                per_position = mlm(seq, lab)
            per_position.backward()
            tr.step(4)
            return per_position
        losses.append(probe(i, step) if probe else step())
    mx.autograd.flush_all_pending()
    faultinject.reset()
    out = ([l.asnumpy() for l in losses],
           {n: p.data().asnumpy() for n, p in params.items()},
           {i: s.asnumpy() for i, s in tr._updater.states.items()},
           tr.grad_guard, tr)
    mx.autograd.disarm_fused_update()
    return out


def _assert_runs_equal(a, b):
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    for key in (1, 2):
        assert a[key].keys() == b[key].keys()
        for n in a[key]:
            np.testing.assert_array_equal(a[key][n], b[key][n],
                                          err_msg=str(n))


def test_scan_chunk_replays_once_per_k(card, monkeypatch):
    """At K=4 the first chunk runs eagerly, the second is captured, the
    third replays one graph: no forward, backward or plan replay and no
    kernel launched outside it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    seen = {}

    def probe(i, step):
        if i == 9:                  # the first step of the third chunk
            cached_op.reset_replay_counts()
            cuda_build.reset_launch_counts()
        out = step()
        if i == 12:
            torch.cuda.synchronize()
            seen["replays"] = cached_op.replay_counts()
            seen["launches"] = {k: v for k, v in
                                cuda_build.launch_counts().items() if v}
        return out
    *_, tr = _scan_run(mx, monkeypatch, 4, 13, probe=probe)
    assert seen["replays"] == {"forward": 0, "backward": 0, "tape": 0,
                               "chunk": 1}
    assert seen["launches"] == {}
    assert tr._scan.retired_chunks == 3 and not tr._scan.bailed


def test_scan_one_host_sync_per_chunk(card, monkeypatch):
    """A steady guarded chunk reads the card once (its verdict), as
    torch.cuda.set_sync_debug_mode counts synchronising calls."""
    import warnings
    import mxnet_tpu_torch as mx
    seen = {}

    def probe(i, step):
        if i not in (9, 10, 11, 12):
            return step()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        seen.setdefault("syncs", []).append(
            sum("called a synchronizing" in str(x.message) for x in w))
        return out
    *_, guard, tr = _scan_run(mx, monkeypatch, 4, 13, guard=True,
                              probe=probe)
    assert seen["syncs"] == [0, 0, 0, 1]
    assert guard.sync_count == 1 + 3


def test_scan_bitwise_with_per_step(card, monkeypatch):
    """11 steps at K=4 (the arming step, two chunks, a tail of two
    drained by the read) equal 11 per-step fused steps bit for bit:
    losses, parameters and momenta, at dropout 0.1 under a schedule."""
    import mxnet_tpu_torch as mx
    four = _scan_run(mx, monkeypatch, 4, 11)
    one = _scan_run(mx, monkeypatch, 1, 11)
    _assert_runs_equal(four, one)
    assert four[4]._scan.retired_chunks == 2
    assert four[4]._scan.flushed_steps == 2


def test_scan_guard_skip_bitwise_with_classic(card, monkeypatch):
    """A NaN planted at step 6, inside the second chunk: K=4 with a
    skip_step guard equals the classic guarded path at K=1 bit for bit,
    both skip one step, and the chunked run reads the card 4 times (the
    arming step, two chunks, the tail) against 11."""
    import mxnet_tpu_torch as mx
    four = _scan_run(mx, monkeypatch, 4, 11, guard=True, plant=6)
    one = _scan_run(mx, monkeypatch, 1, 11, guard=True, plant=6)
    _assert_runs_equal(four, one)
    assert four[3].skipped_steps == one[3].skipped_steps == 1
    assert (four[3].sync_count, one[3].sync_count) == (4, 11)


# ---------------------------------------------------------------------------
# the DataLoader's worker processes and the VGG step (chip_smoke.py phase 15)
# ---------------------------------------------------------------------------
class _NumpyChain:
    def __len__(self):
        return 24

    def __getitem__(self, i):
        return np.full((3, 4, 4), float(i), np.float32), np.int32(i)


class _TouchesTheCard(_NumpyChain):
    def __getitem__(self, i):
        torch.zeros(1, device="cuda")
        return super().__getitem__(i)


def _lazy_init_counter(monkeypatch):
    """torch.cuda._lazy_init wrapped to count calls made in a child
    process (the C++ side reaches it too); the count lives in shared
    memory."""
    import multiprocessing
    import os
    parent = os.getpid()
    count = multiprocessing.get_context("fork").Value("i", 0)
    real = torch.cuda._lazy_init

    def lazy_init():
        if os.getpid() != parent:
            with count.get_lock():
                count.value += 1
        return real()
    monkeypatch.setattr(torch.cuda, "_lazy_init", lazy_init)
    return count


def test_dataloader_workers_never_touch_the_card(card, monkeypatch):
    """The parent has initialised CUDA; its forked workers make numpy
    batches without reaching CUDA, and the batches land on the card. A
    worker that creates a CUDA tensor is seen and raises."""
    import mxnet_tpu_torch as mx
    torch.zeros(1, device="cuda")
    count = _lazy_init_counter(monkeypatch)
    assert torch.cuda.is_initialized()
    loader = mx.gluon.data.DataLoader(_NumpyChain(), batch_size=4,
                                      num_workers=2)
    got = [(x.tensor(), y.tensor()) for x, y in loader]
    assert count.value == 0 and len(got) == 6
    for i, (x, y) in enumerate(got):
        assert x.is_cuda and y.dtype == torch.int32
        assert torch.equal(y.cpu(), torch.arange(4 * i, 4 * i + 4,
                                                 dtype=torch.int32))
    with pytest.raises(RuntimeError, match="DataLoader worker failed"):
        list(mx.gluon.data.DataLoader(_TouchesTheCard(), batch_size=4,
                                      num_workers=2))
    assert count.value > 0


def test_vgg_step_launches_the_dropout_kernel_four_times(card):
    """VGG's classifier has two Dropout(0.5) layers: an eager training
    step launches row 8 four times (forward and backward of each), and a
    hybridized one records the four into its graphs."""
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    net = mx.gluon.model_zoo.vision.VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                                        classes=10, prefix="v_")
    net.initialize(mx.init.Xavier())
    net.hybridize(static_alloc=True, static_shape=True)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.01, "momentum": 0.9})
    x = mx.nd.NDArray(torch.randn(4, 3, 32, 32, generator=card,
                                  device="cuda"))
    y = mx.nd.NDArray(torch.arange(4, device="cuda").float())

    def step():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(4)
    with cached_op.eager():
        step()
        cuda_build.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        assert cuda_build.launch_counts()["dropout"] == 4
    with chip_smoke._capture_launches() as recorded:
        for _ in range(3):
            step()
    torch.cuda.synchronize()
    assert recorded["dropout"] == 4


# ---------------------------------------------------------------------------
# io.ImageRecordIter: the pinned staging ring, the side-stream upload
# ---------------------------------------------------------------------------
def _raw_pack(tmp_path, n=23, h=12, w=10):
    from mxnet_tpu_torch import recordio
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    wr = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        wr.write_idx(i, recordio.pack(
            recordio.IRHeader(0, float(i), i, 0),
            rng.randint(0, 256, (h, w, 3), np.uint8).tobytes()))
    wr.close()
    return rec, idx


@pytest.mark.parametrize("stream", ["default", "side"])
def test_image_record_iter_card_batches_equal_cpu(card, tmp_path, stream):
    """More batches than staging slots, two epochs, a short tail: each
    card batch equals the CPU iterator's, also when the consumer runs on
    a stream of its own (it waits for the upload's event)."""
    import mxnet_tpu_torch as mx
    rec, idx = _raw_pack(tmp_path)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 12, 10),
              batch_size=4, shuffle=True, rand_mirror=True, seed=3,
              mean_r=1.0, std_b=3.0)
    gpu = mx.io.ImageRecordIter(ctx=mx.gpu(0), **kw)
    cpu = mx.io.ImageRecordIter(ctx=mx.cpu(), **kw)
    s = torch.cuda.Stream() if stream == "side" else \
        torch.cuda.current_stream()
    with torch.cuda.stream(s):
        for _ in range(2):
            got = [(b.data[0].tensor().clone(), b.label[0].tensor().clone(),
                    b.pad) for b in gpu]
            want = [(b.data[0].tensor(), b.label[0].tensor(), b.pad)
                    for b in cpu]
            torch.cuda.synchronize()
            assert len(got) == len(want) == 6
            for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
                assert gd.is_cuda and gp == wp
                assert torch.equal(gd.cpu(), wd) and torch.equal(gl.cpu(), wl)
            gpu.reset()
            cpu.reset()
    assert len(gpu._slots) == gpu.STAGING_SLOTS
    assert all(sl.data.is_pinned() for sl in gpu._slots)


# ---------------------------------------------------------------------------
# the samplers and random ops inside captured graphs; CTC and
# SoftmaxOutput on the card
# ---------------------------------------------------------------------------
SAMPLERS = [("_random_uniform", {"low": -1.0, "high": 2.0}),
            ("_random_normal", {"loc": 1.0, "scale": 3.0}),
            ("_random_gamma", {"alpha": 2.0, "beta": 0.5}),
            ("_random_exponential", {"lam": 3.0}),
            ("_random_poisson", {"lam": 2.5}),
            ("_random_randint", {"low": 0, "high": 1000}),
            ("_random_negative_binomial", {"k": 2, "p": 0.3}),
            ("_random_generalized_negative_binomial", {"mu": 1.5,
                                                       "alpha": 0.4})]


@pytest.mark.parametrize("name,attrs", SAMPLERS)
def test_sampler_repeats_after_seed_on_the_card(card, name, attrs):
    import mxnet_tpu_torch as mx
    draws = []
    for _ in range(2):
        mx.random.seed(13)
        a = getattr(mx.nd, name)(shape=(4096,), **attrs)
        b = getattr(mx.nd, name)(shape=(4096,), **attrs)
        draws.append((a.tensor(), b.tensor()))
    assert draws[0][0].is_cuda
    assert torch.equal(draws[0][0], draws[1][0])
    assert torch.equal(draws[0][1], draws[1][1])
    assert not torch.equal(draws[0][0], draws[0][1])


def _random_block_steps(net, x, steps=3):
    import mxnet_tpu_torch as mx
    out = []
    for _ in range(steps):
        x.attach_grad()
        with mx.autograd.record():
            y, z, d = net(x)
        y.backward()
        out.append([a.tensor().clone() for a in (y, z, d, x.grad)])
    torch.cuda.synchronize()
    return out


def test_random_block_replays_draw_anew_and_repeat_after_seed(card):
    """Dropout and F.random_normal in one hybridized block: each replay
    draws a new mask and new noise, and after seed() the captured run
    equals the eager one bit for bit."""
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    net = chip_smoke.random_block(mx, units=256, groups=8)
    net.initialize(mx.init.Xavier())
    net.hybridize(static_alloc=True)
    x = mx.nd.NDArray(torch.randn(16, 256, generator=card, device="cuda"))
    mx.random.seed(3)
    with cached_op.eager():
        eager = _random_block_steps(net, x)
    mx.random.seed(3)
    cached_op.reset_replay_counts()
    compiled = _random_block_steps(net, x)
    assert cached_op.replay_counts()["forward"] == 2
    for e, c in zip(eager, compiled):
        for a, b in zip(e, c):
            assert torch.equal(a, b)
    for i in (1, 2):
        assert not torch.equal(compiled[i][1], compiled[i - 1][1])
        assert not torch.equal(compiled[i][2] != 0, compiled[i - 1][2] != 0)


def test_capture_with_an_unregistered_generator_raises(card, monkeypatch):
    """A capture whose random op draws from a generator the graph does
    not hold raises naming the op; it does not run eagerly instead."""
    import chip_smoke
    import mxnet_tpu_torch as mx
    net = chip_smoke.random_block(mx, units=64, groups=4)
    net.initialize()
    net.hybridize()
    monkeypatch.setattr(torch.cuda.CUDAGraph, "register_generator_state",
                        lambda self, gen: None, raising=False)
    x = mx.nd.NDArray(torch.randn(8, 64, generator=card, device="cuda"))
    with mx.autograd.train_mode():
        with pytest.raises(MXNetError, match="_random_normal"):
            for _ in range(2):
                net(x)


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss_card_matches_cpu(card, blank):
    """The same recursion on the card and on the CPU: the loss within
    1e-5 relative, the gradient within 1e-4 + 1e-4 relative."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(0)
    T, N, C, L = 40, 8, 500, 12
    acts = rs.randn(T, N, C).astype(np.float32)
    lab = rs.randint(1, C, (N, L)).astype(np.float32)
    llen = rs.randint(1, L + 1, N)
    if blank == "last":
        lab -= 1
    lab[np.arange(L)[None, :] >= llen[:, None]] = \
        0.0 if blank == "first" else -1.0
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        x = mx.nd.array(acts, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.CTCLoss(x, mx.nd.array(lab, ctx=ctx),
                                 blank_label=blank)
        loss.backward()
        res.append((loss.asnumpy(), x.grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-4, atol=1e-4)


def test_softmax_output_card_matches_cpu(card):
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(1)
    d = rs.randn(256, 1000).astype(np.float32) * 3
    lab = rs.randint(0, 1000, 256).astype(np.float32)
    lab[::5] = -1
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        x = mx.nd.array(d, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            p = mx.nd.SoftmaxOutput(x, mx.nd.array(lab, ctx=ctx),
                                    use_ignore=True, normalization="valid")
        p.backward()
        res.append((p.asnumpy(), x.grad.asnumpy()))
    for g, r in zip(res[1], res[0]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# the rest of the op registry: tensor_tail, matrix with linalg, the five
# contrib ops, vision_ops
# ---------------------------------------------------------------------------
def _ssd_candidates(rs, B, N=8732):
    """(B, N, 6) rows [class, score, x1, y1, x2, y2]: clustered boxes in
    [0, 1], 20 classes, scores in [0, 1)."""
    xy = rs.uniform(0, 0.8, (B, N, 2))
    wh = rs.uniform(0.02, 0.3, (B, N, 2))
    return np.concatenate([rs.randint(0, 20, (B, N, 1)),
                           rs.uniform(0, 1, (B, N, 1)), xy, xy + wh],
                          -1).astype(np.float32)


@pytest.mark.parametrize("topk", [-1, 400])
def test_box_nms_ssd_width_card_matches_cpu(card, topk):
    """box_nms over SSD-300's 8732 candidates, all of them or the top
    400: the card's output equals the CPU's bit for bit (the IoUs are
    elementwise f32 operations on both, the sort is stable)."""
    import mxnet_tpu_torch as mx
    det = _ssd_candidates(np.random.RandomState(2), 2)
    out = [mx.nd._contrib_box_nms(
        mx.nd.array(det, ctx=ctx), overlap_thresh=0.45, valid_thresh=0.01,
        topk=topk, id_index=0).asnumpy() for ctx in (mx.cpu(), mx.gpu(0))]
    np.testing.assert_array_equal(out[1], out[0])
    assert (out[1][..., 1] > 0).sum() <= (2 * topk if topk > 0 else 2 * 8732)


def test_roi_align_backward_card_matches_cpu(card):
    """ROIAlign forward and backward at a Faster R-CNN-like (2, 64, 38,
    63) map, 64 ROIs: within 1e-5 relative, and 1e-5 of the largest
    gradient (the card adds the taps' gradients in another order)."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(3)
    data = rs.randn(2, 64, 38, 63).astype(np.float32)
    wh = rs.uniform(16, 400, (64, 2))
    x1 = rs.uniform(0, 1000 - wh[:, 0])
    y1 = rs.uniform(0, 600 - wh[:, 1])
    rois = np.stack([rs.randint(0, 2, 64), x1, y1, x1 + wh[:, 0],
                     y1 + wh[:, 1]], 1).astype(np.float32)
    head = rs.rand(64, 64, 7, 7).astype(np.float32)
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        x = mx.nd.array(data, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd._contrib_ROIAlign(x, mx.nd.array(rois, ctx=ctx),
                                        pooled_size=(7, 7),
                                        spatial_scale=1 / 16,
                                        sample_ratio=2)
        y.backward(mx.nd.array(head, ctx=ctx))
        res.append((y.asnumpy(), x.grad.asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5, atol=1e-6)
    scale = np.abs(res[0][1]).max()
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5,
                               atol=1e-5 * scale)


def test_linalg_syevd_gelqf_on_the_card(card):
    """cuSOLVER may choose other signs than LAPACK: the card is held to
    what is unique, the reconstructions A = U^T diag(l) U and A = L Q,
    the orthogonality of U and Q, and the eigenvalues against the CPU's,
    each within 1e-4 of the largest entry."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(4)
    x = rs.randn(16, 32, 32)
    spd = (x @ x.transpose(0, 2, 1) / 32 + np.eye(32)).astype(np.float32)
    U, lam = mx.nd.linalg_syevd(mx.nd.array(spd, ctx=mx.gpu(0)))
    u, l = U.asnumpy().astype(np.float64), lam.asnumpy().astype(np.float64)
    recon = u.transpose(0, 2, 1) @ (l[..., None] * u)
    assert np.abs(recon - spd).max() <= 1e-4 * np.abs(spd).max()
    assert np.abs(u @ u.transpose(0, 2, 1) - np.eye(32)).max() <= 1e-4
    _, lam_cpu = mx.nd.linalg_syevd(mx.nd.array(spd, ctx=mx.cpu()))
    assert np.abs(l - lam_cpu.asnumpy()).max() <= 1e-4 * np.abs(l).max()
    a = rs.randn(16, 12, 32).astype(np.float32)
    Q, L = mx.nd.linalg_gelqf(mx.nd.array(a, ctx=mx.gpu(0)))
    q, lo = Q.asnumpy().astype(np.float64), L.asnumpy().astype(np.float64)
    assert np.abs(lo @ q - a).max() <= 1e-4 * np.abs(a).max()
    assert np.abs(q @ q.transpose(0, 2, 1) - np.eye(12)).max() <= 1e-4
    assert np.abs(np.triu(lo, 1)).max() == 0


def test_boolean_mask_eager_on_the_card(card):
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(5)
    data = rs.randn(100, 7).astype(np.float32)
    keep = (rs.rand(100) > 0.3).astype(np.float32)
    out = mx.nd._contrib_boolean_mask(mx.nd.array(data, ctx=mx.gpu(0)),
                                      mx.nd.array(keep, ctx=mx.gpu(0)))
    np.testing.assert_array_equal(out.asnumpy(), data[keep > 0])


def test_hybridized_ssd_head_bit_for_bit_with_eager(card):
    """SSD's detection head (MultiBoxDetection, NMS 0.45 over the top
    400) captured in a CUDA graph equals its eager twin bit for bit, and
    the graph is replayed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op

    class Head(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, c, l, a):
            return F._contrib_MultiBoxDetection(c, l, a, nms_threshold=0.45,
                                                nms_topk=400)
    rs = np.random.RandomState(6)
    N = 8732
    logits = rs.randn(2, 21, N) * 2
    cls = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    loc = (rs.randn(2, N * 4) * 0.5).astype(np.float32)
    anchors = _ssd_candidates(rs, 1)[..., 2:]
    ins = [mx.nd.array(a, ctx=mx.gpu(0)) for a in (cls, loc, anchors)]
    head = Head()
    with cached_op.eager():
        want = head(*ins).asnumpy()
    head.hybridize()
    cached_op.reset_replay_counts()
    for _ in range(3):
        got = head(*ins).asnumpy()
    assert cached_op.replay_counts()["forward"] >= 2
    np.testing.assert_array_equal(got, want)


NO_SYNC_OPS = [
    ("linalg_potrf", lambda nd, a, e: nd.linalg_potrf(a)),
    ("linalg_potri", lambda nd, a, e: nd.linalg_potri(nd.linalg_potrf(a))),
    ("linalg_trsm", lambda nd, a, e: nd.linalg_trsm(nd.linalg_potrf(a), a)),
    ("linalg_inverse", lambda nd, a, e: nd.linalg_inverse(a)),
    ("linalg_det", lambda nd, a, e: nd.linalg_det(a)),
    ("linalg_slogdet", lambda nd, a, e: nd.linalg_slogdet(a)[1]),
    ("linalg_gelqf", lambda nd, a, e: nd.linalg_gelqf(a)[0]),
    ("linalg_maketrian", lambda nd, a, e: nd.linalg_maketrian(
        nd.linalg_extracttrian(a))),
    ("ROIPooling", lambda nd, a, e: nd.ROIPooling(
        a.reshape((2, 8, 4, 8)), e["rois"], pooled_size=(2, 3),
        spatial_scale=0.25)),
    ("ROIAlign", lambda nd, a, e: nd._contrib_ROIAlign(
        a.reshape((2, 8, 4, 8)), e["rois"], pooled_size=(2, 3),
        spatial_scale=0.25, sample_ratio=2)),
    ("box_nms", lambda nd, a, e: nd._contrib_box_nms(
        a.reshape((4, 16, 8))[..., :6], topk=5)),
    ("MultiBoxTarget", lambda nd, a, e: nd._contrib_MultiBoxTarget(
        nd.abs(a.reshape((1, 128, 4))) / 8, e["label"],
        a.reshape((1, 4, 128)))[0]),
    ("bipartite_matching", lambda nd, a, e: nd._contrib_bipartite_matching(
        a.reshape((4, 16, 8)), threshold=0.1)[0]),
]


@pytest.mark.parametrize("name,fn", NO_SYNC_OPS,
                         ids=[n for n, _ in NO_SYNC_OPS])
def test_new_ops_read_nothing_back_on_the_card(card, name, fn):
    """None of these ops waits on the card from the host (torch's sync
    debug mode turns a synchronising call into an error): each can be
    captured in a CUDA graph. linalg_syevd is not among them: torch's
    eigh checks its status on the host (ROADMAP.md queue 3)."""
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(7)
    x = rs.randn(8, 8, 8).astype(np.float32)
    gpu = mx.gpu(0)
    a = mx.nd.array(x @ x.transpose(0, 2, 1) + 8 * np.eye(8, dtype=np.float32),
                    ctx=gpu)
    extra = {"rois": mx.nd.array([[0, 1, 1, 30, 20], [1, 0, 5, 60, 40]],
                                 ctx=gpu),
             "label": mx.nd.array([[[0, 0.1, 0.1, 0.5, 0.5]]], ctx=gpu)}
    torch.cuda.synchronize()
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(mx.nd, a, extra)
    finally:
        torch.cuda.set_sync_debug_mode(old)
    assert np.isfinite(out.asnumpy()).all()


# ---------------------------------------------------------------------------
# the NHWC layout pass and the dependency engine on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def layout_env(monkeypatch):
    def set_flag(flag):
        monkeypatch.setenv("MXNET_LAYOUT_OPT", flag)
    return set_flag


def _conv_net(mx, prefix):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Conv2D(32, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(32, 3, padding=1, groups=4), nn.BatchNorm(),
                nn.Conv2D(64, 1), nn.GlobalAvgPool2D(), nn.Dense(10))
    return net


@pytest.fixture
def full_f32():
    """f32 convolutions and matmuls in full f32, cuDNN's TF32 off too
    (chip_smoke's ``_no_tf32``), under cuDNN's deterministic algorithms
    (some of its f32 weight-gradient algorithms add with atomics, in
    another order from run to run)."""
    import chip_smoke
    with chip_smoke._no_tf32(), chip_smoke._deterministic():
        yield


def _conv_runs(seed, flag, layout_env, fault=False, dtype="float32"):
    """Three recorded steps of the conv net eager and hybridized (a
    fresh net each, one seed), with MXNET_LAYOUT_OPT=flag, in f32 or
    under ``dtype`` AMP: (output, gradients by name) both ways, and the
    hybridized net."""
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib import amp
    layout_env(flag)
    if dtype != "float32":
        amp.init(target_dtype=dtype)
    try:
        return _conv_steps(chip_smoke, mx, seed, fault)
    finally:
        amp.reset()


def _conv_steps(chip_smoke, mx, seed, fault):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = mx.nd.NDArray(torch.randn(8, 16, 32, 32, generator=g,
                                  device="cuda"))
    out = []
    for hybrid in (False, True):
        mx.random.seed(seed)
        net = _conv_net(mx, "cn_")
        net.initialize(mx.init.Xavier())
        if hybrid:
            net.hybridize(static_alloc=True, static_shape=True)
        # three steps each way (warm-up, capture, replay): BatchNorm
        # shifts its statistics by the moving mean, which each updates
        with chip_smoke._mirrored_kernels(fault and hybrid):
            for _ in range(3):
                with mx.autograd.record():
                    y = net(x)
                    loss = (y * y).sum()
                loss.backward()
        out.append((y.tensor().clone(), {
            n: p.grad().tensor().clone()
            for n, p in net.collect_params().items()
            if p.grad_req != "null"}))
    torch.cuda.synchronize()
    return out, net


# the pass against eager: twice the largest reading over seeds 0-4 on an
# H100 80GB HBM3 at 700 W (relative L2 distances; the gradients as one
# vector, the elided biases apart), cuDNN deterministic. In f32 with
# TF32 off no conv opens an island: bit for bit. Under bf16 AMP the
# ungrouped convs run channels-last: output 0, gradients 3.70e-5-1.37e-4
# (which backward kernel parts them was not measured). Mirrored kernels:
# output 0.783-1.03, gradients 0.963-1.20 in both.
LAYOUT_CARD_LIMIT = {"float32": {"output": 0.0, "gradients": 0.0},
                     "bfloat16": {"output": 0.0, "gradients": 2.7352e-4}}


def test_layout_pass_off_is_eager_bit_for_bit(card, full_f32, layout_env):
    """With MXNET_LAYOUT_OPT=0 the captured conv net replays its eager
    steps bit for bit (output and every gradient)."""
    (eager, hyb), net = _conv_runs(0, "0", layout_env)
    assert net._cached_op.layout_plan() is None
    assert torch.equal(hyb[0], eager[0])
    assert all(torch.equal(hyb[1][n], eager[1][n]) for n in eager[1])


def _layout_reading(eager, hyb, skip):
    def cat(d):
        return torch.cat([d[n].flatten() for n in d if n not in skip])

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())
    return {"output": rel(hyb[0], eager[0]),
            "gradients": rel(cat(hyb[1]), cat(eager[1]))}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_pass_on_the_card(card, full_f32, layout_env, dtype, seed):
    """With MXNET_LAYOUT_OPT=1: the plan (in f32 with TF32 off no
    island; under bf16 AMP the grouped conv stays out of the islands;
    the biases before BatchNorm elided), the output leaves contiguous,
    the elided biases' gradients exactly zero, the output and the other
    gradients within LAYOUT_CARD_LIMIT of the eager steps; with every
    kernel of the hybridized call mirrored (the planted fault), beyond
    it."""
    (eager, hyb), net = _conv_runs(seed, "1", layout_env, dtype=dtype)
    island = dtype != "float32"
    assert net._cached_op.layout_plan() == [(island, True), (False, True),
                                            (island, False)]
    assert hyb[0].is_contiguous()
    # the first two convs' biases feed BatchNorms: elided
    elided = [n for n in eager[1] if n.endswith("bias") and "conv" in n][:2]
    assert all(not hyb[1][n].any() for n in elided)
    reading = _layout_reading(eager, hyb, elided)
    (eager_f, bad), _ = _conv_runs(seed, "1", layout_env, fault=True,
                                   dtype=dtype)
    fault = _layout_reading(eager_f, bad, elided)
    print("[layout] %s seed %d: reading %s, planted fault %s"
          % (dtype, seed, reading, fault))
    limits = LAYOUT_CARD_LIMIT[dtype]
    for k, limit in limits.items():
        assert reading[k] <= limit, (k, reading)
    assert any(fault[k] > limit for k, limit in limits.items())


@pytest.mark.parametrize("axes", [(2, 3), ()])
def test_dropout_after_a_channels_last_conv(card, axes):
    """A dropout (structured, or row 8's full-shape kernel) on a
    channels-last conv output gives the same mask and values as on the
    same logical tensor in NCHW, from the same seed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as nn_ops
    x = torch.randn(4, 64, 14, 14, generator=card, device="cuda")
    w = torch.randn(64, 64, 3, 3, generator=card, device="cuda") * 0.05
    y = torch.nn.functional.conv2d(
        x.contiguous(memory_format=torch.channels_last),
        w.contiguous(memory_format=torch.channels_last), None, 1, 1)
    assert y.is_contiguous(memory_format=torch.channels_last)
    got = []
    for t in (y, y.contiguous()):
        mx.random.seed(5)
        got.append(nn_ops.dropout_op(t, p=0.5, axes=axes, _train=True))
    assert torch.equal(got[0], got[1])


def test_s2d_stem_on_the_card(card):
    """The S2D stem at ResNet's shape in bf16 within bf16 rounding of
    the plain convolution (the relative L2 distance below 1e-2)."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    x = torch.randn(8, 3, 224, 224, generator=card,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn(64, 3, 7, 7, generator=card, device="cuda")
         * 0.1).to(torch.bfloat16)
    s2d = nn_ops._stem_s2d_conv(x, w).float()
    plain = torch.nn.functional.conv2d(x, w, None, 2, 3).float()
    assert float((s2d - plain).norm() / plain.norm()) < 1e-2


def _register_card_ops(mx):
    from mxnet_tpu_torch import operator as op_mod
    if op_mod.get_prop("card_scale") is not None:
        return

    class Scale(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            import time
            time.sleep(0.05)
            self.assign(out_data[0], req[0], in_data[0] * 3 + 1)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 3)

    @mx.operator.register("card_scale")
    class ScaleProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Scale()

    class Boom(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise ValueError("card custom op failed")

    @mx.operator.register("card_boom")
    class BoomProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Boom()


def test_engine_custom_op_on_card_tensors(card):
    """nd.Custom on CUDA arrays through the engine: the call returns
    gated arrays, the worker waits for the caller's stream, the values
    and gradients equal the inline callback's bit for bit, and a chain
    of two calls orders by its read dependency."""
    import contextlib
    from unittest import mock
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import operator as op_mod
    _register_card_ops(mx)
    base = torch.randn(1 << 20, generator=card, device="cuda")
    runs = []
    for inline in (False, True):
        x = mx.nd.NDArray(base * 2)     # queued on the caller's stream
        x.attach_grad()
        patch = mock.patch.object(op_mod._cached_op, "in_call",
                                  lambda: True) if inline \
            else contextlib.nullcontext()
        with patch, mx.autograd.record():
            y = mx.nd.Custom(x, op_type="card_scale")
            gated = y._pending is not None
            z = mx.nd.Custom(y, op_type="card_scale")
            loss = (z * z).sum()
        loss.backward()
        assert gated != inline
        runs.append((z.tensor().clone(), x.grad.tensor().clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_engine_error_at_wait_on_the_card(card):
    import mxnet_tpu_torch as mx
    _register_card_ops(mx)
    x = mx.nd.NDArray(torch.ones(16, device="cuda"))
    y = mx.nd.Custom(x, op_type="card_boom")
    with pytest.raises(ValueError, match="card custom op failed"):
        y.wait_to_read()
    assert float((x * 2).sum().asscalar()) == 32.0


def test_naive_engine_syncs_and_spares_captures(card):
    """Under NaiveEngine every op's output is ready when the op returns
    (its stream synchronised), and a hybridized block still captures
    (no synchronisation inside a capture) with the same result."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op, engine
    eng = engine.engine()
    net = mx.gluon.nn.Dense(64, in_units=256)
    net.initialize()
    x = mx.nd.NDArray(torch.randn(32, 256, generator=card, device="cuda"))
    with cached_op.eager():
        want = net(x).tensor().clone()
    net.hybridize(static_alloc=True)
    eng.set_naive(True)
    try:
        y = x * 2
        assert torch.cuda.current_stream().query()
        for _ in range(3):
            got = net(x)
        assert torch.equal(got.tensor(), want)
        assert cached_op.replay_counts()["forward"] >= 1
    finally:
        eng.set_naive(False)
    assert float(y.sum().asscalar()) == pytest.approx(
        float(x.sum().asscalar()) * 2, rel=1e-5)


# ---------------------------------------------------------------------------
# the runtime services on the card: telemetry, compilewatch, modelwatch,
# checkpoints, the profiler's device trace
# ---------------------------------------------------------------------------
def card_gen():
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture
def services(card, monkeypatch):
    """MXNET_TELEMETRY and MXNET_MODELWATCH on, the registries empty;
    everything off again after."""
    import mxnet_tpu_torch as mx
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_MODELWATCH", "1")
    for mod in (mx.telemetry, mx.compilewatch, mx.modelwatch):
        getattr(mod, "refresh", lambda: None)()
        mod.reset()
    yield mx
    monkeypatch.delenv("MXNET_TELEMETRY")
    monkeypatch.delenv("MXNET_MODELWATCH")
    mx.telemetry.refresh()
    mx.telemetry.reset()
    mx.compilewatch.reset()
    mx.modelwatch.reset()
    mx.autograd.disarm_fused_update()
    mx.autograd.flush_pending_step()


def _services_steps(mx, steps, guard=None):
    """The small BERT hybridized, trained by SGD with momentum; returns
    (the trainer, the compilewatch record counts after each step)."""
    net, mlm, params, batch = _small_bert(mx, 0.1)
    for block in (net, mlm):
        block.hybridize(static_alloc=True)
    tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.01,
                                          "momentum": 0.9})
    if guard is not None:
        tr.grad_guard = mx.guardrails.GradGuard(nonfinite=guard)
    ids, tok, lab = batch
    programs = []
    for _ in range(steps):
        with mx.autograd.record():
            seq = net(ids, tok)
            seq = seq if isinstance(seq, mx.nd.NDArray) else seq[0]
            loss = mlm(seq, lab)
        loss.backward()
        tr.step(4)
        programs.append(len(mx.compilewatch.programs()))
    return tr, programs


def test_services_compilewatch_records_the_captures(services):
    """Each program carries its warm-up and capture stages, the graph's
    memory and the FLOPs of a run; after the third step nothing is
    recorded, and each replay adds its FLOPs to mx_executed_flops_total."""
    mx = services
    tr, programs = _services_steps(mx, 6)
    assert programs[2:] == [programs[2]] * 4
    recs = {r["fn"]: r for r in mx.compilewatch.programs()}
    assert set(recs) == {"CachedOp.fwd_vjp", "autograd.fused_backward",
                         "autograd.fused_step"}
    for fn in ("CachedOp.fwd_vjp", "autograd.fused_step"):
        r = recs[fn]
        assert set(r["stages"]) == {"warmup", "capture"}, r
        assert r["captures"] == 1 and r["flops"] > 0
        assert set(r["bytes"]) == {"graph_reserved", "graph_allocated"}
    # the forward's graph keeps its residuals in its pool; the fused
    # step's may fit in memory the allocator already holds
    assert recs["CachedOp.fwd_vjp"]["bytes"]["graph_allocated"] > 0
    snap = mx.telemetry.snapshot()
    assert not any(k.startswith("mx_recaptures_total")
                   for k in snap["counters"])
    per_step = sum(r["flops"] for r in mx.compilewatch.programs()
                   if r["fn"] in ("CachedOp.fwd_vjp", "autograd.fused_step"))
    executed = mx.telemetry.counter("mx_executed_flops_total").get()
    assert executed >= 5 * per_step
    assert tr.modelwatch.samples == 6


def test_services_one_host_read_a_sampled_step(services):
    """Guard and modelwatch on: a steady step warns of one synchronising
    call, the modelwatch read the guard's verdict comes from."""
    import warnings
    mx = services
    net, mlm, params, batch = _small_bert(mx, 0.1)
    for block in (net, mlm):
        block.hybridize(static_alloc=True)
    tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.01,
                                          "momentum": 0.9})
    tr.grad_guard = mx.guardrails.GradGuard(nonfinite="skip_step")
    ids, tok, lab = batch
    counts = []
    for step in range(5):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with mx.autograd.record():
                    seq = net(ids, tok)
                    seq = seq if isinstance(seq, mx.nd.NDArray) else seq[0]
                    loss = mlm(seq, lab)
                loss.backward()
                tr.step(4)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts.append(sum("synchronizing CUDA operation" in str(w.message)
                          for w in caught))
    assert counts[2:] == [1, 1, 1], counts
    assert tr.modelwatch.sync_count == 5 and tr.grad_guard.sync_count == 5


def test_services_checkpoint_snapshot_on_the_card(services, tmp_path):
    """A checkpoint holds the weights of the step it was saved at, while
    later in-place updates run before its write lands."""
    import threading
    mx = services
    net = mx.gluon.nn.Dense(256, in_units=512)
    net.initialize()
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.5, "momentum": 0.9})
    x = mx.nd.NDArray(torch.randn(64, 512, generator=card_gen(),
                                  device="cuda"))

    def step():
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(64)
    step()
    want = {n: p.data().tensor().clone()
            for n, p in net.collect_params().items()}
    eng = mx.engine.native_engine()
    release = threading.Event()
    eng.push_async(lambda: release.wait(30),
                   write_vars=(mx.model._ckpt_var(eng),), label="hold")
    prefix = str(tmp_path / "card")
    mx.model.save_checkpoint(prefix, 1, None,
                             {n: p.data() for n, p in
                              net.collect_params().items()}, {})
    for _ in range(3):
        step()
    release.set()
    arg, _ = mx.model.load_params(prefix, 1)
    for n, w in want.items():
        assert torch.equal(arg[n].tensor(), w.cpu()), n
        assert not torch.equal(net.collect_params()[n].data().tensor(), w)


def test_services_profiler_merges_the_device_trace(services, tmp_path):
    """profile_device=True: the card's kernels join the dump under a pid
    of their own, on the host clock: each kernel starts after the host
    span that launched it began."""
    import json
    import os
    mx = services
    x = mx.nd.NDArray(torch.randn(256, 768, generator=card_gen(),
                                  device="cuda", dtype=torch.bfloat16))
    g = mx.nd.NDArray(torch.ones(768, device="cuda", dtype=torch.bfloat16))
    b = mx.nd.NDArray(torch.zeros(768, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    mx.profiler.set_config(filename=str(tmp_path / "t.json"),
                           profile_device=True)
    try:
        mx.profiler.set_state("run")
        with mx.telemetry.span("region", "user"):
            y = mx.nd.LayerNorm(x, g, b)
        torch.cuda.synchronize()
        mx.profiler.set_state("stop")
    finally:
        mx.profiler.set_config(profile_device=False)
    mx.profiler.dump(reset=True)
    events = json.load(open(str(tmp_path / "t.json")))["traceEvents"]
    region = [e for e in events if e["name"] == "region"][0]
    dev = [e for e in events if e["cat"] == "device::kernel"
           and "layer_norm_fwd" in e["name"]]
    assert dev and y.shape == (256, 768)
    assert all(e["pid"] == os.getpid() + 1 for e in dev)
    assert all("clock" not in e["args"] for e in dev)
    assert region["ts"] <= dev[0]["ts"] <= region["ts"] + 1e6


def test_services_live_bytes_on_the_card(services):
    import gc
    mx = services
    gc.collect()
    base = mx.gpu(0).memory_info()
    a = mx.nd.NDArray(torch.zeros(1024, 256, device="cuda"))
    views = [a.detach() for _ in range(5)]
    got = mx.gpu(0).memory_info()
    assert got["bytes"] == base["bytes"] + 1024 * 256 * 4
    assert got["count"] == base["count"] + 1
    del a, views
    gc.collect()
    assert mx.gpu(0).memory_info() == base


# ---------------------------------------------------------------------------
# the repaired ops inside captured graphs, and the Scheduler on the card
# ---------------------------------------------------------------------------
def _open_faults_block(mx):
    class Ops(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x, xi, yi, xu):
            return (F.topk(x, k=3, ret_typ="indices"),
                    F.topk(x, k=3, is_ascend=True, ret_typ="value"),
                    F.topk(xi, k=2, ret_typ="indices", dtype="int32"),
                    F.broadcast_mod(xi, yi), F._mod_scalar(xi, scalar=0),
                    F._rmod_scalar(yi, scalar=5), F.broadcast_mod(xu, xu),
                    F.sum(xi, axis=1), F.sum(xu), F.mean(xi, axis=1),
                    F.mean(xu))
    return Ops()


def test_open_faults_repaired_inside_a_captured_graph(card):
    """topk's tie order, integer modulo by zero and the integer
    reductions on the card, the third call a replay of the graph the
    second captured: equal to the port's CPU path, the dtypes kept."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cached_op
    rs = np.random.RandomState(0)
    x = np.array([[2, 2, 2, 1, 5, 5], [4, 4, 4, 4, 4, 4]], np.float32)
    xi = rs.randint(-5, 5, (2, 6)).astype(np.int32)
    xi[1] = 4                       # an int32 row of ties
    yi = rs.randint(0, 3, (2, 6)).astype(np.int32)
    xu = rs.randint(0, 4, (2, 6)).astype(np.uint8)
    outs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        blk = _open_faults_block(mx)
        blk.hybridize(static_alloc=True, static_shape=True)
        args = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in (x, xi, yi, xu)]
        cached_op.reset_replay_counts()
        for _ in range(3):
            res = [o.asnumpy() for o in blk(*args)]
        outs[ctx.device_type] = res
        if ctx.device_type == "gpu":
            assert cached_op.replay_counts()["forward"] >= 1
    for c, g in zip(outs["cpu"], outs["gpu"]):
        assert c.dtype == g.dtype
        np.testing.assert_array_equal(g, c)
    np.testing.assert_array_equal(outs["gpu"][0], [[4, 5, 0], [0, 1, 2]])
    np.testing.assert_array_equal(outs["gpu"][2][1], [0, 1])
    assert outs["gpu"][7].dtype == np.int32
    assert outs["gpu"][8].dtype == np.uint32
    assert outs["gpu"][9].dtype == np.float32


def test_scheduler_on_the_card_reads_nothing_inside_a_replay(card,
                                                            monkeypatch):
    """A small BERT served on the card through a Scheduler at inflight 2
    (its warm batches on the native engine, a bucket's first batch, its
    capture, on the batcher's thread): from the staging copies through
    the replay up to the outputs' host copy, a warm batch waits on the
    card from the host nowhere (torch's sync debug mode turns a
    synchronising call there into an error), and each output, the
    decoder's own columns included, equals the session's direct infer
    bit for bit (one batch bucket: the same graph)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.serve import Scheduler, TenantConfig
    mx.random.seed(0)
    net = BERTModel(num_layers=2, units=64, hidden_size=128, num_heads=4,
                    max_length=64, vocab_size=100, dropout=0.0)
    net.initialize(ctx=mx.gpu(0))
    rs = np.random.RandomState(1)
    ids = mx.nd.array(rs.randint(0, 100, (4, 16)), ctx=mx.gpu(0))
    tok = mx.nd.array(rs.randint(0, 2, (4, 16)), ctx=mx.gpu(0))
    net(ids, tok)
    net.cast("bfloat16")
    sess = net.serve_session(ids, tok, seq_axis=1, max_batch=4, max_seq=32,
                             buckets="4;16,32")
    real = sess._run
    strict, errors = [], []

    def strict_run(hosts, bucket):
        if bucket not in sess._warm:
            return real(hosts, bucket)      # the capture
        old = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(hosts, bucket)
        except RuntimeError as e:
            errors.append(e)
            raise
        finally:
            torch.cuda.set_sync_debug_mode(old)
            strict.append(bucket)

    monkeypatch.setattr(sess, "_run", strict_run)
    pushed = []
    eng = engine.native_engine()
    real_push = eng.push_async

    def counting_push(fn, *a, **kw):
        pushed.append(kw.get("label"))
        return real_push(fn, *a, **kw)

    monkeypatch.setattr(eng, "push_async", counting_push)
    sched = Scheduler(sess, max_wait_ms=1, inflight=2, tenants=[
        TenantConfig("free", weight=1), TenantConfig("paid", weight=4)])
    reqs = [(rs.randint(0, 100, (int(rs.randint(1, 3)), int(L))),
             rs.randint(0, 2, (1, 1))) for L in rs.randint(4, 33, 24)]
    reqs = [(a.astype(np.int32), np.zeros_like(a, np.int32)) for a, _ in reqs]
    try:
        futs = [sched.submit(a, b, tenant="paid" if i % 2 else "free")
                for i, (a, b) in enumerate(reqs)]
        outs = [f.result(120) for f in futs]
    finally:
        sched.close()
    assert not errors and strict
    assert pushed and set(pushed) == {"serve.batch"}
    for (a, b), got in zip(reqs, outs):
        want = sess.infer(a, b)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        rows, seq = a.shape
        own = want[3][:seq, :rows]
        assert any(np.array_equal(got[3][:seq, off:off + rows], own)
                   for off in range(got[3].shape[1] - rows + 1))


# ---------------------------------------------------------------------------
# the kvstore on the card (tests/test_torch_kvstore.py and
# tests/test_torch_dist.py hold the rest on the CPU)
# ---------------------------------------------------------------------------
def test_kvstore_on_cuda_tensors_in_one_process(card):
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(0)
    a, b = (rs.randn(64, 33).astype(np.float32) for _ in range(2))
    ctxs = [mx.gpu(0), mx.cpu(0)]
    kv = mx.kvstore.create("device")
    kv.init("w", mx.nd.zeros((64, 33), ctx=ctxs[0]))
    vals = [mx.nd.array(a, ctx=ctxs[0]), mx.nd.array(b, ctx=ctxs[1])]
    kv.pushpull_list(["w"], [vals])
    out = mx.nd.zeros((64, 33), ctx=mx.cpu())
    kv.pull("w", out=out)
    for got in (vals[0], vals[1], out):
        np.testing.assert_array_equal(got.asnumpy(), a + b)
    assert vals[0].tensor().is_cuda and not vals[1].tensor().is_cuda
    if torch.cuda.device_count() >= 2:
        kv = mx.kvstore.create("nccl")
        vals = [mx.nd.array(a, ctx=mx.gpu(0)), mx.nd.array(b, ctx=mx.gpu(1))]
        kv.init("w", vals[0])
        kv.pushpull_list(["w"], [vals])
        for got in vals:
            np.testing.assert_array_equal(got.asnumpy(), a + b)


def _card_launch(n):
    import json
    import os
    import signal
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TEST_CASE="card")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n),
         sys.executable, os.path.join(root, "tests", "torch_dist_worker.py")],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the launch timed out")
    assert proc.returncode == 0, (out, err[-3000:])
    res = [json.loads(line[7:]) for line in out.splitlines()
           if line.startswith("RESULT ")]
    return sorted(res, key=lambda r: r["rank"])


def test_dist_sync_world_size_1_on_nccl(card):
    (r,) = _card_launch(1)
    assert (r["nw"], r["backend"], r["ctx"]) == (1, "nccl", "gpu(0)")
    assert r["device"] == "cuda:0" and r["sum_err"] == 0.0


def test_dist_sync_two_ranks_sharing_the_card_on_gloo(card):
    """Two ranks on one card: NCCL refuses them, so the group is gloo
    (with two cards each rank takes its own, on NCCL)."""
    res = _card_launch(2)
    two = torch.cuda.device_count() >= 2
    assert [r["backend"] for r in res] == ["nccl" if two else "gloo"] * 2
    assert [r["device"] for r in res] == (["cuda:0", "cuda:1"] if two
                                          else ["cuda:0", "cuda:0"])
    assert all(r["sum_err"] == 0.0 for r in res)
    assert res[0]["digest"] == res[1]["digest"]


# ---------------------------------------------------------------------------
# the sharded step (parallel/sharded.py): one captured program a step
# ---------------------------------------------------------------------------
def _sharded_mlp(dropout=0.0, **kw):
    """A two-layer MLP (a Dropout between) trained by ShardedTrainStep on
    dp=1 over gpu(0), LAMB in bf16; its step and a batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import (MeshConfig, P, ShardedTrainStep,
                                          make_mesh)
    nn = mx.gluon.nn
    mx.random.seed(0)
    net = nn.HybridSequential(prefix="shc_")
    net.add(nn.Dense(256, activation="relu", in_units=128, prefix="shc0_"))
    if dropout:
        net.add(nn.Dropout(dropout))
    net.add(nn.Dense(16, in_units=256, prefix="shc1_"))
    net.initialize(ctx=mx.gpu(0))
    opts = dict(optimizer="lamb", lr=1e-3, dtype="bfloat16",
                data_specs=[P(), P()], seed=3)
    opts.update(kw)
    step = ShardedTrainStep(net, mx.gluon.loss.L2Loss(),
                            make_mesh(MeshConfig(dp=1), devices=[mx.gpu(0)]),
                            **opts)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(64, 128, generator=g, device="cuda")
    y = torch.randn(64, 16, generator=g, device="cuda")
    return step, (mx.nd.NDArray(x), mx.nd.NDArray(y))


def _sharded_bits(step):
    return {k: v.tensor().view(torch.int32).clone()
            for k, v in step.params.items()}


def test_sharded_step_captured_equals_eager(card):
    """Four steps captured (the first eager, the second the capture)
    and four eager (``cached_op.eager()``): losses and masters bit for
    bit; the step records its form."""
    from mxnet_tpu_torch import cached_op
    runs = []
    for eager in (False, True):
        step, batch = _sharded_mlp()
        scope = cached_op.eager() if eager else contextlib.nullcontext()
        with scope:
            losses = [step.step(*batch).tensor().item() for _ in range(4)]
        runs.append((losses, _sharded_bits(step), step.form))
    assert runs[0][2] == "captured" and runs[1][2] == "eager"
    assert runs[0][0] == runs[1][0]
    for k, v in runs[1][1].items():
        assert torch.equal(runs[0][1][k], v), k


def test_sharded_step_dropout_draws_anew_in_replays(card):
    step, batch = _sharded_mlp(dropout=0.5, lr=0.0)
    losses = [step.step(*batch).tensor().item() for _ in range(4)]
    assert step.form == "captured" and len(set(losses)) == 4


def test_sharded_step_split_update_equals_fused(card):
    a, batch = _sharded_mlp()
    b, _ = _sharded_mlp(split_update=True)
    la = [a.step(*batch).tensor().item() for _ in range(3)]
    lb = [b.step(*batch).tensor().item() for _ in range(3)]
    assert b.form == "split" and la == lb
    for k, v in _sharded_bits(a).items():
        assert torch.equal(_sharded_bits(b)[k], v), k


def test_sharded_step_resumes_bit_for_bit_on_the_card(card, tmp_path):
    step, batch = _sharded_mlp(dropout=0.3)
    for _ in range(3):
        step.step(*batch)
    path = str(tmp_path / "st.npz")
    step.save_states(path)
    ref = [step.step(*batch).tensor().item() for _ in range(2)]
    bits = _sharded_bits(step)
    step.load_states(path)
    got = [step.step(*batch).tensor().item() for _ in range(2)]
    assert got == ref
    for k, v in bits.items():
        assert torch.equal(_sharded_bits(step)[k], v), k


# ---------------------------------------------------------------------------
# the rest of multi-GPU over a card and the host (chip_smoke.py phase 26)
# ---------------------------------------------------------------------------
def _card_host_mesh(axis):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.mesh import contexts_mesh
    return contexts_mesh([mx.gpu(0), mx.cpu(0)], (axis,))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_card_and_host(card, no_tf32, causal):
    """Ring attention over [gpu(0), cpu(0)]: the output and the q, k, v
    gradients (taken on each device, the card's on autograd's device
    thread) against one card, f32."""
    from mxnet_tpu_torch import parallel as par
    from chip_smoke import _causal_attention
    shape = (2, 64, 4, 16)
    q, k, v, cot = (torch.randn(shape, generator=torch.Generator()
                                .manual_seed(i)) for i in range(4))
    spec = par.P(None, "sp", None, None)

    def body(a, b, c, g):
        ts = [x.tensor().detach().requires_grad_(True) for x in (a, b, c)]
        with torch.enable_grad():
            o = par.ring_attention(*ts, "sp", causal=causal)
            grads = torch.autograd.grad(o, ts, g.tensor())
        return [o.detach()] + list(grads)
    f = par.shard_map(body, mesh=_card_host_mesh("sp"), in_specs=(spec,) * 4,
                      out_specs=[spec] * 4)
    got = [x.tensor().cuda() for x in f(q, k, v, cot)]
    qq, kk, vv = (x.cuda().requires_grad_(True) for x in (q, k, v))
    ref = _causal_attention(qq, kk, vv) if causal else \
        par.local_attention(qq, kk, vv)
    want = [ref.detach()] + list(torch.autograd.grad(ref, [qq, kk, vv],
                                                     cot.cuda()))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_pipeline_card_and_host(card, no_tf32):
    """make_pipeline_step over [gpu(0), cpu(0)]: the stage on the card
    differentiates through the permute from autograd's device thread;
    the update equals the two stages in sequence on the card."""
    from mxnet_tpu_torch import parallel as par
    g = torch.Generator().manual_seed(3)
    W = torch.randn(2, 8, 8, generator=g) * 0.3
    x = torch.randn(3, 4, 8, generator=g)
    y = torch.randn(3, 4, 8, generator=g)
    step = par.make_pipeline_step(lambda w, t: torch.tanh(t @ w),
                                  _card_host_mesh("pp"), 3,
                                  lambda o, lab: ((o - lab) ** 2).mean(),
                                  lr=0.1)
    new, loss = step(W, x, y)
    Wc = W.cuda().requires_grad_(True)
    t = torch.tanh(torch.tanh(x.cuda() @ Wc[0]) @ Wc[1])
    ref = ((t - y.cuda()) ** 2).mean()
    gw, = torch.autograd.grad(ref, Wc)
    torch.testing.assert_close(float(loss), float(ref), rtol=1e-5, atol=0)
    torch.testing.assert_close(new.cuda(), (Wc - 0.1 * gw).detach(),
                               rtol=1e-5, atol=1e-6)


def test_mesh_session_card_and_host(card, no_tf32):
    """A Dense net served over [gpu(0), cpu(0)] with its weight split
    and the batch split: the card session's outputs, the collective
    descriptor."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import P
    net = mx.gluon.nn.Dense(16, in_units=32, prefix="meshcard_")
    net.initialize(ctx=mx.gpu(0))
    x = mx.nd.ones((4, 32), ctx=mx.gpu(0))
    ref = net.serve_session(x, max_batch=4)
    sess = net.serve_session(x, max_batch=4, mesh=_card_host_mesh("mp"),
                             param_specs=[(r".*weight", P("mp", None))],
                             data_spec=P("mp"))
    xs = np.random.RandomState(0).rand(3, 32).astype(np.float32)
    np.testing.assert_allclose(sess.infer(xs), ref.infer(xs), rtol=1e-5,
                               atol=1e-6)
    assert sess.collective_tag()["lock"] == id(sess._exec_lock)
