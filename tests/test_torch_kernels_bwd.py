"""The port's backward and dropout kernel modules against the reference's
Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain backward versions against ``jax.vjp`` of the
reference's kernel entry points (``pallas_layer_norm``,
``pallas_bias_gelu``, ``flash_selfatt``) run in Pallas interpret mode,
on the same numpy inputs. Tolerances: f32 within 1e-5 (abs + rel); bf16
within 1e-2 (abs + rel) or one bf16 ulp of the output — the bound of
tests/test_torch_kernels.py. The attention kernels compute in bf16
whatever the input dtype, so their outputs take the bf16 bound.

Attention dropout draws the reference's interpret-mode bits (the counter
hash of ``pallas_attention.py :: _keep_mask``), so its masks are held
bit for bit. The reference's dropout kernel draws from the TPU's
hardware generator and has no CPU form, so the dropout kernel is held by
distribution: keep rate, scale, the same mask in forward and backward.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas_attention import (_keep_mask, flash_selfatt,
                                            selfatt_plan)
from mxnet_tpu.ops.pallas_epilogue import pallas_bias_gelu
from mxnet_tpu.ops.pallas_norm import pallas_layer_norm

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.base import torch_dtype
from mxnet_tpu_torch.ops import (cuda_attention, cuda_dropout, cuda_epilogue,
                                 cuda_norm)


def _jax(a, dtype):
    return jnp.asarray(a, dtype=jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch_dtype(dtype))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(got, ref, dtype):
    got, ref = _host(got), _host(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        return
    err = np.abs(got - ref)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    tol = np.maximum(1e-2 + 1e-2 * np.abs(ref), ulp)
    assert (err <= tol).all(), "max err %g" % err.max()


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (4, 8, 64)])
def test_layer_norm_bwd_plain_matches_pallas_vjp(pallas_interpret, dtype,
                                                 shape):
    rng = np.random.RandomState(10)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, g_, b_: pallas_layer_norm(x_, g_, b_,
                                                          eps=1e-5),
                     _jax(x, dtype), _jax(g, dtype), _jax(b, dtype))
    rdx, rdg, rdb = vjp(_jax(dy, dtype))
    C = shape[-1]
    dx, dg, db = cuda_norm.layer_norm_bwd(
        _torch(dy, dtype).reshape(-1, C), _torch(x, dtype).reshape(-1, C),
        _torch(g, dtype), 1e-5)
    assert dx.dtype == dg.dtype == db.dtype == torch_dtype(dtype)
    assert_close(dx.reshape(shape), rdx, dtype)
    assert_close(dg, rdg, dtype)
    assert_close(db, rdb, dtype)


def test_layer_norm_op_gradients_match_reference(pallas_interpret):
    """LayerNorm through each package's autograd: the port's op reaches
    its autograd.Function, the reference's its custom_vjp."""
    import mxnet_tpu as mx
    rng = np.random.RandomState(11)
    arrs = [rng.randn(6, 5, 32).astype(np.float32),
            rng.randn(32).astype(np.float32),
            rng.randn(32).astype(np.float32)]
    head = rng.randn(6, 5, 32).astype(np.float32)

    def run(lib, ctx):
        xs = [lib.nd.array(a, ctx=ctx) for a in arrs]
        for v in xs:
            v.attach_grad()
        with lib.autograd.record():
            y = lib.nd.LayerNorm(*xs, axis=-1, eps=1e-5)
        y.backward(lib.nd.array(head, ctx=ctx))
        return [v.grad.asnumpy() for v in xs]

    for got, want in zip(run(pt, pt.cpu()), run(mx, mx.cpu())):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# bias + GeLU backward, bias + residual backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (2, 16, 40)])
def test_bias_gelu_bwd_plain_matches_pallas_vjp(pallas_interpret, dtype,
                                                shape):
    rng = np.random.RandomState(12)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(pallas_bias_gelu, _jax(x, dtype), _jax(b, dtype))
    rdx, rdb = vjp(_jax(dy, dtype))
    C = shape[-1]
    dx, db = cuda_epilogue.bias_gelu_bwd(_torch(dy, dtype).reshape(-1, C),
                                         _torch(x, dtype).reshape(-1, C),
                                         _torch(b, dtype))
    assert dx.dtype == db.dtype == torch_dtype(dtype)
    assert_close(dx.reshape(shape), rdx, dtype)
    assert_close(db, rdb, dtype)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("C", [7, 300, 768, 3072, 3076])
def test_bias_gelu_path_choice(C, dtype, aligned):
    """A thread takes a 16-byte vector (8 elements of 2 bytes, 4 of f32)
    where the rows hold a whole number of them and the pointers are
    aligned, else one element: BERT's rows in every dtype, 300 and 3076
    only in f32, 7 never."""
    e = 16 // dtype.itemsize
    want = e if aligned and C % e == 0 else 1
    assert cuda_epilogue.col_vector(C, dtype, aligned) == want
    if aligned and C in (768, 3072):
        assert want > 1
    if C == 7 or not aligned:
        assert want == 1


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("M,C", [(1, 7), (5, 7), (129, 300), (1024, 3072),
                                 (4096, 3072), (4096, 768), (100, 70000)])
def test_bias_gelu_bwd_scratch_shape(M, C, dtype, sms):
    """One f32 partial row of db per row strip: the strips cover the M
    rows with none empty, at least 8 rows a strip (4 row lanes holding 2
    rows each) where there are rows enough, about two blocks an SM over
    the column tiles."""
    for aligned in (True, False):
        strips, width = cuda_epilogue.bwd_scratch_shape(M, C, dtype,
                                                        aligned, sms)
        assert width == C and 1 <= strips <= max(1, -(-M // 8))
        rows = -(-M // strips)
        assert (strips - 1) * rows < M <= strips * rows
        vec = cuda_epilogue.col_vector(C, dtype, aligned)
        tiles = -(-(C // vec) // 64)
        assert strips * tiles <= max(2 * sms, tiles)
    if (M, C, sms) == (4096, 3072, 132):
        want = 44 if dtype == torch.bfloat16 else 22
        assert cuda_epilogue.bwd_scratch_shape(M, C, dtype, True, sms) == \
            (want, C)


def test_bias_gelu_wrappers_pick_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain versions, whatever its alignment:
    the path choice is the kernels' alone."""
    rng = np.random.RandomState(14)
    base = torch.from_numpy(rng.randn(9 * 300 + 1).astype(np.float32)
                            ).to(torch.bfloat16)
    x = base[1:].view(9, 300)          # 2 bytes off the allocation
    dy = torch.from_numpy(rng.randn(9, 300).astype(np.float32)
                          ).to(torch.bfloat16)
    b = torch.from_numpy(rng.randn(300).astype(np.float32)
                         ).to(torch.bfloat16)
    assert torch.equal(cuda_epilogue.bias_gelu(x, b),
                       cuda_epilogue.bias_gelu_plain(x, b))
    for got, want in zip(cuda_epilogue.bias_gelu_bwd(dy, x, b),
                         cuda_epilogue.bias_gelu_bwd_plain(dy, x, b)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_op_gradients_match_reference(pallas_interpret, dtype):
    """bias+GeLU and bias+residual through each package's autograd."""
    import mxnet_tpu as mx
    rng = np.random.RandomState(13)
    x = rng.randn(4, 8, 40).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    r = rng.randn(4, 8, 40).astype(np.float32)
    head = rng.randn(4, 8, 40).astype(np.float32)

    def run(lib, ctx):
        xs = [lib.nd.array(a, ctx=ctx, dtype=dtype) for a in (x, b, r)]
        for v in xs:
            v.attach_grad()
        with lib.autograd.record():
            y = lib.nd._contrib_bias_gelu(xs[0], xs[1]) + \
                lib.nd._contrib_bias_add_residual(xs[0], xs[1], xs[2])
        y.backward(lib.nd.array(head, ctx=ctx, dtype=dtype))
        return [v.grad.asnumpy().astype(np.float32) for v in xs]

    for got, want in zip(run(pt, pt.cpu()), run(mx, mx.cpu())):
        assert_close(got, want, dtype)


# ---------------------------------------------------------------------------
# attention: the plan, the mask, forward with dropout and backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,heads,batch", [
    (128, 12, 32), (13, 5, 2), (127, 16, 3), (256, 12, 2), (16, 7, 1),
    (64, 32, 2)])
def test_selfatt_plan_matches_reference(L, heads, batch):
    ref = selfatt_plan(L, heads, batch, 0.1, dtype=jnp.bfloat16)
    got = cuda_attention.selfatt_plan(L, heads, batch)
    assert {k: got[k] for k in ("bbh", "L_pad", "n_hblk", "n_blocks")} == \
        {k: ref[k] for k in ("bbh", "L_pad", "n_hblk", "n_blocks")}


@pytest.mark.parametrize("L,heads,bbh", [(13, 5, 4), (32, 12, 12),
                                         (128, 12, 12)])
def test_attention_keep_mask_is_the_reference_bit_for_bit(L, heads, bbh):
    N, p = 2, 0.1
    rng = np.random.RandomState(14)
    n_hblk = -(-heads // bbh)
    seeds = rng.randint(0, 2 ** 31 - 1, (N * n_hblk,)).astype(np.int32)
    L_pad = -(-L // 16) * 16
    thresh = min(int(p * 2 ** 32), 2 ** 32 - 1)
    blocks = [np.asarray(_keep_mask(None, jnp.int32(seeds[n * n_hblk + j]),
                                    (bbh, L_pad, L_pad), thresh, True))
              for n in range(N) for j in range(n_hblk)]
    ref = np.stack(blocks).reshape(N, n_hblk * bbh, L_pad, L_pad)
    got = cuda_attention.keep_mask(torch.from_numpy(seeds), N, heads, L, p,
                                   bbh).numpy()
    np.testing.assert_array_equal(got, ref[:, :heads, :L, :L])
    # the keep rate is 1 - p within 5 binomial sigma
    n = got.size
    assert abs(got.mean() - 0.9) <= 5 * np.sqrt(0.09 / n)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("L,heads,bbh", [(16, 4, 4), (13, 5, 4), (32, 6, 2)])
def test_selfatt_fwd_bwd_plain_matches_flash_selfatt(pallas_interpret, dtype,
                                                     p, L, heads, bbh):
    """Forward and dQKV at dropout 0 and 0.1 with the same seeds, ragged
    L and a head count that the head block does not divide."""
    N, hd = 2, 16
    rng = np.random.RandomState(15)
    qkv = rng.randn(L, N, heads * 3 * hd).astype(np.float32)
    dout = rng.randn(L, N, heads * hd).astype(np.float32)
    n_blocks = N * -(-heads // bbh)
    seeds = rng.randint(0, 2 ** 31 - 1, (n_blocks,)).astype(np.int32)
    out, vjp = jax.vjp(
        lambda x: flash_selfatt(x, jnp.asarray(seeds), heads=heads,
                                dropout=p, block_heads=bbh),
        _jax(qkv, dtype))
    dqkv, = vjp(_jax(dout, dtype))
    s = torch.from_numpy(seeds)
    got = cuda_attention.selfatt(_torch(qkv, dtype), heads, p, s, bbh)
    dgot = cuda_attention.selfatt_bwd(_torch(qkv, dtype),
                                      _torch(dout, dtype), heads, p, s, bbh)
    assert got.dtype == dgot.dtype == torch_dtype(dtype)
    assert_close(got, out, "bfloat16")
    assert_close(dgot, dqkv, "bfloat16")
    # the same rounding points: all but a few elements bit-equal (sums in
    # another order flip a rounding now and then, at most 0.08% here; a
    # misplaced rounding point, such as dV from a bf16 Pd, leaves 86%)
    for a, b in ((got, out), (dgot, dqkv)):
        assert (_host(a) == _host(b)).mean() >= 0.99


def test_selfatt_fn_gradient_through_the_op_matches_reference(
        pallas_interpret):
    """``_contrib_sdp_selfatt`` in train mode through each package's
    autograd at dropout 0 (the seeds differ between the packages, so
    dropout > 0 is held by the kernel-level test above)."""
    import mxnet_tpu as mx
    rng = np.random.RandomState(16)
    qkv = rng.randn(9, 2, 4 * 3 * 8).astype(np.float32)
    head = rng.randn(9, 2, 4 * 8).astype(np.float32)

    def run(lib, ctx):
        x = lib.nd.array(qkv, ctx=ctx, dtype="bfloat16")
        x.attach_grad()
        with lib.autograd.record():
            y = lib.nd._contrib_sdp_selfatt(x, heads=4, dropout=0.0)
        y.backward(lib.nd.array(head, ctx=ctx, dtype="bfloat16"))
        return y.asnumpy().astype(np.float32), \
            x.grad.asnumpy().astype(np.float32)

    for got, want in zip(run(pt, pt.cpu()), run(mx, mx.cpu())):
        assert_close(got, want, "bfloat16")


def test_selfatt_plain_f32_twin_drops_only_the_roundings():
    """``rounding=False`` (chip_smoke's f32 yardstick) computes the same
    function with the same mask: it agrees with the bf16 path to bf16
    precision and differs from it."""
    rng = np.random.RandomState(17)
    qkv = torch.from_numpy(rng.randn(16, 2, 2 * 3 * 8).astype(np.float32))
    s = torch.tensor([5, 77], dtype=torch.int32)
    a = cuda_attention.selfatt_plain(qkv, 2, 0.1, s)
    b = cuda_attention.selfatt_plain(qkv, 2, 0.1, s, rounding=False)
    assert not torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-2, atol=3e-2)
    dout = torch.from_numpy(rng.randn(16, 2, 16).astype(np.float32))
    da = cuda_attention.selfatt_bwd_plain(qkv, dout, 2, 0.1, s)
    db = cuda_attention.selfatt_bwd_plain(qkv, dout, 2, 0.1, s,
                                          rounding=False)
    np.testing.assert_allclose(da.numpy(), db.numpy(), rtol=5e-2, atol=5e-2)


def _att_case(p=0.1, L=24, N=2, heads=3, hd=16, seed=18):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(L, N, heads * 3 * hd).astype(np.float32)
                           * 2).to(torch.bfloat16)
    dout = torch.from_numpy(rng.randn(L, N, heads * hd).astype(
        np.float32)).to(torch.bfloat16)
    plan = cuda_attention.selfatt_plan(L, heads, N)
    seeds = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, (plan["n_blocks"],))
                             .astype(np.int32))
    return qkv, dout, (heads, p, seeds, plan["bbh"])


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_selfatt_float64_summed_witness_agrees_with_the_plain_version(p):
    """``sum_dtype=torch.float64`` (the card test's witness) computes the
    same function: within the bf16 bound of the f32-summed plain
    version, forward and backward."""
    qkv, dout, args = _att_case(p)
    for fn, extra in ((cuda_attention.selfatt_plain, ()),
                      (cuda_attention.selfatt_bwd_plain, (dout,))):
        ref = fn(qkv, *extra, *args)
        wit = fn(qkv, *extra, *args, sum_dtype=torch.float64)
        assert wit.dtype == ref.dtype == torch.bfloat16
        assert_close(wit, ref, "bfloat16")


def test_selfatt_plain_default_sums_are_the_f32_einsums():
    """The default ``sum_dtype`` leaves the plain versions bit for bit the
    f32 einsums of their arithmetic written out."""
    qkv, dout, args = _att_case()
    heads, p, seeds, bbh = args
    L, N, hd = qkv.shape[0], qkv.shape[1], qkv.shape[2] // (3 * heads)
    bf = torch.bfloat16
    x = qkv.float().reshape(L, N, heads, 3, hd)
    q, k, v = x[:, :, :, 0] * hd ** -0.5, x[:, :, :, 1], x[:, :, :, 2]
    s = torch.einsum("lnhd,mnhd->nhlm", q, k)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    prob = e / e.sum(dim=-1, keepdim=True)
    mask = cuda_attention.keep_mask(seeds, N, heads, L, p, bbh)
    keep = torch.full((), 1.0 - p, dtype=torch.float32)
    pd = torch.where(mask, prob / keep, 0.0)
    o = torch.einsum("nhlm,mnhd->lnhd", pd.to(bf).float(), v).to(bf)
    assert torch.equal(cuda_attention.selfatt_plain(qkv, *args),
                       o.reshape(L, N, heads * hd))
    do = dout.float().reshape(L, N, heads, hd)
    dp = torch.where(mask, torch.einsum("lnhd,mnhd->nhlm", do, v) / keep,
                     0.0)
    dv = torch.einsum("nhlm,lnhd->mnhd", pd, do)
    ds = (prob * (dp - (dp * prob).sum(dim=-1, keepdim=True))).to(bf).float()
    dq = torch.einsum("nhlm,mnhd->lnhd", ds, k) * hd ** -0.5
    dk = torch.einsum("nhlm,lnhd->mnhd", ds, q.to(bf).float())
    want = torch.stack([dq, dk, dv], dim=3).reshape(L, N, -1).to(bf)
    assert torch.equal(cuda_attention.selfatt_bwd_plain(qkv, dout, *args),
                       want)


def _witness_by_hand(qkv, dout, args, row_dtype):
    """The backward without its bf16 rounding points, its products summed
    in float64 and rounded to f32, its two row sums (the softmax
    denominator, dS's sum of dP * P) in ``row_dtype``; with the softmax
    probabilities."""
    heads, p, seeds, bbh = args
    L, N = qkv.shape[:2]
    hd = qkv.shape[2] // (3 * heads)
    f64 = torch.float64

    def ein(eq, a, b):
        return torch.einsum(eq, a.double(), b.double()).float()

    def rows(t, other=None):
        if row_dtype == torch.float32:
            return (t if other is None else t * other).sum(-1, keepdim=True)
        t = t.to(f64) if other is None else t.to(f64) * other.to(f64)
        return t.sum(-1, keepdim=True).float()
    x = qkv.float().reshape(L, N, heads, 3, hd)
    q, k, v = x[:, :, :, 0] * hd ** -0.5, x[:, :, :, 1], x[:, :, :, 2]
    s = ein("lnhd,mnhd->nhlm", q, k)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    prob = e / rows(e)
    do = dout.float().reshape(L, N, heads, hd)
    dp = ein("lnhd,mnhd->nhlm", do, v)
    mask = cuda_attention.keep_mask(seeds, N, heads, L, p, bbh)
    keep = torch.full((), 1.0 - p, dtype=torch.float32)
    pd = torch.where(mask, prob / keep, 0.0)
    dp = torch.where(mask, dp / keep, 0.0)
    dv = ein("nhlm,lnhd->mnhd", pd, do)
    ds = prob * (dp - rows(dp, prob))
    dq = ein("nhlm,mnhd->lnhd", ds, k) * hd ** -0.5
    dk = ein("nhlm,lnhd->mnhd", ds, q)
    return torch.stack([dq, dk, dv], dim=3).reshape(L, N, -1), prob


def test_selfatt_float64_witness_sums_its_row_sums_in_float64():
    """``sum_dtype=torch.float64`` reaches the softmax denominator and
    dS's row sum: the witness is, bit for bit, the backward with those
    two sums in float64 too, and differs from the one that keeps them in
    f32 on a case where the two denominators differ; the default stays
    the f32 sums (test above)."""
    qkv, dout, args = _att_case(L=40, heads=2, hd=32, seed=19)
    qkv, dout = qkv.float(), dout.float()     # f32 out, no rounding
    want, prob64 = _witness_by_hand(qkv, dout, args, torch.float64)
    f32_rows, prob32 = _witness_by_hand(qkv, dout, args, torch.float32)
    assert not torch.equal(prob64, prob32)
    f64 = {"sum_dtype": torch.float64, "rounding": False}
    wit = cuda_attention.selfatt_bwd_plain(qkv, dout, *args, **f64)
    assert torch.equal(wit, want)
    assert not torch.equal(wit, f32_rows)
    heads, p, seeds, bbh = args
    L, N = qkv.shape[:2]
    o = cuda_attention.selfatt_plain(qkv, *args, **f64)
    v = qkv.float().reshape(L, N, heads, 3, -1)[:, :, :, 2]
    keep = torch.full((), 1.0 - p, dtype=torch.float32)
    mask = cuda_attention.keep_mask(seeds, N, heads, L, p, bbh)
    pd = torch.where(mask, prob64 / keep, 0.0)
    assert torch.equal(o, torch.einsum("nhlm,mnhd->lnhd", pd.double(),
                                       v.double()).float().reshape(L, N, -1))


def test_order_limit_widens_only_where_the_plain_orders_differ():
    """chip_smoke.order_limit, the card test's bound: an error within
    tol + |ref - wit| passes; 2 tol where ref equals wit is caught, as is
    a non-finite value; the readings count where the witness differs."""
    import chip_smoke
    ref = torch.tensor([1.0, 2.0, -4.0, 0.5, 8.0], dtype=torch.bfloat16)
    wit = torch.tensor([1.0, 2.0, -4.0, 0.5625, 8.0], dtype=torch.bfloat16)
    r, w = ref.float(), wit.float()
    tol = 1e-2 + 1e-2 * r.abs()
    sign = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0])
    got = r + 0.9 * sign * (tol + (r - w).abs())
    assert chip_smoke.order_limit(got, ref, wit) == \
        (0, 1, pytest.approx(float(0.9 * (tol[3] + 0.0625))))
    for i in (0, 2, 4):                      # where ref == wit
        bad = got.clone()
        bad[i] = r[i] + 2 * tol[i]
        assert chip_smoke.order_limit(bad, ref, wit)[0] == 1
    bad = got.clone()
    bad[3] = r[3] - 2 * (tol[3] + 0.0625)    # beyond the widened limit
    assert chip_smoke.order_limit(bad, ref, wit)[0] == 1
    bad[3] = float("nan")
    assert chip_smoke.order_limit(bad, ref, wit)[0] == 1
    assert chip_smoke.order_limit(ref, ref, ref) == (0, 0, 0.0)


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_120bias_gelu_bwd_kernelI13__nv_bfloat16Li8EEEvPKT_
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;       /* 0x0000000000007919 */
.L_x_1:
        /*0020*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0030*/                   FFMA R2, R3, R4, R5 ;
        /*0040*/                   NOP ;
        /*0050*/               @P0 BRA `(.L_x_1) ;
        /*0060*/                   EXIT ;
.L_x_2:
        /*0070*/                   BRA `(.L_x_2);
\t\tFunction : _ZN12_GLOBAL__N_120bias_gelu_fwd_kernelI13__nv_bfloat16Li8EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.EX2 R0, R1 ;
        /*0020*/                   EXIT ;
.L_x_3:
        /*0030*/                   BRA `(.L_x_3);
\t\tFunction : _ZN12_GLOBAL__N_120bias_gelu_bwd_kernelIfLi4EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/               @P0 BRA 0x60 ;               /* 0x0000000000007919 */
        /*0020*/                   FFMA R2, R3, R4, R5 ;
        /*0030*/                   FMUL R2, R3, R4 ;
        /*0040*/                   MUFU.EX2 R0, R1 ;
        /*0050*/              @!P1 BRA 0x20 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
"""


def test_sass_count_takes_the_longest_loop_or_the_whole_kernel(monkeypatch):
    """chip_smoke's issue floor: the instructions of a kernel's longest
    loop (no-ops and the trailing self-jump left out) over the elements
    a pass takes, the whole kernel where it has no loop; None without a
    matching kernel or without cuobjdump."""
    import shutil
    import subprocess
    import chip_smoke

    class Done:
        stdout = _SASS
    monkeypatch.setattr(shutil, "which", lambda name: "/bin/true")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Done())
    bwd = "bias_gelu_bwd_kernelI13__nv_bfloat16Li8EE"
    fwd = "bias_gelu_fwd_kernelI13__nv_bfloat16Li8EE"
    assert chip_smoke._sass_per_element("lib.so", bwd, 2) == 1.5
    assert chip_smoke._sass_per_element("lib.so", fwd, 1) == 3
    # the fragment is a regular expression
    assert chip_smoke._sass_per_element(
        "lib.so", r"gelu_bwd_kernelI13__nv_bfloat16.*EEEv", 2) == 1.5
    # targets given as addresses, as cuobjdump prints them for sm_90a
    assert chip_smoke._sass_per_element(
        "lib.so", "bias_gelu_bwd_kernelIfLi4EE", 4) == 1.0
    assert chip_smoke._sass_per_element("lib.so", "other_kernel", 1) is None
    assert chip_smoke._issue_ms(3.0, 132 * 128 * 1000, 132, 1000.0) == \
        pytest.approx(3e-3)
    assert chip_smoke._issue_ms(None, 1, 132, 1980.0) is None
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr("mxnet_tpu_torch.ops.cuda_build._nvcc",
                        lambda: "/nonexistent/bin/nvcc")
    assert chip_smoke._sass_per_element("lib.so", bwd, 2) is None


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------
def _seed(v):
    return torch.tensor([v], dtype=torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_keep_rate_and_scale(dtype):
    x = (torch.rand(256, 384) + 0.5).to(torch_dtype(dtype))
    y = cuda_dropout.dropout(x, 0.1, _seed(123))
    keep = y != 0
    n = x.numel()
    assert abs(keep.float().mean().item() - 0.9) <= 5 * np.sqrt(0.09 / n)
    want = (x.float() * np.float32(1 / 0.9)).to(x.dtype)
    assert torch.equal(y[keep], want[keep])
    # another seed, another mask
    assert not torch.equal(keep, cuda_dropout.dropout(x, 0.1, _seed(124)) != 0)


def test_dropout_same_mask_forward_and_backward():
    x = torch.randn(64, 96, requires_grad=True)
    w = torch.randn(64, 96)
    y = cuda_dropout.dropout_fn(x, 0.3, _seed(7))
    (y * w).sum().backward()
    keep = y.detach() != 0
    assert torch.equal(x.grad != 0, keep)
    torch.testing.assert_close(x.grad[keep],
                               w[keep] * np.float32(1 / 0.7), rtol=0, atol=0)


def test_dropout_hash_is_the_attention_hash():
    """The dropout kernel's bits are the reference's counter hash of the
    linear index, the same function the attention mask uses."""
    seed = 987654321
    thresh = min(int(0.5 * 2 ** 32), 2 ** 32 - 1)
    ref = np.asarray(_keep_mask(None, jnp.int32(seed), (1, 1, 4096), thresh,
                                True)).reshape(-1)
    y = cuda_dropout.dropout(torch.ones(4096), 0.5, _seed(seed))
    np.testing.assert_array_equal((y != 0).numpy(), ref)


@pytest.mark.parametrize("train", [False, True])
def test_dropout_op_identity_at_p0_and_in_eval(train):
    x = pt.nd.array(np.random.RandomState(1).randn(8, 16), ctx=pt.cpu())
    with pt.autograd.record(train_mode=train):
        y0 = pt.nd.Dropout(x, p=0.0)
        y1 = pt.nd.Dropout(x, p=0.5)
    np.testing.assert_array_equal(y0.asnumpy(), x.asnumpy())
    if train:
        assert (y1.asnumpy() == 0).any()
    else:
        np.testing.assert_array_equal(y1.asnumpy(), x.asnumpy())


def test_dropout_op_is_seeded_by_the_context_generator():
    x = pt.nd.array(np.ones((32, 64), np.float32), ctx=pt.cpu())

    def draw(axes=()):
        pt.random.seed(5)
        with pt.autograd.train_mode():
            return pt.nd.Dropout(x, p=0.25, axes=axes).asnumpy()
    a, b = draw(), draw()
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) <= {0.0, np.float32(1 / 0.75)}
    # axes share the mask along them: whole columns kept or dropped
    c = draw(axes=(0,))
    assert (c == c[:1]).all() and (c == 0).any() and (c != 0).any()
