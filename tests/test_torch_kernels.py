"""The PyTorch/CUDA port's kernel modules against the reference's Pallas
kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions against the JAX kernel entry points
(``pallas_layer_norm``, ``flash_selfatt``, ``pallas_bias_gelu``,
``pallas_bias_residual``) run in Pallas interpret mode, on the same
numpy inputs. Tolerances: f32 within 1e-5 (abs + rel); bf16 within 1e-2
(abs + rel) or one bf16 ulp of the output. The attention kernel computes
in bf16 whatever its input dtype, so its outputs take the bf16 bound.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas_attention import flash_selfatt
from mxnet_tpu.ops.pallas_epilogue import (pallas_bias_gelu,
                                           pallas_bias_residual)
from mxnet_tpu.ops.pallas_norm import pallas_layer_norm

from mxnet_tpu_torch.base import MXNetError, torch_dtype
from mxnet_tpu_torch.ops import (cuda_attention, cuda_build, cuda_dropout,
                                 cuda_epilogue, cuda_fused, cuda_norm)


def _jax(a, dtype):
    return jnp.asarray(a, dtype=jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch_dtype(dtype))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_close(got, ref, dtype):
    got, ref = _host(got), _host(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        return
    err = np.abs(got - ref)
    tol = np.maximum(1e-2 + 1e-2 * np.abs(ref), _bf16_ulp(ref))
    assert (err <= tol).all(), "max err %g" % err.max()


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (4, 8, 64)])
def test_layer_norm_plain_matches_pallas(pallas_interpret, dtype, shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    g = rng.randn(shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    ref = pallas_layer_norm(_jax(x, dtype), _jax(g, dtype), _jax(b, dtype),
                            eps=1e-5)
    got = cuda_norm.layer_norm(_torch(x, dtype).reshape(-1, shape[-1]),
                               _torch(g, dtype), _torch(b, dtype), 1e-5)
    assert got.dtype == torch_dtype(dtype)
    assert_close(got.reshape(shape), ref, dtype)


def test_layer_norm_op_matches_reference_op_on_ragged_rows(pallas_interpret):
    """35 rows tile no TPU row block, so the reference falls back to its
    composition; the port's kernel path serves them with the same
    formula."""
    import mxnet_tpu as mx
    import mxnet_tpu_torch as pt
    rng = np.random.RandomState(1)
    x = rng.randn(5, 7, 48).astype(np.float32)
    g = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    ref = mx.nd.LayerNorm(mx.nd.array(x), mx.nd.array(g), mx.nd.array(b),
                          axis=-1, eps=1e-5)
    got = pt.nd.LayerNorm(*(pt.nd.array(a, ctx=pt.cpu()) for a in (x, g, b)),
                          axis=-1, eps=1e-5)
    assert_close(got.tensor(), ref.asnumpy(), "float32")


# ---------------------------------------------------------------------------
# packed self-attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("L,heads,block_heads", [
    (16, 4, 4), (127, 4, 4), (32, 5, 4)])
def test_selfatt_plain_matches_flash_selfatt(pallas_interpret, dtype, L,
                                             heads, block_heads):
    N, hd = 2, 16
    rng = np.random.RandomState(2)
    qkv = rng.randn(L, N, heads * 3 * hd).astype(np.float32)
    n_blocks = N * -(-heads // block_heads)
    ref = flash_selfatt(_jax(qkv, dtype), jnp.zeros((n_blocks,), jnp.int32),
                        heads=heads, dropout=0.0, block_heads=block_heads)
    got = cuda_attention.selfatt(_torch(qkv, dtype), heads)
    assert got.shape == (L, N, heads * hd)
    assert got.dtype == torch_dtype(dtype)
    assert_close(got, ref, "bfloat16")


def test_selfatt_available_domain():
    ok = cuda_attention.selfatt_available
    assert ok(1, 1, 1, torch.bfloat16)
    assert ok(127, 5, 3, torch.float16)
    assert ok(1024, 12, 8, torch.bfloat16)
    assert not ok(1025, 12, 8, torch.bfloat16)
    # the kernel computes in bf16: f32 takes the unfused composition
    assert not ok(128, 12, 8, torch.float32)


# ---------------------------------------------------------------------------
# Dense epilogues
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (2, 16, 40)])
def test_bias_gelu_plain_matches_pallas(pallas_interpret, dtype, shape):
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    ref = pallas_bias_gelu(_jax(x, dtype), _jax(b, dtype))
    got = cuda_epilogue.bias_gelu(_torch(x, dtype).reshape(-1, shape[-1]),
                                  _torch(b, dtype))
    assert got.dtype == torch_dtype(dtype)
    assert_close(got.reshape(shape), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 48), (2, 16, 40)])
def test_bias_residual_plain_matches_pallas(pallas_interpret, dtype, shape):
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    ref = pallas_bias_residual(_jax(x, dtype), _jax(b, dtype), _jax(r, dtype))
    C = shape[-1]
    got = cuda_epilogue.bias_residual(_torch(x, dtype).reshape(-1, C),
                                      _torch(b, dtype),
                                      _torch(r, dtype).reshape(-1, C))
    assert got.dtype == torch_dtype(dtype)
    assert_close(got.reshape(shape), ref, dtype)


def test_epilogue_availability_mirrors_reference():
    bf, f32 = torch.bfloat16, torch.float32
    assert cuda_epilogue.bias_gelu_available((3, 5), bf, bf)
    # a bias of another dtype is a numerics reason: the composition runs
    assert not cuda_epilogue.bias_gelu_available((32, 48), bf, f32)
    assert not cuda_epilogue.bias_residual_available((32, 48), bf, bf, f32)
    assert not cuda_epilogue.bias_gelu_available((48,), bf, bf)
    assert cuda_epilogue.bias_residual_available((32, 48), bf, bf, bf)


@pytest.mark.parametrize("switch", ["MXNET_PALLAS_LAYERNORM",
                                    "MXNET_FLASH_ATTENTION",
                                    "MXNET_PALLAS_EPILOGUE"])
def test_reference_kernel_switches_do_not_reach_the_port(monkeypatch,
                                                         switch):
    """The reference's kernel switches turned off leave the port's
    dispatch as it is: device and domain decide, nothing else."""
    from mxnet_tpu_torch import config
    monkeypatch.setenv(switch, "0")
    with pytest.raises(KeyError, match="undeclared"):
        config.get(switch)
    bf = torch.bfloat16
    assert cuda_norm.ln_available((32, 48), bf, 1)
    assert cuda_attention.selfatt_available(128, 12, 8, bf)
    assert cuda_epilogue.bias_gelu_available((32, 48), bf, bf)
    assert cuda_epilogue.bias_residual_available((32, 48), bf, bf, bf)


# ---------------------------------------------------------------------------
# wrappers, dispatch and the build helper
# ---------------------------------------------------------------------------
def _kernel_calls(device="cpu"):
    x = torch.zeros(4, 8, device=device)
    b = torch.zeros(8, device=device)
    qkv = torch.zeros(4, 2, 2 * 3 * 4, dtype=torch.bfloat16, device=device)
    do = torch.zeros(4, 2, 2 * 4, dtype=torch.bfloat16, device=device)
    seed = torch.zeros(1, dtype=torch.int32, device=device)
    return {
        "layer_norm_fwd": lambda: cuda_norm.layer_norm_cuda(x, b, b, 1e-5),
        "layer_norm_bwd": lambda: cuda_norm.layer_norm_bwd_cuda(x, x, b,
                                                                1e-5),
        "selfatt_fwd": lambda: cuda_attention.selfatt_cuda(qkv, 2),
        "selfatt_bwd": lambda: cuda_attention.selfatt_bwd_cuda(qkv, do, 2),
        "bias_gelu_fwd": lambda: cuda_epilogue.bias_gelu_cuda(x, b),
        "bias_gelu_bwd": lambda: cuda_epilogue.bias_gelu_bwd_cuda(x, x, b),
        "bias_residual_fwd": lambda: cuda_epilogue.bias_residual_cuda(x, b,
                                                                      x),
        "dropout": lambda: cuda_dropout.dropout_cuda(x, 0.1, seed),
        "dual_bwd": lambda: cuda_fused.dual_bwd_cuda(
            x.bfloat16(), x.bfloat16(), x.bfloat16(),
            torch.zeros(8, 8, dtype=torch.bfloat16, device=device),
            torch.zeros(8, 8, device=device), "none"),
    }


@pytest.mark.parametrize("kernel", sorted(cuda_build.KERNELS))
def test_kernel_wrapper_raises_on_cpu_tensor(kernel):
    """The CUDA entry points never run a CPU tensor, and never build
    or fall back to doing so."""
    before = cuda_build.launch_counts()
    with pytest.raises(MXNetError, match="CUDA tensor"):
        _kernel_calls()[kernel]()
    assert cuda_build.launch_counts() == before


@pytest.mark.parametrize("fn", [
    lambda x: cuda_norm.layer_norm(x, x[0], x[0], 1e-5),
    lambda x: cuda_attention.selfatt(x.reshape(2, 1, 6), 1),
    lambda x: cuda_epilogue.bias_gelu(x, x[0]),
    lambda x: cuda_epilogue.bias_residual(x, x[0], x),
    lambda x: cuda_norm.layer_norm_bwd(x, x, x[0], 1e-5)[0],
    lambda x: cuda_attention.selfatt_bwd(x.reshape(2, 1, 6),
                                         x.reshape(2, 1, 6)[..., :2], 1),
    lambda x: cuda_epilogue.bias_gelu_bwd(x, x, x[0])[0],
    lambda x: cuda_dropout.dropout(x, 0.5, torch.zeros(
        1, dtype=torch.int32, device=x.device)),
    lambda x: cuda_fused.dual_bwd(x, x, x, x.t() @ x, torch.zeros(
        8, 6, device=x.device), "none")[0],
], ids=["layer_norm", "selfatt", "bias_gelu", "bias_residual",
        "layer_norm_bwd", "selfatt_bwd", "bias_gelu_bwd", "dropout",
        "dual_bwd"])
def test_dispatch_is_by_device(fn):
    x = torch.ones(2, 6)
    assert fn(x).device.type == "cpu"
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        fn(torch.ones(2, 6, device="meta"))


@pytest.mark.parametrize("C,dtype,vectors", [
    (768, "bfloat16", 3), (1024, "bfloat16", 4), (768, "float16", 3),
    (8, "bfloat16", 1), (768, "float32", 6), (1024, "float32", 8),
    (520, "float32", 6), (100, "float32", 1), (100, "bfloat16", 0),
    (1536, "bfloat16", 0), (4100, "float32", 0), (4100, "bfloat16", 0)])
def test_layer_norm_bwd_path_choice(C, dtype, vectors):
    """Rows that are whole 16-byte vectors, at most 1024 wide, go to the
    register path of the backward and forward kernels with that many
    vectors a lane (4, 6 or 8 past 3); the others (C = 100 in bf16 is not
    16-byte aligned) to their chunked paths, 0."""
    assert cuda_norm.reg_vectors(C, torch_dtype(dtype)) == vectors


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("C", [8, 100, 768, 1024, 1028, 2048])
def test_layer_norm_fwd_path_choice(C, dtype, aligned):
    """The forward takes the register path, as the backward does, only
    where the rows are whole 16-byte vectors at most 1024 wide and the
    pointers 16-byte aligned; BERT's 768 always there when aligned,
    2048 (and 1028) never, and an unaligned view never."""
    dt = torch_dtype(dtype)
    e = 16 // dt.itemsize
    nv = cuda_norm.reg_vectors(C, dt, aligned)
    if not aligned or C % e or C > 1024:
        assert nv == 0
    else:
        assert nv >= -(-C // (32 * e)) and nv * 32 * e - C < 2 * 32 * e
    if aligned and C == 768:
        assert nv == (6 if dtype == "float32" else 3)


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("M", [1, 33, 1024, 4096, 100000])
def test_layer_norm_fwd_grid(M, sms):
    """The register path: blocks of 4 warps, a warp a row, at most 4
    blocks an SM (a warp then walks several rows: two of BERT's 4096 on
    132 SMs); the chunked path: a block of 8 rows, every row its own
    warp."""
    reg = cuda_norm.fwd_blocks(M, 768, torch.bfloat16, True, sms)
    assert reg == min(-(-M // 4), 4 * sms)
    assert reg * 4 >= min(M, 16 * sms)
    chunked = cuda_norm.fwd_blocks(M, 768, torch.bfloat16, False, sms)
    assert chunked == cuda_norm.fwd_blocks(M, 2048, torch.bfloat16, True,
                                           sms) == -(-M // 8)


def test_layer_norm_fwd_takes_the_chunked_path_on_a_shifted_view():
    """A view 2 bytes off 16-byte alignment is unaligned for the wrapper's
    alignment test, so the kernel's path choice sends it to the chunked
    path; on the CPU the plain version serves it whatever its alignment."""
    base = torch.randn(64 * 768 + 1).to(torch.bfloat16)
    x = base[1:].view(64, 768)
    g, b = torch.ones(768, dtype=torch.bfloat16), torch.zeros(
        768, dtype=torch.bfloat16)
    assert not cuda_epilogue.aligned16(x)
    assert cuda_norm.reg_vectors(768, x.dtype,
                                 cuda_epilogue.aligned16(x, g, b)) == 0
    assert torch.equal(cuda_norm.layer_norm(x, g, b, 1e-5),
                       cuda_norm.layer_norm_plain(x.contiguous(), g, b,
                                                  1e-5))


@pytest.mark.parametrize("shift", ["none", "x", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("C", [7, 300, 768, 3072])
def test_bias_residual_path_choice(C, dtype, shift):
    """bias+residual runs on bias+GeLU's forward kernel and takes its
    vector/element choice: a 16-byte vector of columns a thread where the
    rows hold a whole number of them and x, the residual and y are all
    16-byte aligned, else one element (a view one element off alignment,
    in x or in the residual alone, sends the call to the element path)."""
    def view(off):
        return torch.zeros(4 * C + 8, dtype=dtype)[off:off + 4 * C].view(4, C)
    x = view(1 if shift == "x" else 0)
    r = view(1 if shift == "residual" else 0)
    y = torch.empty_like(r)
    aligned = cuda_epilogue.aligned16(x, r, y)
    assert aligned == (shift == "none")
    e = 16 // dtype.itemsize
    want = e if aligned and C % e == 0 else 1
    assert cuda_epilogue.col_vector(C, dtype, aligned) == want
    if aligned and C in (768, 3072):
        assert want > 1


@pytest.mark.parametrize("M,sms,blocks", [(4096, 132, 264), (4096, 114, 228),
                                          (1, 132, 1), (33, 132, 5),
                                          (2112, 132, 264)])
def test_layer_norm_bwd_grid_and_scratch(M, sms, blocks):
    """Two 8-warp blocks an SM, fewer where the rows run out; one dgamma
    and one dbeta partial row of f32 per block."""
    assert cuda_norm.bwd_blocks(M, sms) == blocks
    assert cuda_norm.bwd_scratch_shape(M, 768, sms) == (blocks, 2, 768)


DUAL_SHAPES = [(100352, 64, 256), (100352, 256, 64), (100352, 64, 64),
               (25088, 128, 512), (25088, 512, 128), (6272, 256, 1024),
               (6272, 1024, 256), (1568, 512, 2048), (1568, 2048, 512),
               (333, 70, 130), (1, 8, 8), (100, 3000, 40)]


@pytest.mark.parametrize("M,I,O", DUAL_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_dual_plan_covers_every_row_and_column(M, I, O, sms):
    """dW's row splits and dx's depth slices are whole steps of the
    kernel's depth (32) that cover M and O with none empty; the scratch
    matches the launcher's layout."""
    for emit_next in (False, True):
        p = cuda_fused.dual_plan(M, I, O, sms, emit_next)
        sw, rw, sx, dx = (p[k] for k in ("splits_w", "rows_w", "splits_x",
                                         "depth_x"))
        assert rw % 32 == 0 and (sw - 1) * rw < M <= sw * rw
        assert p["fused"] or rw >= min(128, -(-M // 32) * 32)
        assert dx % 32 == 0 and (sx - 1) * dx < O <= sx * dx
        assert p["part_dw"] == (sw, I, O)
        assert p["cdy"] == (None if p["fused"] else (M, O))
        if sx > 1:
            assert dx >= 256 and p["part_dx"] == (sx, M, I)
        else:
            assert p["part_dx"] is None
        rows = 32 if sx > 1 else 128
        assert p["part_sums"] == ((-(-M // rows), 2, I) if emit_next
                                  else None)


def test_dual_plan_fuses_the_narrow_calls():
    """One block takes both products where I <= 64 and 128 < O <= 256
    without the chaining sums (stage 1's tails and downsample), two blocks
    an SM; never for unaligned operands, widths that are no multiple of
    8, the chained heads, or O <= 128 (stage 1's first head)."""
    fused = {s: cuda_fused.dual_plan(*s, 132)["fused"] for s in DUAL_SHAPES}
    assert {s for s, f in fused.items() if f} == {(100352, 64, 256)}
    assert cuda_fused.dual_plan(520, 48, 200, 132)["fused"]
    assert cuda_fused.dual_plan(100352, 64, 256, 132)["splits_w"] == 262
    assert not cuda_fused.dual_plan(100352, 64, 256, 132, True)["fused"]
    assert not cuda_fused.dual_plan(100352, 64, 256, 132,
                                    aligned=False)["fused"]


def test_dual_plan_splits_the_short_dx_grids():
    """On an H100 (132 SMs) the dx depth is split where the dx tiles give
    fewer than 264 blocks: stage 3's tail into 2 slices, stage 4's into
    3; the dW blocks (the fused calls' blocks) come to about two an SM."""
    split = {s: cuda_fused.dual_plan(*s, 132)["splits_x"]
             for s in DUAL_SHAPES[:9]}
    assert split == {s: {(6272, 256, 1024): 2, (1568, 512, 2048): 3}.get(s, 1)
                     for s in DUAL_SHAPES[:9]}
    for M, I, O in DUAL_SHAPES[:9]:
        p = cuda_fused.dual_plan(M, I, O, 132)
        tiles = 1 if p["fused"] else -(-I // 64) * -(-O // 128)
        blocks = tiles * p["splits_w"]
        assert abs(blocks - 264) <= 2 * tiles


def test_kernel_wrappers_refuse_bad_operands_before_building(monkeypatch):
    """Shape refusals come before the kernel library is built or loaded
    (meta tensors stand in for CUDA ones past the device check)."""
    def no_build(*args):
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(cuda_build, "library", no_build)
    monkeypatch.setattr(cuda_build, "check_cuda_tensor", lambda *a, **k: None)
    meta = torch.device("meta")
    x = torch.empty(4, 8, dtype=torch.bfloat16, device=meta)
    coef = torch.empty(8, 8, device=meta)
    with pytest.raises(MXNetError, match="gamma"):
        cuda_norm.layer_norm_bwd_cuda(x, x, x[0, :4], 1e-5)
    with pytest.raises(MXNetError, match="w must be"):
        cuda_fused.dual_bwd_cuda(x, x, x, x, coef, "none")
    with pytest.raises(MXNetError, match="empty operand"):
        cuda_fused.dual_bwd_cuda(x[:0], x[:0], x[:0], coef, coef, "none")


def test_every_source_exists_and_is_built():
    csrc = cuda_build.CSRC_DIR
    on_disk = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sorted(cuda_build.SOURCES) == on_disk
    assert set(cuda_build.KERNELS.values()) == set(cuda_build.SOURCES)
    for name in cuda_build.SOURCES + cuda_build.HEADERS:
        assert (csrc / name).is_file()
    for src in cuda_build.SOURCES:
        assert "mxnet_tpu/ops/pallas_" in (csrc / src).read_text()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert len(cuda_build.source_digest()) == 16


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(MXNetError, match="nvcc not found"):
        cuda_build.build()
    assert not (tmp_path / "build").exists()


def test_launch_counts_reset():
    cuda_build.count_launch("selfatt_fwd")
    assert cuda_build.launch_counts()["selfatt_fwd"] >= 1
    cuda_build.reset_launch_counts()
    assert cuda_build.launch_counts() == {k: 0 for k in cuda_build.KERNELS}


@pytest.mark.parametrize("fn", [
    lambda x: cuda_norm.layer_norm_fn(x, x[0], x[0], 1e-5),
    lambda x: cuda_attention.selfatt_fn(x.reshape(2, 1, 6), 1),
    lambda x: cuda_epilogue.bias_gelu_fn(x, x[0]),
    lambda x: cuda_epilogue.bias_residual_fn(x, x[0], x),
    lambda x: cuda_dropout.dropout_fn(x, 0.5, torch.zeros(1,
                                                          dtype=torch.int32)),
], ids=["layer_norm", "selfatt", "bias_gelu", "bias_residual", "dropout"])
def test_autograd_function_only_while_a_graph_is_built(monkeypatch, fn):
    """Each wrapper's torch.autograd.Function runs only while grad mode
    is on (inside autograd.record()); outside it the same forward runs
    without the Function's host cost and gives the same values."""
    calls = []
    apply = torch.autograd.Function.apply.__func__

    def spy(cls, *args):
        calls.append(cls.__name__)
        return apply(cls, *args)

    monkeypatch.setattr(torch.autograd.Function, "apply", classmethod(spy))
    x = torch.randn(2, 6, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    with torch.enable_grad():
        y = fn(x)
    assert len(calls) == 1 and y.grad_fn is not None
    with torch.no_grad():
        z = fn(x)
    assert len(calls) == 1 and z.grad_fn is None
    torch.testing.assert_close(z, y.detach(), rtol=0, atol=0)
