"""Packed multi-head self-attention: the hand-written CUDA kernels,
forward (with dropout) and backward, and their plain PyTorch versions
(counterpart of ``mxnet_tpu/ops/pallas_attention.py``).

``selfatt`` and ``selfatt_bwd`` send CUDA tensors to the kernels of
``csrc/selfatt.cu`` (which replace ``pallas_attention.py :: _fwd_call ->
pallas_selfatt_packed_fwd`` and ``_bwd_call ->
pallas_selfatt_packed_bwd``) and CPU tensors to the plain versions; they
decide by the tensor's device alone. :func:`selfatt_fn` wraps the pair
in one ``torch.autograd.Function``. All read the reference's packed
layout ``(L, N, heads*3*hd)`` (per head ``[q | k | v]``) and return
``(L, N, heads*hd)`` (and the packed ``dqkv``) in the input dtype,
computing as the TPU kernels do: the input rounded to bf16, q*scale and
k in f32, scores and softmax in f32, dropout ``Pd = keep ? P / (1 - p) :
0`` in f32, Pd rounded to bf16 for P.V, the context rounded to bf16;
the backward as described in ``csrc/selfatt.cu``.

Dropout draws the reference's bits: :func:`keep_mask` is the counter
hash of ``pallas_attention.py :: _keep_mask`` over the
``(bbh, L_pad, L_pad)`` score block of each grid step, seeded per
(batch, head block). :func:`selfatt_plan` copies the reference's
geometry (``selfatt_plan`` / ``_default_block_heads``, without the
autotuner) so that the same seeds drop the same scores.

Domain (:func:`selfatt_available`): bf16 or f16 input (f32 takes the
unfused composition, as in the reference, because the kernels compute
in bf16), 1 <= L <= 1024, any head count. The reference's further limits
— its VMEM budget for the score block and the padding of L to 16 rows
and heads to whole head blocks — are TPU limits, so these kernels serve
the whole domain. The kernels take head dims up to 256; their shared
memory does not grow with L.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..base import MXNetError
from . import cuda_build as _cb
from .cuda_dropout import hash_bits, keep_threshold

__all__ = ["selfatt", "selfatt_cuda", "selfatt_plain", "selfatt_bwd",
           "selfatt_bwd_cuda", "selfatt_bwd_plain", "selfatt_fn",
           "selfatt_available", "selfatt_plan", "keep_mask"]

KERNEL = "selfatt_fwd"
BWD_KERNEL = "selfatt_bwd"
SOURCE = "selfatt.cu"
_MAX_L = 1024
# the reference's plan constants (pallas_attention.py): heads per block
# at most 16, L padded to 16, a 10 MB VMEM budget sized for hd = 64
_BB = 16
_SUBLANE = 16
_VMEM_BUDGET = 10 * 1024 * 1024


def selfatt_available(L, heads, batch, dtype) -> bool:
    """True when the fused kernels serve this call (the caller runs the
    unfused interleaved-matmul composition otherwise)."""
    if L < 1 or L > _MAX_L or heads < 1 or batch < 1:
        return False
    return dtype in (torch.bfloat16, torch.float16)


def selfatt_plan(L: int, heads: int, batch: int,
                 block_heads: Optional[int] = None) -> dict:
    """The reference's launch geometry, which names the dropout mask's
    blocks: ``bbh`` heads per block (the largest divisor of ``heads`` up
    to 16 whose bf16 working set fits the reference's VMEM budget, or
    ``block_heads``), ``L_pad`` (L rounded up to 16), ``n_hblk`` head
    blocks and ``n_blocks = batch * n_hblk`` seeds. Where no divisor
    fits, the reference runs its composition with ``jax.random`` masks,
    which no geometry reproduces; the port then takes one head per
    block."""
    L_pad = -(-L // _SUBLANE) * _SUBLANE
    bbh = block_heads
    if bbh is None:
        per_head = L_pad * 4 * 64 * 2 + 5 * L_pad * L_pad * 4
        bbh = next((b for b in range(min(heads, _BB), 0, -1)
                    if heads % b == 0 and b * per_head * 2 <= _VMEM_BUDGET),
                   1)
    n_hblk = -(-heads // int(bbh))
    return {"bbh": int(bbh), "L_pad": L_pad, "n_hblk": n_hblk,
            "n_blocks": batch * n_hblk}


def _scale(hd: int) -> float:
    return 1.0 / float(hd) ** 0.5


def _split(qkv: torch.Tensor, heads: int):
    L, N, thd = qkv.shape
    if thd % (3 * heads):
        raise MXNetError("%s: last axis %d is not heads(%d) * 3 * hd"
                         % (KERNEL, thd, heads))
    return L, N, thd // (3 * heads)


def keep_mask(seeds: torch.Tensor, N: int, heads: int, L: int, p: float,
              block_heads: Optional[int] = None) -> torch.Tensor:
    """(N, heads, L, L) bool: the scores the kernels keep at dropout p
    for ``seeds`` (N * n_hblk int32), bit for bit the reference's
    interpret-mode mask."""
    plan = selfatt_plan(L, heads, N, block_heads)
    bbh, L_pad = plan["bbh"], plan["L_pad"]
    dev = seeds.device
    h = torch.arange(heads, device=dev)
    seed = seeds.to(torch.int64).reshape(N, plan["n_hblk"])[:, h // bbh]
    pos = torch.arange(L, device=dev, dtype=torch.int64)
    idx = (((h % bbh).to(torch.int64)[:, None, None] * L_pad
            + pos[:, None]) * L_pad + pos[None, :])
    bits = hash_bits(idx[None], seed[:, :, None, None])
    return bits >= keep_threshold(p)


def _bf16(t: torch.Tensor, rounding: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if rounding else t.float()


def _einsum(eq, a, b, sum_dtype):
    """``torch.einsum(eq, a, b)`` on f32 operands, its products summed in
    ``sum_dtype`` and rounded to f32 right after the sum."""
    if sum_dtype == torch.float32:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.to(sum_dtype), b.to(sum_dtype)).float()


def _row_sum(t, sum_dtype, other=None):
    """The sum over the last axis of ``t`` (of ``t * other`` when given),
    keeping that axis: with f32 ``sum_dtype`` the f32 sum of the f32
    products, else each product formed and summed in ``sum_dtype`` and
    the sum rounded to f32 right after, as :func:`_einsum` does."""
    if sum_dtype == torch.float32:
        return (t if other is None else t * other).sum(dim=-1, keepdim=True)
    t = t.to(sum_dtype)
    if other is not None:
        t = t * other.to(sum_dtype)
    return t.sum(dim=-1, keepdim=True).float()


def _probs(q, k, sum_dtype=torch.float32):
    """f32 softmax of q.k^T over keys, (N, heads, L, L), as the kernel
    computes it (max, exp, sum, divide); the denominator summed in
    ``sum_dtype``."""
    s = _einsum("lnhd,mnhd->nhlm", q, k, sum_dtype)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / _row_sum(e, sum_dtype)


def _unpack(qkv, heads, rounding):
    L, N, hd = _split(qkv, heads)
    x = _bf16(qkv, rounding).reshape(L, N, heads, 3, hd)
    return x[:, :, :, 0] * _scale(hd), x[:, :, :, 1], x[:, :, :, 2]


def selfatt_plain(qkv: torch.Tensor, heads: int, p: float = 0.0,
                  seeds: Optional[torch.Tensor] = None,
                  block_heads: Optional[int] = None,
                  rounding: bool = True,
                  sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch ops. ``rounding=False``
    drops the bf16 rounding points (input, Pd, output) and computes the
    same function in f32. ``sum_dtype=torch.float64`` sums each product
    (Q.K^T, Pd.V) and the softmax denominator in float64 and rounds each
    sum to f32 right after: to within f32 rounding the correctly rounded
    sums, so a witness that depends on no summation order; every other
    operation and rounding point stays."""
    L, N, hd = _split(qkv, heads)
    q, k, v = _unpack(qkv, heads, rounding)
    pd = _probs(q, k, sum_dtype)
    if p > 0.0:
        keep = torch.full((), 1.0 - p, dtype=torch.float32, device=pd.device)
        pd = torch.where(keep_mask(seeds, N, heads, L, p, block_heads),
                         pd / keep, 0.0)
    o = _einsum("nhlm,mnhd->lnhd", _bf16(pd, rounding), v, sum_dtype)
    if rounding:
        o = o.to(torch.bfloat16)
    return o.reshape(L, N, heads * hd).to(qkv.dtype)


def selfatt_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                      p: float = 0.0, seeds: Optional[torch.Tensor] = None,
                      block_heads: Optional[int] = None,
                      rounding: bool = True,
                      sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The backward kernel's arithmetic in PyTorch ops: the reference's
    formula written out (not autograd through the forward), with its
    rounding points — dV from the f32 Pd, dQ and dK from bf16(dS), dK
    from bf16(Q * scale). ``rounding=False`` drops them;
    ``sum_dtype=torch.float64`` sums the products (Q.K^T, dO.V^T, dV, dQ,
    dK), the softmax denominator and dS's row sum of dP * P in float64,
    as :func:`selfatt_plain` does."""
    L, N, hd = _split(qkv, heads)
    q, k, v = _unpack(qkv, heads, rounding)
    do = _bf16(dout, rounding).reshape(L, N, heads, hd)
    prob = _probs(q, k, sum_dtype)
    dp = _einsum("lnhd,mnhd->nhlm", do, v, sum_dtype)
    pd = prob
    if p > 0.0:
        keep = torch.full((), 1.0 - p, dtype=torch.float32,
                          device=prob.device)
        mask = keep_mask(seeds, N, heads, L, p, block_heads)
        pd = torch.where(mask, prob / keep, 0.0)
        dp = torch.where(mask, dp / keep, 0.0)
    dv = _einsum("nhlm,lnhd->mnhd", pd, do, sum_dtype)
    ds = _bf16(prob * (dp - _row_sum(dp, sum_dtype, prob)), rounding)
    dq = _einsum("nhlm,mnhd->lnhd", ds, _bf16(k, rounding),
                 sum_dtype) * _scale(hd)
    dk = _einsum("nhlm,lnhd->mnhd", ds, _bf16(q, rounding), sum_dtype)
    out = torch.stack([dq, dk, dv], dim=3).reshape(L, N, heads * 3 * hd)
    if rounding:
        out = out.to(torch.bfloat16)
    return out.to(qkv.dtype)


def _lib():
    lib = _cb.library(SOURCE)
    if not hasattr(lib, "_mxt_ready"):
        p, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                            ctypes.c_float)
        lib.mxt_selfatt_fwd.argtypes = [p, p, i32, i32, i32, i32, f32, p, i32,
                                        i32, i32, u32, f32, i32, p]
        lib.mxt_selfatt_fwd.restype = i32
        bwd = [p, p, p, p, i32, i32, i32, i32, f32, p, i32, i32, i32, u32,
               f32, i32, p]
        lib.mxt_selfatt_bwd.argtypes = bwd
        lib.mxt_selfatt_bwd.restype = i32
        lib.mxt_selfatt_bwd_pd_terms.argtypes = bwd + [i32]
        lib.mxt_selfatt_bwd_pd_terms.restype = i32
        lib.mxt_selfatt_smem.argtypes = [i32, i32]
        lib.mxt_selfatt_smem.restype = i32
        lib.mxt_selfatt_max_hd.argtypes = []
        lib.mxt_selfatt_max_hd.restype = i32
        lib._mxt_ready = True
    return lib


def _check(kernel, qkv, heads, p, seeds, block_heads):
    """Validate a launch; returns (L, N, hd, lib, dropout arguments)."""
    _cb.check_cuda_tensor(kernel, "qkv", qkv, (torch.bfloat16,))
    if qkv.dim() != 3:
        raise MXNetError("%s: qkv must be (L, N, heads*3*hd), got %s"
                         % (kernel, tuple(qkv.shape)))
    L, N, hd = _split(qkv, heads)
    lib = _lib()
    if hd > lib.mxt_selfatt_max_hd() or N > 65535 or heads > 65535:
        raise MXNetError("%s: head dim %d, batch %d or heads %d beyond the "
                         "kernel's limits (hd <= %d, batch and heads <= "
                         "65535)" % (kernel, hd, N, heads,
                                     lib.mxt_selfatt_max_hd()))
    plan = selfatt_plan(L, heads, N, block_heads)
    if p > 0.0:
        if seeds is None or seeds.numel() != plan["n_blocks"]:
            raise MXNetError("%s: dropout needs %d seeds (batch * head "
                             "blocks)" % (kernel, plan["n_blocks"]))
        _cb.check_cuda_tensor(kernel, "seeds", seeds, (torch.int32,),
                              qkv.device)
    drop = (seeds.data_ptr() if p > 0.0 else None, plan["n_hblk"],
            plan["bbh"], plan["L_pad"], keep_threshold(p), 1.0 - p,
            int(p > 0.0))
    return L, N, hd, lib, drop


def selfatt_cuda(qkv: torch.Tensor, heads: int, p: float = 0.0,
                 seeds: Optional[torch.Tensor] = None,
                 block_heads: Optional[int] = None) -> torch.Tensor:
    """Launch the forward kernel on a contiguous bf16 CUDA ``qkv``."""
    L, N, hd, lib, drop = _check(KERNEL, qkv, heads, p, seeds, block_heads)
    out = torch.empty((L, N, heads * hd), dtype=torch.bfloat16,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = lib.mxt_selfatt_fwd(qkv.data_ptr(), out.data_ptr(), L, N,
                                 heads, hd, _scale(hd), *drop,
                                 _cb.stream_of(qkv))
    _cb.check_launch(lib, rc, KERNEL)
    return out


def selfatt_bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                     p: float = 0.0, seeds: Optional[torch.Tensor] = None,
                     block_heads: Optional[int] = None) -> torch.Tensor:
    """Launch the backward kernels on contiguous bf16 CUDA ``qkv`` and
    ``dout``; returns the packed bf16 ``dqkv``."""
    L, N, hd, lib, drop = _check(BWD_KERNEL, qkv, heads, p, seeds,
                                 block_heads)
    _cb.check_cuda_tensor(BWD_KERNEL, "dout", dout, (torch.bfloat16,),
                          qkv.device)
    if tuple(dout.shape) != (L, N, heads * hd):
        raise MXNetError("%s: dout must be %s, got %s"
                         % (BWD_KERNEL, (L, N, heads * hd),
                            tuple(dout.shape)))
    dqkv = torch.empty_like(qkv)
    # each row's max, sum and rowsum(dP * P), rows padded to the kernels'
    # 64-row tiles
    stats = torch.empty((N, heads, 3, -(-L // 64) * 64),
                        dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = lib.mxt_selfatt_bwd(qkv.data_ptr(), dout.data_ptr(),
                                 dqkv.data_ptr(), stats.data_ptr(), L, N,
                                 heads, hd, _scale(hd), *drop,
                                 _cb.stream_of(qkv))
    _cb.check_launch(lib, rc, BWD_KERNEL)
    return dqkv


def selfatt(qkv: torch.Tensor, heads: int, p: float = 0.0,
            seeds: Optional[torch.Tensor] = None,
            block_heads: Optional[int] = None) -> torch.Tensor:
    """Packed self-attention: the kernel for a CUDA tensor, the plain
    version for a CPU tensor. Input of another float dtype is rounded to
    bf16 first and the context returned in the input dtype, as in the
    reference."""
    if qkv.is_cuda:
        x = qkv.to(torch.bfloat16).contiguous()
        return selfatt_cuda(x, heads, p, seeds, block_heads).to(qkv.dtype)
    if qkv.device.type == "cpu":
        return selfatt_plain(qkv, heads, p, seeds, block_heads)
    raise MXNetError("%s: no kernel for device %s" % (KERNEL, qkv.device))


def selfatt_bwd(qkv: torch.Tensor, dout: torch.Tensor, heads: int,
                p: float = 0.0, seeds: Optional[torch.Tensor] = None,
                block_heads: Optional[int] = None) -> torch.Tensor:
    """Packed self-attention backward: the kernels for a CUDA tensor,
    the plain version for a CPU tensor; dqkv in qkv's dtype."""
    if qkv.is_cuda:
        x = qkv.to(torch.bfloat16).contiguous()
        dy = dout.to(torch.bfloat16).contiguous()
        return selfatt_bwd_cuda(x, dy, heads, p, seeds,
                                block_heads).to(qkv.dtype)
    if qkv.device.type == "cpu":
        return selfatt_bwd_plain(qkv, dout, heads, p, seeds, block_heads)
    raise MXNetError("%s: no kernel for device %s"
                     % (BWD_KERNEL, qkv.device))


class _SelfAttFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, p, seeds, block_heads):
        ctx.save_for_backward(qkv, seeds)
        ctx.args = (heads, p, block_heads)
        return selfatt(qkv, heads, p, seeds, block_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, seeds = ctx.saved_tensors
        heads, p, block_heads = ctx.args
        return (selfatt_bwd(qkv, dout, heads, p, seeds, block_heads),
                None, None, None, None)


def selfatt_fn(qkv: torch.Tensor, heads: int, p: float = 0.0,
               seeds: Optional[torch.Tensor] = None,
               block_heads: Optional[int] = None) -> torch.Tensor:
    """Packed self-attention with its backward: the same seeds drop the
    same scores in both directions."""
    return _cb.apply(_SelfAttFn, selfatt, qkv, heads, p, seeds, block_heads)
