"""LayerNorm over the last axis: the hand-written CUDA kernels, forward
and backward, and their plain PyTorch versions (counterpart of
``mxnet_tpu/ops/pallas_norm.py``).

``layer_norm`` and ``layer_norm_bwd`` send CUDA tensors to the kernels
of ``csrc/layer_norm.cu`` (which replace ``pallas_norm.py :: _fwd_call
-> pallas_layer_norm_fwd`` and ``_bwd_call -> pallas_layer_norm_bwd``)
and CPU tensors to the plain versions; they decide by the tensor's
device alone. :func:`layer_norm_fn` wraps the pair in one
``torch.autograd.Function``, as the reference's ``custom_vjp`` does.
Forward: f32 statistics, two-pass variance, ``rsqrt(var + eps)``, then
``((x - mean) * inv) * gamma + beta`` with gamma/beta in f32, rounded
to x's dtype. Backward: the statistics re-derived from x, ``dx = inv *
(dy*gamma - mean(dy*gamma) - xhat * mean(dy*gamma*xhat))`` rounded to
x's dtype, dgamma = sum(dy * xhat) and dbeta = sum(dy) in f32, rounded
to gamma's dtype.

The reference declines shapes whose row count does not split into
whole TPU row blocks (``_pick_rows``) or is below 8; those are limits
of TPU tiling, so the kernel serves every row count.

Launch plans: the forward's grid (:func:`fwd_blocks`) and the backward's
persistent blocks (:func:`bwd_blocks`) come from the card's SM count;
with ``MXNET_AUTOTUNE`` on, :func:`fwd_plan` and :func:`bwd_plan` ask the
tuner (``autotune.py``) for another grid of the same kernels, where the
reference asks it for another row block (``pallas_norm.py ::
_tuned_rows``). A row is one warp's either way, so a forward grid leaves
its output bit for bit; the backward's dgamma and dbeta partial rows are
summed in another order on another grid.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import autotune as _at
from ..base import MXNetError
from . import cuda_build as _cb
from .cuda_epilogue import aligned16

__all__ = ["layer_norm", "layer_norm_cuda", "layer_norm_plain",
           "layer_norm_bwd", "layer_norm_bwd_cuda", "layer_norm_bwd_plain",
           "layer_norm_fn", "ln_available", "ln_composition", "fwd_plan",
           "bwd_plan"]

KERNEL = "layer_norm_fwd"
BWD_KERNEL = "layer_norm_bwd"
SOURCE = "layer_norm.cu"
# the kernels' grids and paths (csrc/layer_norm.cu)
_FWD_WARPS = 4
_FWD_BLOCKS_PER_SM = 4
_CHUNK_WARPS = 8
_BWD_WARPS = 8
_BWD_BLOCKS_PER_SM = 2
_REG_COLS = 1024


def ln_available(shape, dtype, axis) -> bool:
    """True when the fused LayerNorm serves this call: the last axis of
    a non-empty float tensor (the caller runs the composition
    otherwise)."""
    if len(shape) < 2 or axis != len(shape) - 1:
        return False
    return dtype in _cb.DTYPE_CODES and math.prod(shape) > 0


def ln_composition(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   ax: int, eps: float):
    """The kernel's arithmetic along axis ``ax`` (the reference's
    ``_ln_fused``); returns the output and the f32 mean and variance."""
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    xf = x.float()
    mean = xf.mean(dim=ax, keepdim=True)
    var = (xf - mean).square().mean(dim=ax, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = ((xf - mean) * inv * gamma.float().reshape(shape)
           + beta.float().reshape(shape)).to(x.dtype)
    return out, mean, var


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops, over the last axis."""
    return ln_composition(x, gamma, beta, x.dim() - 1, eps)[0]


def layer_norm_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                         gamma: torch.Tensor, eps: float):
    """The backward kernel's arithmetic in PyTorch ops, over the last
    axis of 2-D ``x``: returns (dx, dgamma, dbeta)."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dyg = dyf * gamma.float()
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (dyg - m1 - xhat * m2)).to(x.dtype)
    return (dx, (dyf * xhat).sum(dim=0).to(gamma.dtype),
            dyf.sum(dim=0).to(gamma.dtype))


def bwd_blocks(M: int, sms: int) -> int:
    """The backward's persistent grid: ``_BWD_BLOCKS_PER_SM`` blocks of
    ``_BWD_WARPS`` warps on each of the card's ``sms`` SMs, fewer where
    the rows do not fill them (a warp takes a row at a time)."""
    return max(1, min(-(-M // _BWD_WARPS), _BWD_BLOCKS_PER_SM * sms))


def reg_vectors(C: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """16-byte vectors a lane holds on the register path of the forward
    and backward kernels for rows of ``C`` elements, or 0 where their
    chunked paths (element loads) take them: rows that are not a whole
    number of 16-byte vectors, are wider than ``_REG_COLS`` or whose
    pointers are not 16-byte aligned (``csrc/layer_norm.cu ::
    reg_vectors``)."""
    e = 16 // dtype.itemsize
    if not aligned or C % e or C > _REG_COLS:
        return 0
    nv = -(-C // (32 * e))
    return nv if nv <= 4 else 6 if nv <= 6 else 8


def fwd_blocks(M: int, C: int, dtype: torch.dtype, aligned: bool,
               sms: int) -> int:
    """The forward's grid: on the register path ``_FWD_BLOCKS_PER_SM``
    blocks of ``_FWD_WARPS`` warps on each of the card's ``sms`` SMs,
    fewer where the rows do not fill them (a warp takes a row at a time);
    on the chunked path a block of ``_CHUNK_WARPS`` rows
    (``csrc/layer_norm.cu :: fwd_blocks``)."""
    if not reg_vectors(C, dtype, aligned):
        return -(-M // _CHUNK_WARPS)
    return min(-(-M // _FWD_WARPS), _FWD_BLOCKS_PER_SM * sms)


def bwd_scratch_shape(M: int, C: int, sms: int, blocks=None):
    """The backward's f32 scratch: one dgamma and one dbeta partial row
    per block (``blocks``, or :func:`bwd_blocks`)."""
    return (blocks or bwd_blocks(M, sms), 2, C)


def _row_cost(M: int, C: int, esize: int, streams: int):
    """(FLOPs, bytes) of a LayerNorm launch: the same on every grid."""
    return lambda plan: (8.0 * M * C, float(streams * M * C * esize))


def fwd_plan(M: int, C: int, dtype: torch.dtype, aligned: bool, sms: int,
             device=None, probe=None) -> int:
    """Blocks of the forward's grid for this call: :func:`fwd_blocks`, or
    the tuner's grid. On the register path the launcher takes 1 to
    ``ceil(M / _FWD_WARPS)`` blocks (a warp a row, with a grid stride);
    the chunked path's grid is fixed, and not consulted."""
    default = fwd_blocks(M, C, dtype, aligned, sms)
    if not reg_vectors(C, dtype, aligned):
        return default
    most = -(-M // _FWD_WARPS)
    out = _at.tuned_plan(
        KERNEL, {"M": M, "C": C, "esize": dtype.itemsize,
                 "aligned": int(aligned)}, {"blocks": default},
        lambda: [{"blocks": min(most, k * sms)} for k in (1, 2, 3, 6, 8)],
        lambda p: _int_in(p.get("blocks"), 1, most),
        cost=_row_cost(M, C, dtype.itemsize, 2), probe=probe, device=device)
    return out["blocks"]


def bwd_plan(M: int, C: int, dtype: torch.dtype, sms: int, device=None,
             probe=None) -> int:
    """Persistent blocks of the backward for this call:
    :func:`bwd_blocks`, or the tuner's count, 1 to ``ceil(M /
    _BWD_WARPS)`` (a warp a row, with a grid stride)."""
    default = bwd_blocks(M, sms)
    most = -(-M // _BWD_WARPS)
    out = _at.tuned_plan(
        BWD_KERNEL, {"M": M, "C": C, "esize": dtype.itemsize},
        {"blocks": default},
        lambda: [{"blocks": min(most, k * sms)} for k in (1, 3, 4, 6)],
        lambda p: _int_in(p.get("blocks"), 1, most),
        cost=_row_cost(M, C, dtype.itemsize, 3), probe=probe, device=device)
    return out["blocks"]


def _int_in(v, lo: int, hi: int) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and lo <= v <= hi


def _lib():
    lib = _cb.library(SOURCE)
    if not hasattr(lib, "_mxt_ready"):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fwd = [p, p, p, p, ctypes.c_int64, i32, ctypes.c_float, i32, i32,
               i32]
        lib.mxt_layer_norm_fwd.argtypes = fwd + [ctypes.c_int64, p]
        lib.mxt_layer_norm_fwd.restype = i32
        lib.mxt_layer_norm_fwd_gamma_shift.argtypes = fwd + [i32, p]
        lib.mxt_layer_norm_fwd_gamma_shift.restype = i32
        lib.mxt_layer_norm_fwd_blocks.argtypes = [ctypes.c_int64, i32, i32,
                                                  i32, i32]
        lib.mxt_layer_norm_fwd_blocks.restype = ctypes.c_int64
        f = lib.mxt_layer_norm_bwd
        f.argtypes = [p, p, p, p, p, p, p, ctypes.c_int64, i32,
                      ctypes.c_float, i32, i32, i32, p]
        f.restype = i32
        lib.mxt_layer_norm_vectors.argtypes = [i32, i32]
        lib.mxt_layer_norm_vectors.restype = i32
        lib._mxt_ready = True
    return lib


def layer_norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float,
                    blocks=None) -> torch.Tensor:
    """Launch the kernel on (..., C) ``x``; gamma/beta (C,) of any
    float dtype. Inputs must be contiguous CUDA tensors. ``blocks``: the
    grid (None: :func:`fwd_plan` with the tuner on, else 0, the
    launcher's own grid)."""
    dtypes = tuple(_cb.DTYPE_CODES)
    _cb.check_cuda_tensor(KERNEL, "x", x, dtypes)
    for name, p in (("gamma", gamma), ("beta", beta)):
        _cb.check_cuda_tensor(KERNEL, name, p, dtypes, x.device)
        if p.dtype != gamma.dtype or tuple(p.shape) != (x.shape[-1],):
            raise MXNetError("%s: %s must be (%d,) of gamma's dtype, got %s %s"
                             % (KERNEL, name, x.shape[-1], tuple(p.shape),
                                p.dtype))
    C = x.shape[-1]
    M = x.numel() // C
    y = torch.empty_like(x)
    lib = _lib()
    sms = _cb.sm_count(x.device)
    if blocks is None and _at.enabled():
        aligned = aligned16(x, y, gamma, beta)
        # the chunked path takes only its own grid
        if reg_vectors(C, x.dtype, aligned):
            blocks = fwd_plan(M, C, x.dtype, aligned, sms, x.device,
                              _fwd_probe(x, gamma, beta, eps))
    with torch.cuda.device(x.device):
        rc = lib.mxt_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            M, C, float(eps), _cb.DTYPE_CODES[x.dtype],
            _cb.DTYPE_CODES[gamma.dtype], sms, int(blocks or 0),
            _cb.stream_of(x))
    _cb.check_launch(lib, rc, KERNEL)
    return y


def _fwd_probe(x, gamma, beta, eps):
    """The tuner's runner of a forward plan on this call's tensors."""
    return lambda plan: (lambda: (
        lambda: layer_norm_cuda(x, gamma, beta, eps, plan["blocks"]), ()))


def _bwd_probe(dy, x, gamma, eps):
    return lambda plan: (lambda: (
        lambda: layer_norm_bwd_cuda(dy, x, gamma, eps, plan["blocks"]), ()))


def layer_norm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor,
                        gamma: torch.Tensor, eps: float, blocks=None):
    """Launch the backward kernel on (M, C) ``dy`` and ``x``; returns
    (dx, dgamma, dbeta), the last two in gamma's dtype. ``blocks``: the
    persistent grid (:func:`bwd_plan` when None)."""
    dtypes = tuple(_cb.DTYPE_CODES)
    _cb.check_cuda_tensor(BWD_KERNEL, "x", x, dtypes)
    _cb.check_cuda_tensor(BWD_KERNEL, "dy", dy, (x.dtype,), x.device)
    _cb.check_cuda_tensor(BWD_KERNEL, "gamma", gamma, dtypes, x.device)
    if x.dim() != 2 or dy.shape != x.shape or \
            tuple(gamma.shape) != (x.shape[-1],):
        raise MXNetError("%s: dy and x must be (M, C) and gamma (C,), got "
                         "%s, %s, %s" % (BWD_KERNEL, tuple(dy.shape),
                                         tuple(x.shape), tuple(gamma.shape)))
    M, C = x.shape
    lib = _lib()
    sms = _cb.sm_count(x.device)
    if blocks is None:
        blocks = bwd_plan(M, C, x.dtype, sms, x.device,
                          _bwd_probe(dy, x, gamma, eps)) \
            if _at.enabled() else bwd_blocks(M, sms)
    part = torch.empty(bwd_scratch_shape(M, C, sms, blocks),
                       dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    with torch.cuda.device(x.device):
        rc = lib.mxt_layer_norm_bwd(
            dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), M, C,
            float(eps), _cb.DTYPE_CODES[x.dtype],
            _cb.DTYPE_CODES[gamma.dtype], part.shape[0], _cb.stream_of(x))
    _cb.check_launch(lib, rc, BWD_KERNEL)
    return dx, dgamma, dbeta


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.is_cuda:
        return layer_norm_cuda(x, gamma, beta, eps)
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    raise MXNetError("%s: no kernel for device %s" % (KERNEL, x.device))


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                   eps: float):
    """LayerNorm backward: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.is_cuda:
        return layer_norm_bwd_cuda(dy, x, gamma, eps)
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(dy, x, gamma, eps)
    raise MXNetError("%s: no kernel for device %s" % (BWD_KERNEL, x.device))


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(dy.contiguous(), x, gamma,
                                           ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm_fn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of 2-D ``x`` with its backward
    (gamma and beta of one dtype): forward and backward each go to the
    kernel for a CUDA tensor and to the plain version for a CPU one."""
    return _cb.apply(_LayerNormFn, layer_norm, x, gamma, beta, eps)
