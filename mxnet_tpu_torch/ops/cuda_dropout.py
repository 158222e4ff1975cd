"""Inverted dropout with the mask generated in the kernel: the
hand-written CUDA kernel and its plain PyTorch version (counterpart of
``mxnet_tpu/ops/pallas_dropout.py``).

``dropout`` sends a CUDA tensor to the kernel (``csrc/dropout.cu``,
which replaces ``pallas_dropout.py :: _drop_call ->
pallas_dropout_kernel``) and a CPU tensor to ``dropout_plain``; it
decides by the tensor's device alone. Both keep an element iff its
random bits are >= ``min(int(p * 2^32), 2^32 - 1)`` and return
``keep ? x * f32(1 / (1 - p)) : 0`` computed in f32 and rounded to x's
dtype. The bits are :func:`hash_bits` of the element's linear index and
one int32 seed per call (a device tensor, so drawing it needs no host
sync); kernel and plain version draw the same bits. The backward is the
same function applied to the output gradient with the same seed
(:func:`dropout_fn`), so the mask is regenerated, never stored.

The reference draws its bits from the TPU's hardware generator, which
has no counterpart here (and no interpreter form, so its CPU path is a
``jax.random.bernoulli`` composition): parity with it is by
distribution — keep rate, scale, the same mask forward and backward.
The reference's limits (``C % 128``, at least 16 rows) are TPU tiling
limits, so the kernel serves every shape.

The kernel moves 16 bytes an access where ``x`` and ``y`` are 16-byte
aligned and one element an access where they are not (``x`` a view at an
odd offset): :func:`launch_plan` picks the variant and the grid from the
card's SM count, and the second variant's launches are counted apart in
``scalar_launches`` beside the kernel's count in
``cuda_build.launch_counts()["dropout"]``, which counts both.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..base import MXNetError
from . import cuda_build as _cb

__all__ = ["hash_bits", "keep_threshold", "dropout", "dropout_cuda",
           "dropout_plain", "dropout_fn", "dropout_available", "Plan",
           "launch_plan"]

KERNEL = "dropout"
SOURCE = "dropout.cu"
_M32 = 0xFFFFFFFF

# csrc/dropout.cu: threads a block; elements a piece, whose index's high
# word the kernel adds to the seed once; accesses a thread may issue
# before it hashes and stores
THREADS = 256
PIECE = 1 << 32
UNITS = (1, 2, 4)

# launches that took the one-element variant (x or y off 16-byte
# alignment); each is also one launch of the kernel's count
scalar_launches = 0


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for int64 z in [0, 2^32), without int64
    overflow: c is split into 16-bit halves."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bits(idx: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The reference's counter hash (``pallas_attention.py ::
    _keep_mask``, interpreter branch) in int64 arithmetic masked to 32
    bits: z = idx + seed * 0x9E3779B9, then the murmur3 finaliser.
    ``idx`` and ``seed`` are int64 tensors of values in [0, 2^32) that
    broadcast together."""
    z = (idx + _mul32(seed, 0x9E3779B9)) & _M32
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def keep_threshold(p: float) -> int:
    """Bits at or above this are kept (the reference's rule)."""
    return min(int(p * 2 ** 32), 2 ** 32 - 1)


def _scale(p: float) -> float:
    return float(np.float32(1.0 / (1.0 - p)))


def dropout_available(shape, dtype, p) -> bool:
    """True when the kernel serves this call: a non-empty float tensor
    and 0 < p < 1 (the caller runs the composition otherwise)."""
    return 0.0 < p < 1.0 and dtype in _cb.DTYPE_CODES and \
        math.prod(shape) > 0


def dropout_plain(x: torch.Tensor, p: float,
                  seed: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops (in f64 for f64 data, the
    float64 twins of the card checks)."""
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    s = (seed.reshape(()).to(torch.int64) + (idx >> 32)) & _M32
    keep = hash_bits(idx & _M32, s) >= keep_threshold(p)
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.where(keep.reshape(x.shape), x.to(acc) * _scale(p), 0.0)
    return y.to(x.dtype)


class Plan(NamedTuple):
    """One launch of ``csrc/dropout.cu``: 16-byte accesses (``vector``)
    of ``elems`` elements, else one element an access; ``units``
    accesses a thread at a time; a grid of ``blocks`` by ``pieces``."""
    vector: bool
    elems: int
    units: int
    blocks: int
    pieces: int


def launch_plan(n: int, itemsize: int, aligned: bool, sms: int,
                per_sm: Mapping[int, int]) -> Plan:
    """The launch for ``n`` elements of ``itemsize`` bytes on a card of
    ``sms`` SMs that keeps ``per_sm[u]`` blocks of the variant with ``u``
    accesses a thread resident on each. ``aligned``: x and y both 16-byte
    aligned. The tensor is cut into 2^32-element pieces; a piece's
    vectors (whole accesses; the rest, fewer than ``elems``, are the
    tail) take one pass of the fewest units a thread for which one wave
    of blocks covers them, else loop on one wave of four-unit blocks."""
    elems = 16 // itemsize if aligned else 1
    pieces = -(-n // PIECE)
    nvec = min(n, PIECE) // elems
    for units in UNITS:
        wave = sms * per_sm[units]
        blocks = -(-nvec // (THREADS * units))
        if blocks <= wave:
            break
    else:
        blocks = wave
    return Plan(aligned, elems, units, max(blocks, 1), pieces)


def _lib():
    lib = _cb.library(SOURCE)
    if not hasattr(lib, "_mxt_ready"):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mxt_dropout.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_uint32,
                                    ctypes.c_float, i32, i32, i32, i32, i32,
                                    p]
        lib.mxt_dropout.restype = i32
        lib.mxt_dropout_blocks_per_sm.argtypes = [i32, i32, i32]
        lib.mxt_dropout_blocks_per_sm.restype = i32
        lib._mxt_ready = True
    return lib


@functools.lru_cache(maxsize=None)
def _per_sm(device: torch.device, code: int, vector: bool):
    """{units: resident blocks an SM} of each variant, from the CUDA
    occupancy calculator."""
    lib = _lib()
    out = {}
    with torch.cuda.device(device):
        for units in UNITS:
            nb = lib.mxt_dropout_blocks_per_sm(code, int(vector), units)
            if nb < 1:
                raise MXNetError("%s: no occupancy for %d units (%s)" % (
                    KERNEL, units, lib.mxt_error_string(-nb).decode()
                    if nb < 0 else "0 blocks an SM"))
            out[units] = nb
    return out


def dropout_cuda(x: torch.Tensor, p: float,
                 seed: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA ``x``; ``seed`` is one
    int32 on the same card."""
    _cb.check_cuda_tensor(KERNEL, "x", x, tuple(_cb.DTYPE_CODES))
    _cb.check_cuda_tensor(KERNEL, "seed", seed, (torch.int32,), x.device)
    if seed.numel() != 1 or not 0.0 < p < 1.0:
        raise MXNetError("%s: needs one seed and 0 < p < 1, got %d seeds "
                         "and p=%g" % (KERNEL, seed.numel(), p))
    global scalar_launches
    y = torch.empty_like(x)
    lib = _lib()
    code = _cb.DTYPE_CODES[x.dtype]
    aligned = (x.data_ptr() | y.data_ptr()) % 16 == 0
    plan = launch_plan(x.numel(), x.element_size(), aligned,
                       _cb.sm_count(x.device),
                       _per_sm(x.device, code, aligned))
    with torch.cuda.device(x.device):
        rc = lib.mxt_dropout(x.data_ptr(), y.data_ptr(), seed.data_ptr(),
                             x.numel(), keep_threshold(p), _scale(p), code,
                             int(plan.vector), plan.units, plan.blocks,
                             plan.pieces, _cb.stream_of(x))
    _cb.check_launch(lib, rc, KERNEL)
    if not plan.vector:
        scalar_launches += 1
    return y


def dropout(x: torch.Tensor, p: float, seed: torch.Tensor) -> torch.Tensor:
    """Inverted dropout: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.is_cuda:
        return dropout_cuda(x, p, seed)
    if x.device.type == "cpu":
        return dropout_plain(x, p, seed)
    raise MXNetError("%s: no kernel for device %s" % (KERNEL, x.device))


class _DropoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, seed):
        ctx.save_for_backward(seed)
        ctx.p = p
        return dropout(x, p, seed)

    @staticmethod
    def backward(ctx, dy):
        seed, = ctx.saved_tensors
        return dropout(dy.contiguous(), ctx.p, seed), None, None


def dropout_fn(x: torch.Tensor, p: float, seed: torch.Tensor) -> torch.Tensor:
    """Dropout of contiguous ``x`` with its backward, the same mask
    regenerated from ``seed``."""
    return _cb.apply(_DropoutFn, dropout, x, p, seed)
