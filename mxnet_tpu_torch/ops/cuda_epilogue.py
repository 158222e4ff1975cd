"""Dense epilogues, bias+GeLU and bias+residual: the hand-written CUDA
kernels and their plain PyTorch versions (counterpart of
``mxnet_tpu/ops/pallas_epilogue.py``).

``bias_gelu``, ``bias_gelu_bwd`` and ``bias_residual`` send CUDA tensors
to the kernels of ``csrc/epilogue.cu`` (which replace
``pallas_epilogue.py :: _bias_gelu_fwd_call -> pallas_bias_gelu_fwd``,
``_bias_gelu_bwd_call -> pallas_bias_gelu_bwd`` and ``_residual_fwd_call
-> pallas_residual_fwd``) and CPU tensors to the plain versions; they
decide by the tensor's device alone. Arithmetic, f32 inside with the
bias read as f32:

* gelu: ``z = x + b; 0.5 * z * (1 + erf(z / sqrt(2)))``
* gelu backward: ``dz = dy * (Phi(z) + z * phi(z))``; dx = dz in x's
  dtype, db = sum(dz) in f32, then in the bias's dtype
* residual: ``(x + b) + r``; its backward is the reference's
  composition ``(dy, sum(dy) in f32 cast to dy's dtype, dy)`` — no
  kernel, because the reference has none

:func:`bias_gelu_fn` and :func:`bias_residual_fn` wrap each forward and
its backward in one ``torch.autograd.Function``.

The three kernels take a 16-byte vector of columns a thread where the
rows hold a whole number of them and the pointers are 16-byte aligned,
else one element a thread (:func:`col_vector`); the two forwards are one
kernel over its epilogue. The bias+GeLU backward's f32 scratch holds one
partial row of db per row strip (:func:`bwd_scratch_shape`, sized from
the card's SM count). Both helpers have C twins in
``csrc/epilogue.cu``, and the launcher refuses a scratch of another
shape.

The reference's row-block limits (``_pick_rows``, at least 8 rows) are
TPU tiling limits, so the kernels serve every row count.

Launch plans: each kernel's grid is its row strips by column tiles, the
strips from the card's SM count (:func:`fwd_strips`,
:func:`bwd_scratch_shape`). With ``MXNET_AUTOTUNE`` on,
:func:`fwd_plan` and :func:`bwd_plan` ask the tuner (``autotune.py``)
for another strip count, 1 to :func:`most_strips` (the launchers refuse
any other), where the reference asks it for another row block
(``pallas_epilogue.py :: _tuned_rows``); the block shape stays compiled.
The forwards' outputs are bit for bit on any grid; the backward's db sums
its strips' partial rows in another order. A bias (or
residual) whose dtype differs from the data's is a numerics reason: the
reference then runs the composition in the promoted dtype, and so does
the port.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import autotune as _at
from ..base import MXNetError
from . import cuda_build as _cb

__all__ = ["gelu_erf", "bias_gelu", "bias_gelu_cuda", "bias_gelu_plain",
           "bias_gelu_bwd", "bias_gelu_bwd_cuda", "bias_gelu_bwd_plain",
           "bias_gelu_fn", "bias_gelu_available", "bias_residual",
           "bias_residual_cuda", "bias_residual_plain", "bias_residual_fn",
           "bias_residual_available", "col_vector", "aligned16",
           "bwd_scratch_shape", "fwd_strips", "most_strips", "fwd_plan",
           "bwd_plan"]

GELU_KERNEL = "bias_gelu_fwd"
GELU_BWD_KERNEL = "bias_gelu_bwd"
RESIDUAL_KERNEL = "bias_residual_fwd"
SOURCE = "epilogue.cu"
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
# the kernels' blocks (csrc/epilogue.cu): _VEC_COLS threads along the
# row by _ROW_LANES down it; a forward thread holds _FWD_ROWS rows at a
# time, _FWD_BLOCKS_PER_SM blocks an SM, a bias+GeLU backward thread
# _BWD_ROWS rows, _BWD_BLOCKS_PER_SM blocks an SM
_VEC_COLS = 64
_ROW_LANES = 4
_FWD_ROWS = 2
_FWD_BLOCKS_PER_SM = 3
_BWD_ROWS = 2
_BWD_BLOCKS_PER_SM = 2


def _available(shape, dtype) -> bool:
    return (len(shape) >= 2 and dtype in _cb.DTYPE_CODES
            and math.prod(shape) > 0)


def bias_gelu_available(shape, dtype, bias_dtype=None) -> bool:
    """True when the fused bias+GeLU serves this call."""
    if bias_dtype is not None and bias_dtype != dtype:
        return False
    return _available(shape, dtype)


def bias_residual_available(shape, dtype, bias_dtype=None,
                            residual_dtype=None) -> bool:
    """True when the fused bias+residual serves this call."""
    for dt in (bias_dtype, residual_dtype):
        if dt is not None and dt != dtype:
            return False
    return _available(shape, dtype)


def gelu_erf(z: torch.Tensor) -> torch.Tensor:
    """Exact GeLU, ``0.5 * z * (1 + erf(z / sqrt(2)))``, in z's dtype."""
    return 0.5 * z * (1.0 + torch.erf(z * _INV_SQRT2))


def bias_gelu_plain(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The bias+GeLU kernel's arithmetic in PyTorch ops."""
    return gelu_erf(x.float() + bias.float()).to(x.dtype)


def bias_gelu_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                        bias: torch.Tensor):
    """The bias+GeLU backward kernel's arithmetic in PyTorch ops, over
    the rows of 2-D ``x``: returns (dx, db)."""
    z = x.float() + bias.float()
    cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))
    pdf = torch.exp(-0.5 * z * z) * _INV_SQRT2PI
    dz = dy.float() * (cdf + z * pdf)
    return dz.to(x.dtype), dz.sum(dim=0).to(bias.dtype)


def aligned16(*tensors) -> bool:
    """True when every tensor's data pointer is 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def col_vector(C: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Elements a thread of the bias+GeLU and bias+residual kernels takes
    along a row of ``C`` elements: a 16-byte vector where the rows hold a
    whole number of them and the pointers are aligned, else 1, the
    element path (``csrc/epilogue.cu :: col_vector``)."""
    e = 16 // dtype.itemsize
    return e if aligned and C % e == 0 else 1


def _row_strips(M: int, C: int, vec: int, sms: int, per_sm: int,
                held: int) -> int:
    """Row strips of a grid: ``per_sm`` blocks on each of ``sms`` SMs over
    the column tiles, at least ``_ROW_LANES * held`` rows a strip, no
    strip empty (``csrc/epilogue.cu :: row_strips``)."""
    tiles = -(-(C // vec) // _VEC_COLS)
    s = max(1, min(per_sm * sms // tiles, -(-M // (_ROW_LANES * held))))
    rows = -(-M // s)
    return -(-M // rows)


def most_strips(M: int, bwd: bool = False) -> int:
    """The most row strips the forwards' (or the backward's) launcher
    takes for ``M`` rows (``csrc/epilogue.cu :: most_strips``)."""
    return -(-M // (_ROW_LANES * (_BWD_ROWS if bwd else _FWD_ROWS)))


def fwd_strips(M: int, C: int, dtype: torch.dtype, aligned: bool,
               sms: int) -> int:
    """Row strips of the two forwards' grid from the card's ``sms`` SMs
    (``csrc/epilogue.cu :: launch_fwd``)."""
    return _row_strips(M, C, col_vector(C, dtype, aligned), sms,
                       _FWD_BLOCKS_PER_SM, _FWD_ROWS)


def bwd_scratch_shape(M: int, C: int, dtype: torch.dtype, aligned: bool,
                      sms: int, strips=None):
    """The backward's f32 scratch, one db partial row per row strip
    (``strips``, else ``_BWD_BLOCKS_PER_SM`` blocks on each of the card's
    ``sms`` SMs over the column tiles, at least ``_ROW_LANES * _BWD_ROWS``
    rows a strip, no strip empty: ``csrc/epilogue.cu :: bwd_strips``)."""
    return (strips or _row_strips(M, C, col_vector(C, dtype, aligned), sms,
                                  _BWD_BLOCKS_PER_SM, _BWD_ROWS), C)


def _plan(kernel, M, C, dtype, aligned, sms, default, per_sm, held, bwd,
          streams, device, probe):
    vec = col_vector(C, dtype, aligned)
    most = most_strips(M, bwd)
    out = _at.tuned_plan(
        kernel, {"M": M, "C": C, "esize": dtype.itemsize,
                 "aligned": int(aligned)}, {"strips": default},
        lambda: [{"strips": _row_strips(M, C, vec, sms, k, held)}
                 for k in per_sm],
        lambda p: isinstance(p.get("strips"), int)
        and not isinstance(p["strips"], bool) and 1 <= p["strips"] <= most,
        cost=lambda p: (10.0 * M * C, float(streams * M * C
                                            * dtype.itemsize)),
        probe=probe, device=device)
    return out["strips"]


def fwd_plan(kernel: str, M: int, C: int, dtype: torch.dtype,
             aligned: bool, sms: int, device=None, probe=None) -> int:
    """Row strips of a forward's grid (``kernel``: ``bias_gelu_fwd`` or
    ``bias_residual_fwd``) for this call: :func:`fwd_strips`, or the
    tuner's count."""
    return _plan(kernel, M, C, dtype, aligned, sms,
                 fwd_strips(M, C, dtype, aligned, sms), (1, 2, 4, 6),
                 _FWD_ROWS, False,
                 3 if kernel == RESIDUAL_KERNEL else 2, device, probe)


def bwd_plan(M: int, C: int, dtype: torch.dtype, aligned: bool, sms: int,
             device=None, probe=None) -> int:
    """Row strips of the bias+GeLU backward for this call: the default
    of :func:`bwd_scratch_shape`, or the tuner's count."""
    return _plan(GELU_BWD_KERNEL, M, C, dtype, aligned, sms,
                 bwd_scratch_shape(M, C, dtype, aligned, sms)[0],
                 (1, 3, 4, 6), _BWD_ROWS, True, 3, device, probe)


def bias_residual_plain(x: torch.Tensor, bias: torch.Tensor,
                        residual: torch.Tensor) -> torch.Tensor:
    """The bias+residual kernel's arithmetic in PyTorch ops."""
    return (x.float() + bias.float() + residual.float()).to(x.dtype)


def _lib():
    lib = _cb.library(SOURCE)
    if not hasattr(lib, "_mxt_ready"):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.mxt_bias_gelu_fwd.argtypes = [p, p, p, i64, i32, i32, i32, i32,
                                          i64, p]
        lib.mxt_bias_gelu_fwd.restype = ctypes.c_int
        res = [p, p, p, p, i64, i32, i32, i32, i32]
        lib.mxt_bias_residual_fwd.argtypes = res + [i64, p]
        lib.mxt_bias_residual_fwd.restype = ctypes.c_int
        lib.mxt_bias_residual_fwd_bias_shift.argtypes = res + [i32, p]
        lib.mxt_bias_residual_fwd_bias_shift.restype = ctypes.c_int
        bwd = [p, p, p, p, p, i64, p, i64, i32, i32, i32, i32]
        lib.mxt_bias_gelu_bwd.argtypes = bwd + [p]
        lib.mxt_bias_gelu_bwd.restype = ctypes.c_int
        lib.mxt_bias_gelu_fwd_bias_shift.argtypes = [p, p, p, i64, i32, i32,
                                                     i32, i32, i32, p]
        lib.mxt_bias_gelu_fwd_bias_shift.restype = ctypes.c_int
        lib.mxt_bias_gelu_bwd_bias_shift.argtypes = bwd + [i32, p]
        lib.mxt_bias_gelu_bwd_bias_shift.restype = ctypes.c_int
        lib.mxt_bias_col_vector.argtypes = [i32, i32]
        lib.mxt_bias_col_vector.restype = i32
        lib.mxt_bias_gelu_bwd_strips.argtypes = [i64, i32, i32, i32]
        lib.mxt_bias_gelu_bwd_strips.restype = i64
        lib.mxt_bias_fwd_strips.argtypes = [i64, i32, i32, i32]
        lib.mxt_bias_fwd_strips.restype = i64
        lib.mxt_bias_most_strips.argtypes = [i64, i32]
        lib.mxt_bias_most_strips.restype = i64
        lib._mxt_ready = True
    return lib


def _check(kernel, x, bias, residual=None):
    dtypes = tuple(_cb.DTYPE_CODES)
    _cb.check_cuda_tensor(kernel, "x", x, dtypes)
    _cb.check_cuda_tensor(kernel, "bias", bias, dtypes, x.device)
    if x.dim() < 1 or tuple(bias.shape) != (x.shape[-1],):
        raise MXNetError("%s: bias must be (%d,), got %s"
                         % (kernel, x.shape[-1], tuple(bias.shape)))
    if residual is not None:
        _cb.check_cuda_tensor(kernel, "residual", residual, (x.dtype,),
                              x.device)
        if residual.shape != x.shape:
            raise MXNetError("%s: residual shape %s differs from x's %s"
                             % (kernel, tuple(residual.shape),
                                tuple(x.shape)))


def _probe(fn, *args):
    """The tuner's runner of a plan on this call's tensors."""
    return lambda plan: (lambda: (lambda: fn(*args, plan["strips"]), ()))


def bias_gelu_cuda(x: torch.Tensor, bias: torch.Tensor,
                   strips=None) -> torch.Tensor:
    """Launch the bias+GeLU kernel on contiguous CUDA tensors; ``strips``:
    the grid's row strips (None: :func:`fwd_plan` with the tuner on, else
    0, the launcher's own grid)."""
    _check(GELU_KERNEL, x, bias)
    C = x.shape[-1]
    M = x.numel() // C
    y = torch.empty_like(x)
    lib = _lib()
    sms = _cb.sm_count(x.device)
    if strips is None:
        strips = fwd_plan(GELU_KERNEL, M, C, x.dtype, aligned16(x, y), sms,
                          x.device, _probe(bias_gelu_cuda, x, bias)) \
            if _at.enabled() else 0
    with torch.cuda.device(x.device):
        rc = lib.mxt_bias_gelu_fwd(
            x.data_ptr(), bias.data_ptr(), y.data_ptr(), M, C, sms,
            _cb.DTYPE_CODES[x.dtype], _cb.DTYPE_CODES[bias.dtype],
            int(strips), _cb.stream_of(x))
    _cb.check_launch(lib, rc, GELU_KERNEL)
    return y


def bias_gelu_bwd_cuda(dy: torch.Tensor, x: torch.Tensor,
                       bias: torch.Tensor, strips=None):
    """Launch the bias+GeLU backward kernel on contiguous (M, C) CUDA
    tensors; returns (dx, db). ``strips``: the row strips
    (:func:`bwd_plan` when None)."""
    _check(GELU_BWD_KERNEL, x, bias)
    _cb.check_cuda_tensor(GELU_BWD_KERNEL, "dy", dy, (x.dtype,), x.device)
    if x.dim() != 2 or dy.shape != x.shape:
        raise MXNetError("%s: dy and x must be (M, C) of one shape, got %s "
                         "and %s" % (GELU_BWD_KERNEL, tuple(dy.shape),
                                     tuple(x.shape)))
    M, C = x.shape
    dx = torch.empty_like(x)
    sms = _cb.sm_count(x.device)
    if strips is None:
        aligned = aligned16(dy, x, dx)
        strips = bwd_plan(M, C, x.dtype, aligned, sms, x.device,
                          _probe(bias_gelu_bwd_cuda, dy, x, bias)) \
            if _at.enabled() else \
            bwd_scratch_shape(M, C, x.dtype, aligned, sms)[0]
    part = torch.empty((strips, C), dtype=torch.float32, device=x.device)
    db = torch.empty_like(bias)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.mxt_bias_gelu_bwd(
            dy.data_ptr(), x.data_ptr(), bias.data_ptr(), dx.data_ptr(),
            part.data_ptr(), part.shape[0], db.data_ptr(), M, C, sms,
            _cb.DTYPE_CODES[x.dtype], _cb.DTYPE_CODES[bias.dtype],
            _cb.stream_of(x))
    _cb.check_launch(lib, rc, GELU_BWD_KERNEL)
    return dx, db


def bias_residual_cuda(x: torch.Tensor, bias: torch.Tensor,
                       residual: torch.Tensor, strips=None) -> torch.Tensor:
    """Launch the bias+residual kernel on contiguous CUDA tensors;
    ``strips``: the grid's row strips (None: :func:`fwd_plan` with the
    tuner on, else 0, the launcher's own grid)."""
    _check(RESIDUAL_KERNEL, x, bias, residual)
    C = x.shape[-1]
    M = x.numel() // C
    y = torch.empty_like(x)
    lib = _lib()
    sms = _cb.sm_count(x.device)
    if strips is None:
        strips = fwd_plan(RESIDUAL_KERNEL, M, C, x.dtype,
                          aligned16(x, y, residual), sms, x.device,
                          _probe(bias_residual_cuda, x, bias, residual)) \
            if _at.enabled() else 0
    with torch.cuda.device(x.device):
        rc = lib.mxt_bias_residual_fwd(
            x.data_ptr(), bias.data_ptr(), residual.data_ptr(), y.data_ptr(),
            M, C, sms, _cb.DTYPE_CODES[x.dtype],
            _cb.DTYPE_CODES[bias.dtype], int(strips), _cb.stream_of(x))
    _cb.check_launch(lib, rc, RESIDUAL_KERNEL)
    return y


def bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """GeLU(x + bias): the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.is_cuda:
        return bias_gelu_cuda(x, bias)
    if x.device.type == "cpu":
        return bias_gelu_plain(x, bias)
    raise MXNetError("%s: no kernel for device %s" % (GELU_KERNEL, x.device))


def bias_residual(x: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor) -> torch.Tensor:
    """x + bias + residual: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.is_cuda:
        return bias_residual_cuda(x, bias, residual)
    if x.device.type == "cpu":
        return bias_residual_plain(x, bias, residual)
    raise MXNetError("%s: no kernel for device %s"
                     % (RESIDUAL_KERNEL, x.device))


def bias_gelu_bwd(dy: torch.Tensor, x: torch.Tensor, bias: torch.Tensor):
    """The bias+GeLU backward: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.is_cuda:
        return bias_gelu_bwd_cuda(dy, x, bias)
    if x.device.type == "cpu":
        return bias_gelu_bwd_plain(dy, x, bias)
    raise MXNetError("%s: no kernel for device %s"
                     % (GELU_BWD_KERNEL, x.device))


class _BiasGeluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_gelu(x, bias)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        return bias_gelu_bwd(dy.contiguous(), x, bias)


class _BiasResidualFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, residual):
        return bias_residual(x, bias, residual)

    @staticmethod
    def backward(ctx, dy):
        # the reference's composition (pallas_epilogue.py, bwd of
        # _make_bias_residual): identity fan-out and one f32 reduction
        return dy, dy.float().sum(dim=0).to(dy.dtype), dy


def bias_gelu_fn(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """GeLU(x + bias) on 2-D ``x`` with its backward (bias of x's
    dtype)."""
    return _cb.apply(_BiasGeluFn, bias_gelu, x, bias)


def bias_residual_fn(x: torch.Tensor, bias: torch.Tensor,
                     residual: torch.Tensor) -> torch.Tensor:
    """x + bias + residual on 2-D tensors of one dtype, with its
    backward."""
    return _cb.apply(_BiasResidualFn, bias_residual, x, bias, residual)
