"""Fused ResNet-v1 bottleneck stages with the dual-matmul BN-backward
kernel (counterpart of ``mxnet_tpu/ops/pallas_fused.py``).

The forward is plain PyTorch, as it is plain XLA in the reference: the
1x1 convolutions are matmuls on the ``[positions, C]`` view, the 3x3
convolution is ``F.conv2d``, the batch statistics one f32 pass. Each
``jax.custom_vjp`` of the reference is a ``torch.autograd.Function``
(:func:`_make_op`, :func:`_make_block`, :func:`_make_stage`) whose
backward calls :func:`dual_bwd` wherever the reference calls its Pallas
kernel (``pallas_fused.py :: _dual_bwd``): it forms the BN-backward
transform ``cdy = bf16(jg·a + y·b_c + c_c)`` of a relu-masked upstream
gradient once and feeds both backward matmuls, ``dx = cdy·Wᵀ (+
addend)`` and ``dW = Σ xᵀ·cdy`` in f32. The 3x3 convolution's backward
is torch's (its input gradient a convolution with the flipped kernel,
its weight gradient ``aten.convolution_backward``), standing in for the
reference's XLA ones.

``dual_bwd`` sends CUDA tensors to the kernel of ``csrc/dual_bwd.cu``
and CPU tensors to :func:`dual_bwd_plain`, which keeps the kernel's
rounding points; it decides by the tensor's device alone. The reference
runs its kernel only where a row tile fits the TPU's VMEM (``_pick_bm``)
and otherwise falls back to jnp math; that is a TPU budget, so the port
runs the kernel for every shape. Its inputs are always rounded to bf16,
as the reference's kernel path rounds them; for f32 activations at shapes
where the reference falls back, the two differ (ROADMAP.md queue 3).

Layouts: NHWC or HWNC activations (channels last), 1x1 weights as
``[I, O]``, HWIO ``[1, 1, I, O]`` or OIHW ``[O, I, 1, 1]``, the 3x3 in
HWIO. Both layouts flatten to ``[positions, C]`` with a reshape; for NHWC
the reference transposes to HWNC first, which permutes the rows and so
changes only the order of f32 sums.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import cuda_build as _cb

__all__ = ["conv1x1_bn_act", "conv1x1_bn_act_ref", "bottleneck_v1_block",
           "bottleneck_v1_block_ref", "fused_stage", "dual_bwd",
           "dual_bwd_cuda", "dual_bwd_plain", "MASK_MODES"]

KERNEL = "dual_bwd"
SOURCE = "dual_bwd.cu"
MASK_MODES = {"none": 0, "scale_shift": 1, "out": 2}
# the kernel's tiles (csrc/dual_bwd.cu)
_DX_TILE = (128, 64)    # (rows, I) of one dx tile
_DW_TILE = (64, 128)    # (I, O) of one dW tile
_BK = 32                # depth of one step of either product
_EPI_ROWS = 32          # rows of one block of the split dx's epilogue
_FILL = 2               # blocks an SM that each grid aims for
_MIN_SLICE = 256        # the least O depth of one dx slice
_FUSE_I, _FUSE_O = 64, 256   # the widest call one block takes whole


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------
def dual_bwd_plain(jg, y, x, w, coef, mask_mode, mask=None, addend=None,
                   emit_jg=False, y3p=None, mprev=None, rounding=True):
    """The dual-backward kernel's arithmetic in PyTorch ops.

    jg, y: [M, O] bf16; x: [M, I] bf16; w: [I, O] bf16; coef: [8, O] f32
    (rows a, b_c, c_c, scale, shift); mask: [M, O] bf16 for
    ``mask_mode="out"``; addend: [M, I] bf16 added to dx in f32; y3p:
    [M, I] bf16 and mprev: [I] f32 for the chaining sums. Returns (dx
    [M, I] bf16, dW [I, O] f32, the masked jg [M, O] bf16 or None, sums
    [2, I] f32 or None): with ``y3p``, dx is masked by ``x > 0`` and
    sums holds Σ dx and Σ dx·(y3p − mprev) over the rows, both from the
    bf16-rounded dx. ``rounding=False`` drops the bf16 roundings (of
    the masked jg, cdy and dx), for an f32 yardstick."""
    def rnd(t):
        return t.to(torch.bfloat16) if rounding else t
    jgf = jg.float()
    yv = y.float()
    if mask_mode == "scale_shift":
        jgf = torch.where(yv * coef[3] + coef[4] > 0, jgf, 0.0)
    elif mask_mode == "out":
        jgf = torch.where(mask.float() > 0, jgf, 0.0)
    elif mask_mode != "none":
        raise MXNetError("dual_bwd: unknown mask_mode %r" % (mask_mode,))
    jg_out = rnd(jgf) if emit_jg else None
    # one rounding of cdy; the same bits feed both products
    cdyf = rnd(jgf * coef[0] + yv * coef[1] + coef[2]).float()
    dx = cdyf @ w.float().t()
    if addend is not None:
        dx = dx + addend.float()
    sums = None
    if y3p is not None:
        dx = rnd(torch.where(x.float() > 0, dx, 0.0))
        dxf = dx.float()
        sums = torch.stack([dxf.sum(dim=0),
                            (dxf * (y3p.float() - mprev)).sum(dim=0)])
    else:
        dx = rnd(dx)
    dw = x.float().t() @ cdyf
    return dx, dw, jg_out, sums


def _lib():
    lib = _cb.library(SOURCE)
    if not hasattr(lib, "_mxt_ready"):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.mxt_dual_bwd.argtypes = [p] * 17 + [i64, i32, i32, i32, i32,
                                                i64, i32, i32, i32, i32, p]
        lib.mxt_dual_bwd.restype = ctypes.c_int
        lib._mxt_ready = True
    return lib


def _cdiv(a, b):
    return -(-a // b)


def dual_plan(M, I, O, sms, emit_next=False, aligned=True):
    """How the kernel splits one call over a card of ``sms`` SMs, and the
    scratch it needs:

    - ``fused``: one block takes both products of its rows (I at most 64,
      O above 128 and at most 256, no chaining sums, I and O multiples of
      8, every operand 16-byte ``aligned``: stage 1's tails and
      downsample; at O = 64, stage 1's first head, the cdy pass is as
      fast), ``_FILL`` blocks an SM, no cdy scratch;
    - ``splits_w``, ``rows_w``: the dW rows split so that the dW blocks
      give about ``_FILL`` blocks an SM, each split a multiple of ``_BK``
      rows and at least 128 where M allows (fused: the blocks above, a
      multiple of ``_BK`` rows each);
    - ``splits_x``, ``depth_x``: the O depth of dx split into slices
      where the dx tiles alone give fewer than ``_FILL`` blocks an SM,
      each slice a multiple of ``_BK`` and at least ``_MIN_SLICE`` deep
      (one slice, ``depth_x >= O``, elsewhere);
    - the shapes of the scratch tensors: ``cdy`` (bf16; None when fused),
      ``part_dw``, ``part_dx`` (None for one slice) and ``part_sums``
      (None without ``emit_next``), all f32 but cdy."""
    fused = (I <= _FUSE_I and _FUSE_O // 2 < O <= _FUSE_O and not emit_next
             and aligned and I % 8 == 0 and O % 8 == 0)
    if fused:
        splits = min(_FILL * sms, _cdiv(M, _BK))
    else:
        tiles_w = _cdiv(I, _DW_TILE[0]) * _cdiv(O, _DW_TILE[1])
        splits = max(1, min(_cdiv(_FILL * sms, tiles_w), _cdiv(M, 128)))
    rows_w = _cdiv(_cdiv(M, splits), _BK) * _BK
    tiles_x = _cdiv(M, _DX_TILE[0]) * _cdiv(I, _DX_TILE[1])
    splits_x = 1
    if tiles_x < _FILL * sms and not fused:
        splits_x = max(1, min(_cdiv(_FILL * sms, tiles_x), O // _MIN_SLICE))
    depth_x = _cdiv(_cdiv(O, splits_x), _BK) * _BK
    splits_x = _cdiv(O, depth_x)
    sum_rows = _EPI_ROWS if splits_x > 1 else _DX_TILE[0]
    return {"fused": fused, "splits_w": _cdiv(M, rows_w), "rows_w": rows_w,
            "splits_x": splits_x, "depth_x": depth_x,
            "cdy": None if fused else (M, O),
            "part_dw": (_cdiv(M, rows_w), I, O),
            "part_dx": (splits_x, M, I) if splits_x > 1 else None,
            "part_sums": (_cdiv(M, sum_rows), 2, I) if emit_next else None}


def dual_bwd_cuda(jg, y, x, w, coef, mask_mode, mask=None, addend=None,
                  emit_jg=False, y3p=None, mprev=None):
    """Launch the dual-backward kernel on contiguous CUDA tensors (the
    shapes and types of :func:`dual_bwd_plain`)."""
    bf = (torch.bfloat16,)
    f32 = (torch.float32,)
    if mask_mode not in MASK_MODES:
        raise MXNetError("%s: unknown mask_mode %r" % (KERNEL, mask_mode))
    _cb.check_cuda_tensor(KERNEL, "x", x, bf)
    dev = x.device
    if x.dim() != 2 or y.dim() != 2:
        raise MXNetError("%s: x and y must be 2-D, got %s and %s"
                         % (KERNEL, tuple(x.shape), tuple(y.shape)))
    M, I = x.shape
    O = y.shape[1]
    want = {"jg": (jg, (M, O), bf), "y": (y, (M, O), bf),
            "w": (w, (I, O), bf), "coef": (coef, (8, O), f32)}
    if mask_mode == "out":
        want["mask"] = (mask, (M, O), bf)
    if addend is not None:
        want["addend"] = (addend, (M, I), bf)
    emit_next = y3p is not None
    if emit_next:
        want["y3p"] = (y3p, (M, I), bf)
        want["mprev"] = (mprev, (I,), f32)
    for name, (t, shape, dtypes) in want.items():
        if t is None:
            raise MXNetError("%s: %s is required" % (KERNEL, name))
        _cb.check_cuda_tensor(KERNEL, name, t, dtypes, dev)
        if tuple(t.shape) != shape:
            raise MXNetError("%s: %s must be %s, got %s"
                             % (KERNEL, name, shape, tuple(t.shape)))
    if M < 1 or I < 1 or O < 1:
        raise MXNetError("%s: empty operand (M, I, O) = (%d, %d, %d)"
                         % (KERNEL, M, I, O))
    operands = [t for t, _, _ in want.values()]
    plan = dual_plan(M, I, O, _cb.sm_count(dev), emit_next,
                     aligned=all(t.data_ptr() % 16 == 0
                                 for t in operands + [x]))
    # held until the launch is queued: a scratch tensor freed earlier
    # could hand its memory to the next one
    scratch = {key: None if plan[key] is None else torch.empty(
        plan[key], dtype=torch.bfloat16 if key == "cdy" else torch.float32,
        device=dev) for key in ("cdy", "part_dw", "part_dx", "part_sums")}
    dx = torch.empty((M, I), dtype=torch.bfloat16, device=dev)
    dw = torch.empty((I, O), dtype=torch.float32, device=dev)
    jg_out = torch.empty((M, O), dtype=torch.bfloat16, device=dev) \
        if emit_jg else None
    sums = torch.empty((2, I), dtype=torch.float32, device=dev) \
        if emit_next else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.mxt_dual_bwd(
            ptr(jg), ptr(y), ptr(x), ptr(w), ptr(coef),
            ptr(mask if mask_mode == "out" else None), ptr(addend),
            ptr(y3p), ptr(mprev), ptr(dx), ptr(dw), ptr(jg_out), ptr(sums),
            *(ptr(scratch[k]) for k in ("cdy", "part_dw", "part_dx",
                                        "part_sums")), M, I, O,
            MASK_MODES[mask_mode], plan["splits_w"], plan["rows_w"],
            plan["splits_x"], plan["depth_x"], int(plan["fused"]),
            _cb.sm_count(dev), _cb.stream_of(x))
    _cb.check_launch(lib, rc, KERNEL)
    return dx, dw, jg_out, sums


def dual_bwd(jg, y, x, w, coef, mask_mode, mask=None, addend=None,
             emit_jg=False, y3p=None, mprev=None):
    """The dual backward: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    args = (jg, y, x, w, coef, mask_mode, mask, addend, emit_jg, y3p, mprev)
    if x.is_cuda:
        return dual_bwd_cuda(*args)
    if x.device.type == "cpu":
        return dual_bwd_plain(*args)
    raise MXNetError("%s: no kernel for device %s" % (KERNEL, x.device))


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------
def _flat(a, fmt):
    """4-D channels-last activations -> [positions, C] (a view where
    ``a`` is contiguous)."""
    return a.reshape(-1, a.shape[3])


def _unflat(a2, shape4, fmt):
    return a2.reshape(shape4[0], shape4[1], shape4[2], -1)


def _as_io(w):
    """Accept [I,O], HWIO [1,1,I,O] or OIHW [O,I,1,1] 1x1 kernels."""
    if w.dim() == 4:
        if tuple(w.shape[:2]) == (1, 1):
            return w.reshape(w.shape[2], w.shape[3])
        if tuple(w.shape[2:]) == (1, 1):
            return w.reshape(w.shape[0], w.shape[1]).t()
        raise ValueError("expected a 1x1 kernel, got %r" % (tuple(w.shape),))
    return w


def _conv1x1(x4, w_io, fmt):
    return _unflat(_flat(x4, fmt) @ w_io.to(x4.dtype), x4.shape, fmt)


def _nchw(a, fmt):
    """Channels-last activations as an NCHW view, and back."""
    return a.permute(0, 3, 1, 2) if fmt == "NHWC" else a.permute(2, 3, 0, 1)


def _from_nchw(a, fmt):
    out = a.permute(0, 2, 3, 1) if fmt == "NHWC" else a.permute(2, 3, 0, 1)
    return out.contiguous()


def _oihw(w_hwio):
    return w_hwio.permute(3, 2, 0, 1)


def _stats(y4, eps):
    """One pass: per-channel mean/var/inv over every position."""
    yf = _flat(y4, None).float()
    n = yf.shape[0]
    s1 = yf.sum(dim=0)
    s2 = (yf * yf).sum(dim=0)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    return mean, var, inv, n


def _bn_coeffs(jg4, y4, mean, inv, gamma, n):
    """Phase-A reductions + per-channel backward coefficients. jg4 must
    already be relu-masked. Returns (a, b_c, c_c, dgamma, dbeta) with
    cdy = a*jg + b_c*y + c_c."""
    jgf = _flat(jg4, None).float()
    s1 = jgf.sum(dim=0)
    dy_xmu = (jgf * (_flat(y4, None).float() - mean)).sum(dim=0)
    return _coeffs_from_sums(s1, dy_xmu, mean, inv, gamma, n)


def _coeffs_from_sums(s1, dy_xmu, mean, inv, gamma, n):
    dgamma = dy_xmu * inv
    dbeta = s1
    a = gamma * inv
    b_c = -a * inv * inv * dy_xmu / n
    c_c = -a * s1 / n - b_c * mean
    return a, b_c, c_c, dgamma, dbeta


def _coef_arr(a, b_c, c_c, scale=None, shift=None):
    z = torch.zeros_like(a)
    return torch.stack([a, b_c, c_c, z if scale is None else scale,
                        z if shift is None else shift, z, z, z])


def _run_dual(jgsrc4, y4, x4, w_io, coef, fmt, mask_mode, maskarr4=None,
              addend4=None, emit_jg=False, y3p4=None, mprev=None,
              rounding=True):
    """Invoke the dual-backward kernel on 4-D activations; returns
    (dx4, dw_io_f32[, jg4][, (s1, dy_xmu) of the preceding BN]).
    ``rounding=False`` runs the plain version in the operands' dtype
    without bf16 roundings: the reference's f32 jnp fallback, an f32
    yardstick for the rounded path."""
    def cast(a):
        return (a.to(torch.bfloat16) if rounding else a).contiguous()

    def flat(a):
        return cast(_flat(a, fmt))
    emit_next = y3p4 is not None
    fn = dual_bwd if rounding else functools.partial(dual_bwd_plain,
                                                     rounding=False)
    dx, dw, jg, sums = fn(
        flat(jgsrc4), flat(y4), flat(x4),
        cast(w_io), coef.contiguous(), mask_mode,
        mask=flat(maskarr4) if mask_mode == "out" else None,
        addend=None if addend4 is None else flat(addend4),
        emit_jg=emit_jg, y3p=flat(y3p4) if emit_next else None,
        mprev=mprev.float().contiguous() if emit_next else None)
    res = [_unflat(dx, x4.shape, fmt), dw]
    if emit_jg:
        res.append(_unflat(jg, y4.shape, fmt))
    if emit_next:
        res.append((sums[0], sums[1]))
    return tuple(res)


def _relu_mask(jg4, y4, sc, sh):
    """jg where the BN output y*scale + shift (in f32) is positive."""
    return torch.where(y4.float() * sc + sh > 0, jg4, 0.0)


# ---------------------------------------------------------------------------
# single fused conv1x1+BN(+relu) unit
# ---------------------------------------------------------------------------
def _fwd_math(x4, w, gamma, beta, relu, eps, fmt="NHWC"):
    y = _conv1x1(x4, w, fmt)
    mean, var, inv, n = _stats(y, eps)
    scale = inv * gamma
    shift = beta - mean * scale
    out = y * scale.to(y.dtype) + shift.to(y.dtype)
    if relu:
        out = torch.clamp_min(out, 0)
    return out, y, mean, var, inv, scale, shift


@functools.lru_cache(maxsize=None)
def _make_op(relu, eps, fmt):
    class Conv1x1BnAct(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x4, w, gamma, beta):
            out, y, mean, var, inv, scale, shift = _fwd_math(
                x4, w, gamma, beta, relu, eps, fmt)
            ctx.save_for_backward(x4, w, gamma)
            ctx.res = (y, mean, inv, scale, shift)
            ctx.mark_non_differentiable(mean, var)
            return out, mean, var

        @staticmethod
        def backward(ctx, dout, _dmean, _dvar):
            x4, w, gamma = ctx.saved_tensors
            y, mean, inv, scale, shift = ctx.res
            n = x4.shape[0] * x4.shape[1] * x4.shape[2]
            jg = dout.float()
            if relu:
                jg = _relu_mask(jg, y, scale, shift)
            a, b_c, c_c, dgamma, dbeta = _bn_coeffs(jg, y, mean, inv, gamma,
                                                    n)
            dx, dw = _run_dual(dout, y, x4, w,
                               _coef_arr(a, b_c, c_c, scale, shift), fmt,
                               "scale_shift" if relu else "none")
            return dx.to(x4.dtype), dw.to(w.dtype), dgamma, dbeta
    return Conv1x1BnAct


def conv1x1_bn_act(x, w, gamma, beta, *, relu=True, eps=1e-5,
                   data_format="NHWC"):
    """Fused train-mode conv1x1+BN(+relu), stride 1, no bias.

    x: [N,H,W,I] ("NHWC") or [H,W,N,I] ("HWNC"); w: [I,O] / [1,1,I,O]
    HWIO / [O,I,1,1] OIHW; gamma/beta [O]. Returns (out, batch_mean,
    batch_var)."""
    w = _as_io(w)
    f = _make_op(bool(relu), float(eps), str(data_format))
    return f.apply(x, w.float(), gamma.float(), beta.float())


def conv1x1_bn_act_ref(x, w, gamma, beta, *, relu=True, eps=1e-5,
                       data_format="NHWC"):
    """Unfused reference (same math, plain torch) for numerics tests."""
    y = _conv1x1(x, _as_io(w), data_format).float()
    red = (0, 1, 2)
    mean = y.mean(dim=red)
    var = torch.clamp_min((y * y).mean(dim=red) - mean * mean, 0.0)
    out = (y - mean) * torch.rsqrt(var + eps) * gamma + beta
    if relu:
        out = torch.clamp_min(out, 0)
    return out.to(x.dtype), mean, var


# ---------------------------------------------------------------------------
# fused bottleneck block (conv1x1+bn+relu -> conv3x3+bn+relu ->
# conv1x1+bn -> +shortcut -> relu), stride 1, under ONE autograd.Function
# ---------------------------------------------------------------------------
def _conv3x3(x4, w_hwio, fmt):
    out = F.conv2d(_nchw(x4, fmt), _oihw(w_hwio).to(x4.dtype), padding=1)
    return _from_nchw(out, fmt)


def _conv2_wgrad(z1, cdy, fmt):
    """The 3x3 weight gradient from torch's convolution weight-grad, in
    the operands' dtype, widened to f32 (HWIO)."""
    dw = torch.nn.grad.conv2d_weight(
        _nchw(z1, fmt), (cdy.shape[3], z1.shape[3], 3, 3), _nchw(cdy, fmt),
        padding=1)
    return dw.permute(2, 3, 1, 0).float()


def _conv2_bwd(jg2_src, y2, z1, w2, m2, i2, sc2, sh2, g2, n_pos, fmt):
    """conv2 (3x3) + bn2 + relu backward, plain torch: (dz1, dw2, dg2,
    db2)."""
    jg2 = _relu_mask(jg2_src, y2, sc2, sh2)
    a2, b2c, c2c, dg2, db2 = _bn_coeffs(jg2, y2, m2, i2, g2, n_pos)
    cdy2 = (jg2.float() * a2 + y2.float() * b2c + c2c).to(z1.dtype)
    w_flip = torch.flip(w2, dims=(0, 1)).permute(0, 1, 3, 2)
    dz1 = _conv3x3(cdy2, w_flip, fmt)
    return dz1, _conv2_wgrad(z1, cdy2, fmt), dg2, db2


def _block_fwd_math(x4, params, eps, fmt, has_ds):
    (w1, g1, b1, w2, g2, b2, w3, g3, b3) = params[:9]

    def bn(y, g, b, relu):
        m, v, i, _ = _stats(y, eps)
        sc = i * g
        sh = b - m * sc
        z = y * sc.to(y.dtype) + sh.to(y.dtype)
        return (torch.clamp_min(z, 0) if relu else z), (m, v, i, sc, sh)

    y1 = _conv1x1(x4, w1, fmt)
    z1, (m1, v1, i1, sc1, sh1) = bn(y1, g1, b1, True)
    y2 = _conv3x3(z1, w2, fmt)
    z2, (m2, v2, i2, sc2, sh2) = bn(y2, g2, b2, True)
    y3 = _conv1x1(z2, w3, fmt)
    pre, (m3, v3, i3, sc3, sh3) = bn(y3, g3, b3, False)
    if has_ds:
        wd, gd, bd = params[9:12]
        yd = _conv1x1(x4, wd, fmt)
        shortcut, (md, vd, invd, scd, shd) = bn(yd, gd, bd, False)
        ds_pack = (yd, md, invd, scd, shd)
    else:
        shortcut = x4
        ds_pack = None
    out = torch.clamp_min(pre + shortcut.to(pre.dtype), 0)
    stats = ((m1, v1), (m2, v2), (m3, v3)) + (((md, vd),) if has_ds else ())
    saved = (x4, y1, z1, y2, z2, y3, out,
             (m1, i1, sc1, sh1), (m2, i2, sc2, sh2), (m3, i3, sc3, sh3),
             ds_pack)
    return out, stats, saved


def _detach_out(saved):
    """The saved residuals with the block output detached: an output
    kept on ctx must not hold its own graph node."""
    return saved[:6] + (saved[6].detach(),) + saved[7:]


@functools.lru_cache(maxsize=None)
def _make_block(eps, fmt, has_ds):
    class BottleneckV1Block(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x4, *params):
            out, stats, saved = _block_fwd_math(x4, params, eps, fmt, has_ds)
            flat_stats = [t for pair in stats for t in pair]
            ctx.res = (_detach_out(saved), params)
            ctx.mark_non_differentiable(*flat_stats)
            return (out, *flat_stats)

        @staticmethod
        def backward(ctx, dout, *_dstats):
            saved, params = ctx.res
            dx, _, grads = _block_bwd_chained(
                dout, None, None, saved, params, has_ds, fmt, False, None,
                None)
            return (dx.to(saved[0].dtype), *grads)
    return BottleneckV1Block


def bottleneck_v1_block(x, params, *, eps=1e-5, data_format="NHWC",
                        has_ds=False):
    """Fused ResNet-v1 bottleneck block, stride 1.

    params: (w1,g1,b1, w2_hwio,g2,b2, w3,g3,b3[, wd,gd,bd]); 1x1
    weights in any of [I,O]/HWIO/OIHW, the 3x3 in HWIO. Returns
    (out, ((mean,var) per BN...)) for moving-stats updates.
    """
    p = list(params)
    for k in (0, 6) + ((9,) if has_ds else ()):
        p[k] = _as_io(p[k])
    p = [v.float() for v in p]
    f = _make_block(float(eps), str(data_format), bool(has_ds))
    outs = f.apply(x, *p)
    flat = outs[1:]
    stats = tuple((flat[2 * i], flat[2 * i + 1])
                  for i in range(len(flat) // 2))
    return outs[0], stats


def bottleneck_v1_block_ref(x, params, *, eps=1e-5, data_format="NHWC",
                            has_ds=False):
    """Unfused reference composition for numerics tests."""
    fmt = data_format
    (w1, g1, b1, w2, g2, b2, w3, g3, b3) = params[:9]

    def cbn(x4, w, g, b, relu, k3=False):
        y = (_conv3x3(x4, w, fmt) if k3 else
             _conv1x1(x4, _as_io(w), fmt)).float()
        mean = y.mean(dim=(0, 1, 2))
        var = torch.clamp_min((y * y).mean(dim=(0, 1, 2)) - mean * mean,
                              0.0)
        out = (y - mean) * torch.rsqrt(var + eps) * g + b
        if relu:
            out = torch.clamp_min(out, 0)
        return out.to(x4.dtype), (mean, var)

    z1, s1 = cbn(x, w1, g1, b1, True)
    z2, s2 = cbn(z1, w2, g2, b2, True, k3=True)
    pre, s3 = cbn(z2, w3, g3, b3, False)
    if has_ds:
        wd, gd, bd = params[9:12]
        sc, sd = cbn(x, wd, gd, bd, False)
        return torch.clamp_min(pre + sc, 0), (s1, s2, s3, sd)
    return torch.clamp_min(pre + x.to(pre.dtype), 0), (s1, s2, s3)


# ---------------------------------------------------------------------------
# fused STAGE: a run of stride-1 bottleneck blocks under ONE
# autograd.Function, so the backward chains kernels across block
# boundaries — each head kernel pre-masks its dx by the preceding block's
# join relu and accumulates the preceding BN3's backward reductions on
# the way out, eliminating that block's phase-A pass.
# ---------------------------------------------------------------------------
def _stage_fwd_math(x4, all_params, eps, fmt, ds_first, n_blocks):
    saved_blocks = []
    stats_blocks = []
    cur = x4
    off = 0
    for i in range(n_blocks):
        has_ds = ds_first and i == 0
        take = 12 if has_ds else 9
        out, stats, saved = _block_fwd_math(
            cur, all_params[off:off + take], eps, fmt, has_ds)
        off += take
        saved_blocks.append(saved)
        stats_blocks.append(stats)
        cur = out
    return cur, stats_blocks, saved_blocks


def _block_bwd_chained(dout, jg_in, sums_in, saved, params, has_ds, fmt,
                       chain_prev, prev_y3, prev_m3):
    """Backward of one block inside a fused stage (or alone).

    Either dout (raw cotangent, last block) or jg_in+sums_in
    (pre-masked gradient + this BN3's phase-A sums from the consumer
    block's head kernel) is provided. When chain_prev, the head kernel
    emits the pre-masked gradient and phase-A sums for the PRECEDING
    block (needs prev_y3/prev_m3). Returns (dx-or-jg_prev, sums_prev,
    param grads). The single block's backward is this with neither
    (the reference writes it out twice)."""
    (x4, y1, z1, y2, z2, y3, out,
     (m1, i1, sc1, sh1), (m2, i2, sc2, sh2), (m3, i3, sc3, sh3),
     ds_pack) = saved
    (w1, g1, b1, w2, g2, b2, w3, g3, b3) = params[:9]
    n_pos = x4.shape[0] * x4.shape[1] * x4.shape[2]

    # ---- tail: conv3+bn3 (+ join mask when not pre-masked) ----------
    if jg_in is not None:
        a3, b3c, c3c, dg3, db3 = _coeffs_from_sums(
            sums_in[0], sums_in[1], m3, i3, g3, n_pos)
        dz2, dw3 = _run_dual(jg_in, y3, z2, w3, _coef_arr(a3, b3c, c3c),
                             fmt, "none")
        jg = jg_in
    else:
        jgb = torch.where(out > 0, dout, 0.0)
        a3, b3c, c3c, dg3, db3 = _bn_coeffs(jgb, y3, m3, i3, g3, n_pos)
        dz2, dw3, jg = _run_dual(dout, y3, z2, w3, _coef_arr(a3, b3c, c3c),
                                 fmt, "out", maskarr4=out, emit_jg=True)

    # ---- conv2 (3x3) + bn2 + relu: plain torch ----------------------
    dz1, dw2, dg2, db2 = _conv2_bwd(dz2.to(y2.dtype), y2, z1, w2, m2, i2,
                                    sc2, sh2, g2, n_pos, fmt)

    # ---- head: conv1+bn1+relu (+ shortcut epilogue, + chaining) -----
    a1, b1c, c1c, dg1, db1 = _bn_coeffs(_relu_mask(dz1, y1, sc1, sh1), y1,
                                        m1, i1, g1, n_pos)
    addend = None if has_ds else jg
    kw = dict(y3p4=prev_y3, mprev=prev_m3) if chain_prev else {}
    r1 = _run_dual(dz1, y1, x4, w1, _coef_arr(a1, b1c, c1c, sc1, sh1), fmt,
                   "scale_shift", addend4=addend, **kw)
    dx, dw1 = r1[:2]
    sums_prev = r1[2] if chain_prev else None

    grads = [dw1.to(w1.dtype), dg1, db1, dw2.to(w2.dtype), dg2, db2,
             dw3.to(w3.dtype), dg3, db3]
    if has_ds:
        wd, gd, bd = params[9:12]
        yd, md, invd, scd, shd = ds_pack
        ad, bdc, cdc, dgd, dbd = _bn_coeffs(jg, yd, md, invd, gd, n_pos)
        dx, dwd = _run_dual(jg, yd, x4, wd, _coef_arr(ad, bdc, cdc), fmt,
                            "none", addend4=dx)
        grads += [dwd.to(wd.dtype), dgd, dbd]
    return dx, sums_prev, grads


@functools.lru_cache(maxsize=None)
def _make_stage(eps, fmt, ds_first, n_blocks):
    class FusedStage(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x4, *all_params):
            out, stats_blocks, saved_blocks = _stage_fwd_math(
                x4, all_params, eps, fmt, ds_first, n_blocks)
            flat = [t for stats in stats_blocks for pair in stats
                    for t in pair]
            ctx.res = ([_detach_out(s) for s in saved_blocks], all_params)
            ctx.mark_non_differentiable(*flat)
            return (out, *flat)

        @staticmethod
        def backward(ctx, dout, *_dstats):
            saved_blocks, all_params = ctx.res
            per_block = []
            off = 0
            for i in range(n_blocks):
                take = 12 if (ds_first and i == 0) else 9
                per_block.append(all_params[off:off + take])
                off += take
            jg_in = None
            sums_in = None
            grads_per_block = [None] * n_blocks
            for i in reversed(range(n_blocks)):
                chain_prev = i > 0
                prev_y3 = prev_m3 = None
                if chain_prev:
                    prev_y3 = saved_blocks[i - 1][5]       # y3 of block i-1
                    prev_m3 = saved_blocks[i - 1][9][0]    # m3 of block i-1
                dx, sums_prev, grads = _block_bwd_chained(
                    dout if i == n_blocks - 1 else None, jg_in, sums_in,
                    saved_blocks[i], per_block[i], ds_first and i == 0, fmt,
                    chain_prev, prev_y3, prev_m3)
                grads_per_block[i] = grads
                jg_in = dx
                sums_in = sums_prev
            flat_grads = [g for grads in grads_per_block for g in grads]
            return (jg_in.to(saved_blocks[0][0].dtype), *flat_grads)
    return FusedStage


def fused_stage(x, blocks, *, eps=1e-5, data_format="NHWC",
                ds_first=False):
    """A run of stride-1 ResNet-v1 bottleneck blocks as ONE fused unit.

    blocks: sequence of per-block param tuples — (w1,g1,b1, w2_hwio,
    g2,b2, w3,g3,b3) with an extra (wd,gd,bd) on the first block when
    ds_first. Returns (out, per-block BN stats tuples).
    """
    flat = []
    for i, bp in enumerate(blocks):
        bp = list(bp)
        for k in (0, 6) + ((9,) if ds_first and i == 0 else ()):
            bp[k] = _as_io(bp[k])
        flat.extend(v.float() for v in bp)
    f = _make_stage(float(eps), str(data_format), bool(ds_first),
                    len(blocks))
    outs = f.apply(x, *flat)
    rest = list(outs[1:])
    stats = []
    for i in range(len(blocks)):
        n_bn = 4 if (ds_first and i == 0) else 3
        stats.append(tuple((rest.pop(0), rest.pop(0))
                           for _ in range(n_bn)))
    return outs[0], tuple(stats)
