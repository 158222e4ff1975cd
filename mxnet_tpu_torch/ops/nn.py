"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``; ref:
src/operator/nn/).

``FullyConnected`` is a ``torch.matmul``, ``Convolution`` a
``torch.nn.functional.conv{1,2,3}d`` and ``Deconvolution`` a
``conv_transpose{1,2,3}d``, as the reference leaves all three to XLA
outside any kernel. ``Pooling`` pads explicitly as the reference's
``reduce_window`` does, then pools. ``BatchNorm`` keeps the reference's
arithmetic (statistics shifted by the moving mean, the forward and its
hand-derived backward in per-channel coefficients, the moving statistics
written back through ``mutate_aux``). ``LayerNorm`` over the last axis goes
to :mod:`.cuda_norm` (the hand-written kernels, forward and backward,
for a CUDA tensor, their plain versions for a CPU one); another axis, or
``output_mean_var``, runs the composition with the same formulas (the
reference's ``_ln_fused``). Train-mode ``Dropout`` with a full-shape
mask goes to :mod:`.cuda_dropout`; with ``axes`` it runs the reference's
composition, its mask drawn from the context's generator.

``GroupNorm`` and ``InstanceNorm`` are torch's ``group_norm``, with f32
statistics for 16-bit data. ``SoftmaxOutput`` and the three regression
outputs are ``torch.autograd.Function`` subclasses whose backward ignores the
head gradient, as the reference's custom VJPs do. ``CTCLoss`` runs the
reference's own recursion (``optax.ctc_loss``: blank and label states in
log space, -1e5 for log 0) step by step in torch, so it gives the
reference's finite loss for an impossible alignment, and its backward,
autograd through the steps, has no atomics and is the same on every run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import torch_dtype
from ..context import context_of
from ..symbol import layout_opt as _layout_opt
from . import register
from . import cuda_dropout
from . import cuda_norm
from .elemwise import float_in


@register("FullyConnected", aliases=["fully_connected"])
def fully_connected(data, weight, bias=None, *, num_hidden, no_bias=False,
                    flatten=True):
    """y = x·Wᵀ + b (ref: fully_connected.cc); weight (num_hidden, D)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    y = torch.matmul(x, weight.t())
    if not no_bias and bias is not None:
        y = y + bias
    return y


@register("LayerNorm", aliases=["layer_norm"])
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5,
               output_mean_var=False):
    """Layer normalization (ref: layer_norm.cc). output_mean_var also
    returns the mean and std with the normalized axis reduced."""
    ax = int(axis) % data.dim()
    if not output_mean_var and cuda_norm.ln_available(
            tuple(data.shape), data.dtype, ax):
        C = data.shape[-1]
        if gamma.dtype != beta.dtype:
            gamma, beta = gamma.float(), beta.float()
        out = cuda_norm.layer_norm_fn(data.reshape(-1, C).contiguous(),
                                      gamma.contiguous(), beta.contiguous(),
                                      float(eps))
        return out.reshape(data.shape)
    out, mean, var = cuda_norm.ln_composition(data, gamma, beta, ax,
                                              float(eps))
    if output_mean_var:
        return (out, mean.squeeze(ax).to(data.dtype),
                torch.sqrt(var + eps).squeeze(ax).to(data.dtype))
    return out


@register("Activation", aliases=["activation"])
def activation_op(data, *, act_type):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign (ref:
    activation.cc)."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """The LeakyReLU family (ref: leaky_relu.cc): leaky, prelu (slope
    ``gamma`` per channel of axis 1), elu, selu, gelu (erf) and rrelu
    (the mean slope, as in inference)."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        a = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(pos, data, a * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(pos, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        return torch.where(pos, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError("unknown act_type %r" % act_type)


def _length_mask(data, length, axis):
    """True before each row's length along ``axis``; ``length`` runs
    along axis 0 (ref: nn.py :: softmax)."""
    ax = int(axis) % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    steps = torch.arange(data.shape[ax], device=data.device).reshape(shape)
    lshape = [1] * data.dim()
    lshape[0] = data.shape[0]
    return steps < length.reshape(lshape)


@register("softmax")
def softmax(data, length=None, *, axis=-1, temperature=None, dtype=None,
            use_length=False):
    """Softmax over ``axis``; with ``use_length`` the steps at or past
    each row's ``length`` are left out and come back 0."""
    data = float_in(data)
    x = data if temperature in (None, 1.0) else data / temperature
    if use_length and length is not None:
        mask = _length_mask(data, length, axis)
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
        out = torch.softmax(x, dim=int(axis))
        out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    else:
        out = torch.softmax(x, dim=int(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("log_softmax")
def log_softmax(data, length=None, *, axis=-1, temperature=None, dtype=None,
                use_length=False):
    """Log-softmax over ``axis``; with ``use_length`` the steps at or
    past each row's ``length`` are left out of the sum and come back 0,
    as MXNet's SoftmaxWithLength writes them (the reference's
    log_softmax takes no length)."""
    data = float_in(data)
    x = data if temperature in (None, 1.0) else data / temperature
    if use_length and length is not None:
        mask = _length_mask(data, length, axis)
        x = torch.where(mask, x, torch.full((), float("-inf"),
                                            dtype=x.dtype, device=x.device))
        out = torch.where(mask, torch.log_softmax(x, dim=int(axis)),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    else:
        out = torch.log_softmax(x, dim=int(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("Dropout", aliases=["dropout"], needs_rng=True,
          needs_train_flag=True)
def dropout_op(data, *, p=0.5, mode="training", axes=(), cudnn_off=False,
               _train=False):
    """Inverted dropout (ref: dropout.cc): the identity when not
    training. A full-shape mask is generated inside the dropout kernel
    (regenerated in the backward from the same seed); ``axes`` shares
    the mask along those axes, drawn from the context's generator."""
    if (not _train and mode != "always") or p <= 0.0:
        return data
    ctx = context_of(data.device)
    if not axes and cuda_dropout.dropout_available(
            tuple(data.shape), data.dtype, float(p)):
        return cuda_dropout.dropout_fn(data.contiguous(), float(p),
                                       _random.seeds(1, ctx))
    keep = 1.0 - p
    shape = tuple(1 if i in tuple(axes) else s
                  for i, s in enumerate(data.shape))
    mask = torch.bernoulli(
        torch.full(shape, keep, device=data.device),
        generator=_random.generator(ctx)).to(data.dtype)
    # keep is weakly typed in the reference: rounded to the data's dtype
    return data * (mask / torch.tensor(keep, dtype=data.dtype).item())


# -- Convolution ------------------------------------------------------------
def _tup(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, (int, float)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t + (t[-1],) * (n - len(t))


def _channels_last(layout) -> bool:
    return layout is not None and layout.startswith("N") \
        and layout.endswith("C")


def _to_nc(x, nhwc):
    """N+spatial+C -> NC+spatial (a view)."""
    return x.movedim(-1, 1) if nhwc else x


def _from_nc(x, nhwc):
    return x.movedim(1, -1) if nhwc else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _s2d_enabled():
    from ..config import get as _cfg
    return _cfg("MXNET_CONV_S2D")


def _stem_s2d_conv(data, weight):
    """The 7x7/s2/p3 convolution of NC+HW ``data`` over few channels as a
    4x4 stride-1 convolution of its 2x2 space-to-depth form (the MLPerf
    ResNet stem transform; the reference's ``_stem_s2d_conv``): the same
    sums ``y[i] = sum_p w[p] x[2i+p-3]`` with ``p = 2P+a+3``, in another
    order. The weight stays OIHW; a channels-last ``data`` gives a
    channels-last input to the convolution."""
    O, C = weight.shape[0], weight.shape[1]
    N, _, H, W = data.shape
    wp = F.pad(weight, (1, 0, 1, 0))                       # 8x8, idx m+1
    w2 = wp.reshape(O, C, 4, 2, 4, 2).permute(0, 1, 3, 5, 2, 4)
    w2 = w2.reshape(O, C * 4, 4, 4)
    xs = data.reshape(N, C, H // 2, 2, W // 2, 2).permute(0, 1, 3, 5, 2, 4)
    xs = xs.reshape(N, C * 4, H // 2, W // 2)
    if data.is_contiguous(memory_format=torch.channels_last) and \
            not data.is_contiguous():
        xs = xs.contiguous(memory_format=torch.channels_last)
        w2 = w2.contiguous(memory_format=torch.channels_last)
    # the reference pads (2, 1) on each spatial axis: low 2, high 1
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), w2)


def _s2d_eligible(data, nsp, kernel, stride, pad, dilate, num_group,
                  cudnn_off):
    """The reference's eligibility for the space-to-depth stem (data in
    NC+HW)."""
    return (nsp == 2 and tuple(kernel) == (7, 7) and stride == (2, 2)
            and pad == (3, 3) and dilate == (1, 1) and int(num_group) == 1
            and data.shape[1] <= 4 and data.shape[2] % 2 == 0
            and data.shape[3] % 2 == 0 and not cudnn_off and _s2d_enabled())


@register("Convolution", aliases=["convolution", "Convolution_v1"])
def convolution(data, weight, bias=None, *, kernel, num_filter, stride=None,
                dilate=None, pad=None, num_group=1, no_bias=False,
                cudnn_tune=None, cudnn_off=False, workspace=1024, layout=None,
                _kernel_layout=None):
    """N-d convolution (ref: convolution.cc). Data NC+spatial (or
    N+spatial+C with layout "NWC"/"NHWC"/"NDHWC"), weight OI+spatial
    (or spatial+IO with ``_kernel_layout="HWIO"``). Under
    ``MXNET_CONV_S2D`` the 7x7/s2/p3 stem over at most four channels runs
    as :func:`_stem_s2d_conv`, in either layout. Inside a hybridized call
    with ``MXNET_LAYOUT_OPT`` on, a 2-D ungrouped NCHW convolution of
    tensor-core data runs channels-last and its bias may be elided
    (symbol/layout_opt.py)."""
    nsp = len(tuple(kernel))
    if nsp not in _CONV:
        raise ValueError("conv supports 1-3 spatial dims")
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    dilate = _tup(dilate, nsp) if dilate else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    nhwc = _channels_last(layout)
    if _kernel_layout == "HWIO":
        weight = weight.movedim(-1, 0).movedim(-1, 1)
    has_bias = not no_bias and bias is not None
    plan = _layout_opt.active()
    step = None if plan is None else \
        plan.conv(nsp, layout, num_group, has_bias, data.dtype)
    x = _to_nc(data, nhwc)
    if step is not None:
        plan.conv_weight(weight, step)
    if step is not None and step.nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
        weight = weight.contiguous(memory_format=torch.channels_last)
    if _s2d_eligible(x, nsp, kernel, stride, pad, dilate, num_group,
                     cudnn_off):
        out = _stem_s2d_conv(x, weight)
    else:
        out = _CONV[nsp](x, weight, None, stride, pad, dilate,
                         int(num_group))
    if has_bias:
        shape = (1, -1) + (1,) * nsp
        if step is None:
            out = out + bias.reshape(shape)
        else:
            out = _layout_opt.add_bias(out, bias, step,
                                       (1, out.shape[1]) + (1,) * nsp)
    out = _from_nc(out, nhwc)
    if step is not None:
        plan.produced(step, out)
    return out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def deconvolution(data, weight, bias=None, *, kernel, num_filter, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_group=1, no_bias=True, cudnn_tune=None, cudnn_off=False,
                  workspace=512, layout=None):
    """Transposed convolution (ref: deconvolution.cc), NC+spatial, weight
    (in, out/g, k...), ``adj`` the extra high-side output rows. The
    reference computes it as an input-dilated convolution with the kernel
    flipped and its group blocks moved onto the output axis; torch's
    transposed convolution takes MXNet's weight layout as it is.
    ``target_shape`` is accepted and ignored, as in the reference."""
    nsp = len(tuple(kernel))
    if nsp not in _CONV_T:
        raise ValueError("deconvolution supports 1-3 spatial dims")
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    dilate = _tup(dilate, nsp) if dilate else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    adj = _tup(adj, nsp) if adj else (0,) * nsp
    out = _CONV_T[nsp](data, weight, None, stride, pad, adj, int(num_group),
                       dilate)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return out


# -- Pooling ----------------------------------------------------------------
@register("Pooling", aliases=["pooling", "Pooling_v1"])
def pooling(data, *, kernel=(), pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None):
    """Spatial pooling (ref: pooling.cc): max, avg or sum. The input is
    padded as the reference's ``reduce_window`` pads it (-inf for max,
    0 otherwise; ``pooling_convention="full"`` adds high-side padding so
    every element is covered), then pooled without padding.
    ``count_include_pad=False`` divides each average by the number of
    real elements in its window."""
    nsp = data.dim() - 2
    nhwc = _channels_last(layout)
    x = _to_nc(data, nhwc)
    sp = tuple(range(2, 2 + nsp))
    if global_pool:
        if pool_type == "max":
            out = x.amax(dim=sp, keepdim=True)
        elif pool_type == "avg":
            out = x.mean(dim=sp, keepdim=True)
        elif pool_type == "sum":
            out = x.sum(dim=sp, keepdim=True)
        else:
            raise ValueError(pool_type)
        return _from_nc(out, nhwc)
    k = _tup(kernel, nsp)
    s = _tup(stride, nsp) if stride else k
    p = _tup(pad, nsp) if pad else (0,) * nsp
    pads = []
    for i in range(nsp):
        hi = p[i]
        if pooling_convention == "full":
            rem = (x.shape[2 + i] + 2 * p[i] - k[i]) % s[i]
            hi += (s[i] - rem) % s[i] if rem else 0
        pads.append((p[i], hi))
    # F.pad takes (lo, hi) pairs from the last dim backwards
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    if pool_type == "max":
        fill = -math.inf if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        out = _max_pool(F.pad(x, flat, value=fill), k, s)
        return _from_nc(out, nhwc)
    if pool_type not in ("avg", "sum"):
        raise ValueError(pool_type)
    summed = _sum_pool(F.pad(x, flat), k, s)
    if pool_type == "sum":
        return _from_nc(summed, nhwc)
    if count_include_pad:
        out = summed / math.prod(k)
    else:
        ones = F.pad(torch.ones_like(x[:1, :1]), flat)
        out = summed / _sum_pool(ones, k, s)
    return _from_nc(out, nhwc)


def _max_pool(x, k, s):
    if len(k) == 1:
        return F.max_pool1d(x, k, s)
    return (F.max_pool2d if len(k) == 2 else F.max_pool3d)(x, k, s)


def _sum_pool(x, k, s):
    """Window sums (no padding): avg pooling with divisor 1."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + k, (1,) + s,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, k, s, divisor_override=1)


# -- BatchNorm --------------------------------------------------------------
class _BNTrainFn(torch.autograd.Function):
    """Training-mode batch norm with the reference's hand-derived
    backward (``_bn_train_fn``): statistics in one pass shifted by the
    moving mean, in f32 (f64 for f64 data, as MXNet's), ``out = x *
    scale + shift`` with the per-channel vectors rounded to x's dtype
    first, and ``dx = a·dy + b_c·x + c_c``. With ``across``, the reducer of
    a sharded step whose batch is split over several devices
    (:func:`_batch_reducer`, held for the backward, which may run on
    another thread), the statistics are the whole batch's: the sums of
    the shifted data, of its squares and the counts are summed over the
    step's batch axes, and so are dy's and dy*x's sums in the backward
    for dx; dgamma and dbeta stay this replica's (the step sums the
    gradients)."""

    @staticmethod
    def forward(ctx, x, g, b, shift, ax, eps, across):
        red = tuple(i for i in range(x.dim()) if i != ax)
        bc = _bcast(ax, x.dim())
        acc = torch.promote_types(x.dtype, torch.float32)
        sh = shift.to(acc)
        d = x.to(acc) - bc(sh)
        n = x.numel() // max(x.shape[ax], 1)
        s1 = d.sum(dim=red)
        s2 = (d * d).sum(dim=red)
        if across is not None:
            c = s1.numel()
            tot = across(torch.cat([s1, s2, d.new_full((1,), float(n))]))
            s1, s2, n = tot[:c], tot[c:2 * c], tot[2 * c]
        dmean = s1 / n
        var = torch.clamp_min(s2 / n - dmean * dmean, 0.0)
        mean = dmean + sh
        inv = torch.rsqrt(var + eps)
        scale = inv * g.to(acc)
        out = _bn_apply(x, bc(scale), bc(b.to(acc) - mean * scale))
        ctx.save_for_backward(x, g, mean, inv)
        ctx.ax, ctx.n, ctx.across = ax, n, across
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g, mean, inv = ctx.saved_tensors
        red = tuple(i for i in range(x.dim()) if i != ctx.ax)
        bc = _bcast(ctx.ax, x.dim())
        n = ctx.n
        acc = torch.promote_types(x.dtype, torch.float32)
        dyf = dy.to(acc)
        dyf_sum = dyf.sum(dim=red)
        dyx_sum = (dyf * x.to(acc)).sum(dim=red)
        # sum(dy * (x - mean)) = sum(dy*x) - mean * sum(dy)
        dy_xmu = dyx_sum - mean * dyf_sum
        dgamma = dy_xmu * inv
        all_dy, all_dy_xmu = dyf_sum, dy_xmu
        if ctx.across is not None:
            c = dyf_sum.numel()
            tot = ctx.across(torch.cat([dyf_sum, dyx_sum]))
            all_dy = tot[:c]
            all_dy_xmu = tot[c:] - mean * all_dy
        a = g.to(acc) * inv
        b_c = -a * inv * inv * all_dy_xmu / n
        c_c = -a * all_dy / n - b_c * mean
        dx = (dy * bc(a).to(dy.dtype) + x * bc(b_c).to(x.dtype)
              + bc(c_c).to(x.dtype)).to(x.dtype)
        return (dx, dgamma.to(g.dtype), dyf_sum.to(g.dtype), None, None,
                None, None)


# Where a training BatchNorm finds its cross-device reducer: a function
# that returns None, or ``across(t)``, the sum of ``t`` over the devices of
# the sharded step's batch that runs on this thread. The sharded step's
# runtime registers it (``parallel/_spmd.py``,
# :func:`set_batch_reducer_source`); this layer knows nothing of it.
_BATCH_REDUCER_SOURCE = None


def set_batch_reducer_source(source):
    """Register ``source() -> None or across`` for :func:`_batch_reducer`."""
    global _BATCH_REDUCER_SOURCE
    _BATCH_REDUCER_SOURCE = source


def _batch_reducer():
    """The reducer of the sharded step's batch on this thread, when that
    batch is split over more than one device, else None."""
    src = _BATCH_REDUCER_SOURCE
    return None if src is None else src()


def _bn_apply(x, scale, shift):
    """x * scale + shift with the per-channel vectors rounded to x's
    dtype first."""
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def _bcast(ax, ndim):
    def bc(v):
        shape = [1] * ndim
        shape[ax] = v.shape[0]
        return v.reshape(shape)
    return bc


@register("BatchNorm", aliases=["batch_norm", "BatchNorm_v1"],
          mutate_aux={1: 3, 2: 4},
          needs_train_flag=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *,
               eps=1e-3, momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """Batch normalization (ref: batch_norm.cc). Returns (out,
    new_moving_mean, new_moving_var); ``invoke`` writes the moving
    statistics back into their inputs (FMutateInputs). Training inside a
    sharded step whose batch is split over several devices, the
    statistics are the whole batch's (:class:`_BNTrainFn` with the
    step's reducer), as BatchNorm inside the reference's sharded program
    sees them. The inference
    form rounds its output to the data's dtype, where the reference
    promotes a bf16 input to f32 (ROADMAP.md queue 3)."""
    ax = int(axis) % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _train and not use_global_stats:
        out, mean, var = _BNTrainFn.apply(data, g, beta, moving_mean.detach(),
                                          ax, float(eps), _batch_reducer())
        new_mean = moving_mean * momentum \
            + mean.to(moving_mean.dtype) * (1 - momentum)
        new_var = moving_var * momentum \
            + var.to(moving_var.dtype) * (1 - momentum)
        return out, new_mean, new_var
    bc = _bcast(ax, data.dim())
    inv = torch.rsqrt(moving_var + eps)
    out = (data - bc(moving_mean)) * bc(inv * g) + bc(beta)
    return out.to(data.dtype), moving_mean, moving_var



# -- InstanceNorm, GroupNorm ------------------------------------------------
def _group_norm(data, gamma, beta, groups, eps):
    """Normalization over each sample's channel groups, the statistics in
    f32 for 16-bit data (torch's ``group_norm``, on f32 then); the
    output in the promoted dtype of data, gamma and beta, as the
    reference's affine step gives it."""
    low = data.dtype in (torch.float16, torch.bfloat16)
    x = data.float() if low else data
    out = F.group_norm(x, int(groups), gamma.to(x.dtype), beta.to(x.dtype),
                       float(eps))
    return out.to(torch.promote_types(
        torch.promote_types(data.dtype, gamma.dtype), beta.dtype))


@register("InstanceNorm")
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """Normalization over each sample's and channel's spatial positions
    (ref: instance_norm.cc), gamma and beta per channel (axis 1)."""
    return _group_norm(data, gamma, beta, data.shape[1], eps)


@register("GroupNorm")
def group_norm(data, gamma, beta, *, num_groups=1, eps=1e-5):
    """Normalization over ``num_groups`` groups of axis 1's channels and
    the spatial positions (ref: group_norm.cc), gamma and beta per
    channel."""
    return _group_norm(data, gamma, beta, num_groups, eps)


# -- softmin, softmax_cross_entropy -----------------------------------------
@register("softmin")
def softmin(data, *, axis=-1, temperature=None, dtype=None):
    """softmax(-data / temperature) over ``axis`` (MXNet 1.x's
    temperature; the reference ignores it)."""
    data = float_in(data)
    x = -data if temperature in (None, 1.0) else -data / temperature
    out = torch.softmax(x, dim=int(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed cross entropy of softmax(data) (N, C) at the integer
    labels (N,), as a (1,) array (ref: softmax_cross_entropy.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    nll = -torch.gather(logp, -1, label.long().unsqueeze(-1))
    return nll.sum().reshape(1)


# -- the output ops: a forward and a loss gradient of their own -------------
def _label_grad(ctx, label):
    """The label's gradient: zero, as the reference's custom VJPs give
    it."""
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax forward; the backward ignores the head gradient and gives
    (p - onehot(label)) * grad_scale (ref: softmax_output.cc and the
    reference's ``_softmax_output_fn``): labels equal to ``ignore_label``
    give 0 with ``use_ignore``; ``normalization`` 'batch' divides by the
    batch size, 'valid' (with ``use_ignore``) by the labels kept."""

    @staticmethod
    def forward(ctx, data, label, ax, grad_scale, use_ignore, ignore_label,
                normalization):
        prob = torch.softmax(data, dim=ax)
        ctx.save_for_backward(prob, label)
        ctx.cfg = (ax, grad_scale, use_ignore, ignore_label, normalization)
        return prob

    @staticmethod
    def backward(ctx, _g):
        prob, label = ctx.saved_tensors
        ax, grad_scale, use_ignore, ignore_label, normalization = ctx.cfg
        lab = label.to(torch.int64).unsqueeze(ax)
        shape = [1] * prob.dim()
        shape[ax] = prob.shape[ax]
        classes = torch.arange(prob.shape[ax], device=prob.device)
        grad = prob - (classes.reshape(shape) == lab).to(prob.dtype)
        if use_ignore:
            keep = (lab != int(ignore_label)).to(prob.dtype)
            grad = grad * keep
        if normalization == "batch":
            grad = grad / prob.shape[0]
        elif normalization == "valid" and use_ignore:
            grad = grad / torch.clamp_min(keep.sum(), 1.0)
        return (grad * grad_scale, _label_grad(ctx, label), None, None, None,
                None, None)


@register("SoftmaxOutput", aliases=["Softmax"])
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax with the cross-entropy gradient of its own (ref:
    softmax_output.cc): over the last axis, or axis 1 with
    ``multi_output``."""
    return _SoftmaxOutputFn.apply(float_in(data), label, 1 if multi_output else -1,
                                  float(grad_scale), bool(use_ignore),
                                  float(ignore_label), normalization)


class _RegressionFn(torch.autograd.Function):
    """The regression outputs (ref: regression_output.cc): the forward
    is the identity (linear, mae) or the sigmoid (logistic); the backward
    ignores the head gradient and gives (pred - label) * grad_scale, or
    its sign for mae."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        pred = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(pred, label)
        ctx.cfg = (kind, grad_scale)
        return pred

    @staticmethod
    def backward(ctx, _g):
        pred, label = ctx.saved_tensors
        kind, grad_scale = ctx.cfg
        diff = pred - label.reshape(pred.shape)
        grad = torch.sign(diff) if kind == "mae" else diff
        return grad * grad_scale, _label_grad(ctx, label), None, None


@register("LinearRegressionOutput")
def linear_regression_output(data, label, *, grad_scale=1.0):
    return _RegressionFn.apply(data, label, "linear", float(grad_scale))


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, *, grad_scale=1.0):
    return _RegressionFn.apply(data, label, "logistic", float(grad_scale))


@register("MAERegressionOutput")
def mae_regression_output(data, label, *, grad_scale=1.0):
    return _RegressionFn.apply(data, label, "mae", float(grad_scale))


# -- CTC loss ---------------------------------------------------------------
# log(0) as the recursion writes it: an impossible alignment costs a large
# finite loss, never inf
_CTC_LOG_EPS = -1e5


def _ctc_recursion(logits, logit_pad, labels, label_pad, blank_id):
    """Per-sequence CTC loss (N,) in f32: logits (N, T, C), labels (N, L)
    with their paddings (1.0 at a padded step or label). The recursion
    over blank (phi) and label (emit) states in log space, with
    ``_CTC_LOG_EPS`` for log(0), step for step as the reference's
    ``optax.ctc_loss`` runs it (so an infeasible alignment gives the same
    large finite loss), differentiated by autograd."""
    N, T, C = logits.shape
    L = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = L - label_pad.sum(dim=1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    phi_lp = logprobs[:, :, blank_id].t().unsqueeze(-1)           # (T, N, 1)
    # a label outside [0, C) emits with log probability 0, as the
    # reference's one-hot product gives it
    inside = ((labels >= 0) & (labels < C)).float()
    emit_lp = torch.gather(logprobs, 2, labels.clamp(0, C - 1).unsqueeze(1)
                           .expand(N, T, L)) * inside.unsqueeze(1)
    emit_lp = emit_lp.transpose(0, 1)                             # (T, N, L)
    # a padded step keeps the states (the reference's pad * prev + (1 -
    # pad) * next, exactly, as a select)
    pads = (logit_pad.t() > 0).unsqueeze(-1)                       # (T, N, 1)
    dev = logits.device
    phi = torch.full((N, L + 1), _CTC_LOG_EPS, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((N, L), _CTC_LOG_EPS, device=dev)
    eps_repeat = _CTC_LOG_EPS * repeat
    eps_other = _CTC_LOG_EPS * (1.0 - repeat)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=-1)

    for t in range(T):
        le, lp, pad = emit_lp[t], phi_lp[t], pads[t]
        prev_phi = add_phi(phi, emit + eps_repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + le, emit + le)
        next_phi = add_phi(prev_phi + lp, emit + lp + eps_other)
        emit = torch.where(pad, emit, next_emit)
        phi = torch.where(pad, phi, next_phi)
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, labellens.unsqueeze(1)).squeeze(1)


@register("CTCLoss", aliases=["ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"])
def ctc_loss_op(data, label, data_lengths=None, label_lengths=None, *,
                use_data_lengths=False, use_label_lengths=False,
                blank_label="first"):
    """Connectionist temporal classification loss (ref:
    src/operator/nn/ctc_loss.cc): data (T, N, C) unnormalized
    activations, label (N, L) padded class ids; returns the loss per
    sequence (N,). Without label lengths a label counts where it is not
    padding: -1, and 0 too with ``blank_label='first'`` (blank 0; 'last'
    makes C - 1 the blank)."""
    if blank_label not in ("first", "last"):
        raise ValueError("blank_label must be 'first' or 'last', got %r"
                         % (blank_label,))
    T, N, C = data.shape
    dev = data.device
    logits = data.transpose(0, 1).float()
    steps = torch.arange(T, device=dev).unsqueeze(0)
    if use_data_lengths and data_lengths is not None:
        dlen = data_lengths.to(torch.int64).unsqueeze(1)
    else:
        dlen = torch.full((N, 1), T, dtype=torch.int64, device=dev)
    logit_pad = (steps >= dlen).float()
    lab = label.to(torch.int64)
    if use_label_lengths and label_lengths is not None:
        llen = label_lengths.to(torch.int64)
    else:
        valid = (lab != -1) & (lab != 0) if blank_label == "first" \
            else lab != -1
        llen = valid.sum(dim=1)
    positions = torch.arange(lab.shape[1], device=dev).unsqueeze(0)
    label_pad = (positions >= llen.unsqueeze(1)).float()
    blank_id = 0 if blank_label == "first" else C - 1
    lab = torch.where(label_pad > 0, torch.full_like(lab, blank_id), lab)
    return _ctc_recursion(logits, logit_pad, lab, label_pad, blank_id)
