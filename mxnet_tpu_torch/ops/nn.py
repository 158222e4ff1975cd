"""Neural-network operators, the subset the serving and training slices
run (counterpart of ``mxnet_tpu/ops/nn.py``; ref: src/operator/nn/).

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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import torch_dtype
from ..context import context_of
from . import register
from . import cuda_dropout
from . import cuda_norm


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


@register("Convolution", aliases=["convolution"])
def convolution(data, weight, bias=None, *, kernel, num_filter, stride=None,
                dilate=None, pad=None, num_group=1, no_bias=False,
                cudnn_tune=None, cudnn_off=False, workspace=1024, layout=None,
                _kernel_layout=None):
    """N-d convolution (ref: convolution.cc). Data NC+spatial (or
    N+spatial+C with layout "NWC"/"NHWC"/"NDHWC"), weight OI+spatial
    (or spatial+IO with ``_kernel_layout="HWIO"``). The reference's
    space-to-depth rewrite of the 7x7/s2 stem is a choice for the TPU's
    matrix unit with the same math; the port leaves the algorithm to
    cuDNN (see config.py)."""
    nsp = len(tuple(kernel))
    if nsp not in _CONV:
        raise ValueError("conv supports 1-3 spatial dims")
    stride = _tup(stride, nsp) if stride else (1,) * nsp
    dilate = _tup(dilate, nsp) if dilate else (1,) * nsp
    pad = _tup(pad, nsp) if pad else (0,) * nsp
    nhwc = _channels_last(layout)
    if _kernel_layout == "HWIO":
        weight = weight.movedim(-1, 0).movedim(-1, 1)
    out = _CONV[nsp](_to_nc(data, nhwc), weight, None, stride, pad, dilate,
                     int(num_group))
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return _from_nc(out, nhwc)


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
@register("Pooling", aliases=["pooling"])
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
    first, and ``dx = a·dy + b_c·x + c_c``."""

    @staticmethod
    def forward(ctx, x, g, b, shift, ax, eps):
        red = tuple(i for i in range(x.dim()) if i != ax)
        bc = _bcast(ax, x.dim())
        acc = torch.promote_types(x.dtype, torch.float32)
        sh = shift.to(acc)
        d = x.to(acc) - bc(sh)
        n = x.numel() // max(x.shape[ax], 1)
        s1 = d.sum(dim=red)
        s2 = (d * d).sum(dim=red)
        dmean = s1 / n
        var = torch.clamp_min(s2 / n - dmean * dmean, 0.0)
        mean = dmean + sh
        inv = torch.rsqrt(var + eps)
        scale = inv * g.to(acc)
        out = _bn_apply(x, bc(scale), bc(b.to(acc) - mean * scale))
        ctx.save_for_backward(x, g, mean, inv)
        ctx.ax, ctx.n = ax, n
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
        a = g.to(acc) * inv
        b_c = -a * inv * inv * dy_xmu / n
        c_c = -a * dyf_sum / n - b_c * mean
        dx = (dy * bc(a).to(dy.dtype) + x * bc(b_c).to(x.dtype)
              + bc(c_c).to(x.dtype)).to(x.dtype)
        return (dx, dgamma.to(g.dtype), dyf_sum.to(g.dtype), None, None,
                None)


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


@register("BatchNorm", aliases=["batch_norm"], mutate_aux={1: 3, 2: 4},
          needs_train_flag=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *,
               eps=1e-3, momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    """Batch normalization (ref: batch_norm.cc). Returns (out,
    new_moving_mean, new_moving_var); ``invoke`` writes the moving
    statistics back into their inputs (FMutateInputs). The inference
    form rounds its output to the data's dtype, where the reference
    promotes a bf16 input to f32 (ROADMAP.md queue 3)."""
    ax = int(axis) % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _train and not use_global_stats:
        out, mean, var = _BNTrainFn.apply(data, g, beta, moving_mean.detach(),
                                          ax, float(eps))
        new_mean = moving_mean * momentum \
            + mean.to(moving_mean.dtype) * (1 - momentum)
        new_var = moving_var * momentum \
            + var.to(moving_var.dtype) * (1 - momentum)
        return out, new_mean, new_var
    bc = _bcast(ax, data.dim())
    inv = torch.rsqrt(moving_var + eps)
    out = (data - bc(moving_mean)) * bc(inv * g) + bc(beta)
    return out.to(data.dtype), moving_mean, moving_var

