"""Neural-network operators, the subset the serving and training slices
run (counterpart of ``mxnet_tpu/ops/nn.py``; ref: src/operator/nn/).

``FullyConnected`` is a ``torch.matmul``, as the reference leaves its
matmul to XLA outside any kernel. ``LayerNorm`` over the last axis goes
to :mod:`.cuda_norm` (the hand-written kernels, forward and backward,
for a CUDA tensor, their plain versions for a CPU one); another axis, or
``output_mean_var``, runs the composition with the same formulas (the
reference's ``_ln_fused``). Train-mode ``Dropout`` with a full-shape
mask goes to :mod:`.cuda_dropout`; with ``axes`` it runs the reference's
composition, its mask drawn from the context's generator.
"""
from __future__ import annotations

import torch

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
    """The activations the slices run: tanh (BERT's pooler) and relu
    (the MLP)."""
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "relu":
        return torch.relu(data)
    raise ValueError("unknown act_type %r" % act_type)


@register("softmax")
def softmax(data, *, axis=-1, temperature=None, dtype=None):
    x = data if temperature in (None, 1.0) else data / temperature
    out = torch.softmax(x, dim=int(axis))
    return out.to(torch_dtype(dtype)) if dtype else out


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None, dtype=None,
                use_length=False):
    x = data if temperature in (None, 1.0) else data / temperature
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
