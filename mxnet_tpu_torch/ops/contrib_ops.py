"""Contrib operators of the BERT path: packed-QKV self-attention and
the fused Dense epilogues (counterpart of
``mxnet_tpu/ops/contrib_ops.py``; ref:
src/operator/contrib/transformer.cc).

Packed QKV layout (matches the reference): (seq_len, batch,
num_heads * 3 * head_dim), per-head interleaved [q | k | v].

The dispatch mirrors the reference's: ``_contrib_sdp_selfatt`` runs the
kernels of :mod:`.cuda_attention` where they are available (bf16/f16, L
up to 1024) and the unfused composition otherwise, f32 included,
because the kernels compute in bf16. In train mode with dropout the
kernels draw their mask from ``batch * head blocks`` int32 seeds taken
from the context's generator (the composition draws a Bernoulli mask
from it). The epilogues run the kernels of :mod:`.cuda_epilogue` unless
the dtypes differ (the reference then runs the composition in the
promoted dtype).
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..context import context_of
from . import register
from . import cuda_attention
from . import cuda_epilogue


def _split_qkv(qkv, heads):
    """(L, N, heads*3*hd) -> q, k, v as (N*heads, L, hd), and hd."""
    L, N, three_hd = qkv.shape
    hd = three_hd // (3 * heads)
    x = qkv.reshape(L, N, heads, 3, hd)

    def pick(i):
        return x[:, :, :, i, :].permute(1, 2, 0, 3).reshape(N * heads, L, hd)
    return pick(0), pick(1), pick(2), hd


@register("_contrib_interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads):
    """scores = (Q/√d)·Kᵀ over interleaved packed QKV
    (ref: transformer.cc :: interleaved_matmul_selfatt_qk)."""
    q, k, _, hd = _split_qkv(queries_keys_values, int(heads))
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=q.dtype,
                                          device=q.device))
    return torch.matmul(q * scale, k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads):
    """out = att·V, re-packed to (L, N, heads*hd)."""
    _, _, v, hd = _split_qkv(queries_keys_values, int(heads))
    heads = int(heads)
    N = v.shape[0] // heads
    out = torch.matmul(attention, v)            # (N*heads, Lq, hd)
    Lq = out.shape[1]
    return out.reshape(N, heads, Lq, hd).permute(2, 0, 1, 3).reshape(
        Lq, N, heads * hd)


@register("_contrib_sdp_selfatt", needs_rng=True, needs_train_flag=True)
def sdp_selfatt(queries_keys_values, *, heads, dropout=0.0, _train=False):
    """Fused scaled-dot-product self-attention over packed QKV: scores,
    softmax, (train-mode) dropout and context in one kernel that reads
    and writes the packed layout; the backward kernels recompute the
    probabilities and the mask from the same seeds."""
    qkv = queries_keys_values
    L, N, _ = qkv.shape
    p = float(dropout) if _train else 0.0
    heads_i = int(heads)
    ctx = context_of(qkv.device)
    if cuda_attention.selfatt_available(L, heads_i, N, qkv.dtype):
        plan = cuda_attention.selfatt_plan(L, heads_i, N)
        seeds = _random.seeds(plan["n_blocks"], ctx) if p > 0.0 else None
        return cuda_attention.selfatt_fn(qkv, heads_i, p, seeds,
                                         plan["bbh"])
    scores = interleaved_matmul_selfatt_qk(qkv, heads=heads_i)
    att = torch.softmax(scores, dim=-1)
    if p > 0.0:
        keep = torch.bernoulli(torch.full(att.shape, 1.0 - p,
                                          device=att.device),
                               generator=_random.generator(ctx))
        att = torch.where(keep.bool(), att / (1.0 - p), 0.0).to(att.dtype)
    return interleaved_matmul_selfatt_valatt(qkv, att, heads=heads_i)


@register("_contrib_bias_gelu")
def bias_gelu(data, bias):
    """GeLU(data + bias), exact erf form — the Dense→GeLU FFN epilogue."""
    if cuda_epilogue.bias_gelu_available(tuple(data.shape), data.dtype,
                                         bias.dtype):
        C = data.shape[-1]
        out = cuda_epilogue.bias_gelu_fn(data.reshape(-1, C).contiguous(),
                                         bias.contiguous())
        return out.reshape(data.shape)
    return cuda_epilogue.gelu_erf(data + bias)


@register("_contrib_bias_add_residual")
def bias_add_residual(data, bias, residual):
    """data + bias + residual in one sweep — the projection/FFN output
    epilogue feeding the post-attention LayerNorm."""
    if data.shape == residual.shape and cuda_epilogue.bias_residual_available(
            tuple(data.shape), data.dtype, bias.dtype, residual.dtype):
        C = data.shape[-1]
        out = cuda_epilogue.bias_residual_fn(
            data.reshape(-1, C).contiguous(), bias.contiguous(),
            residual.reshape(-1, C).contiguous())
        return out.reshape(data.shape)
    return data + bias + residual
