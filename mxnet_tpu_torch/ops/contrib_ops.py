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
promoted dtype). The LM-head cross entropies (``_contrib_fused_lm_head_ce``,
``_contrib_chunked_lm_head_ce``) are XLA in the reference, and products
and elementwise torch code here.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from ..config import get as _cfg
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
    scale = 1.0 / torch.sqrt(torch.full((), float(hd), dtype=q.dtype,
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


@register("_contrib_interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(queries, keys_values, *, heads):
    """Encoder-decoder scores (Q/√d)·Kᵀ: queries (Lq, N, heads*hd), keys
    and values interleaved per head (Lk, N, heads*2*hd) -> (N*heads, Lq,
    Lk) (ref: transformer.cc :: interleaved_matmul_encdec_qk)."""
    Lq, N, hdim = queries.shape
    heads = int(heads)
    hd = hdim // heads
    q = queries.reshape(Lq, N, heads, hd).permute(1, 2, 0, 3).reshape(
        N * heads, Lq, hd)
    Lk = keys_values.shape[0]
    k = keys_values.reshape(Lk, N, heads, 2, hd)[:, :, :, 0, :].permute(
        1, 2, 0, 3).reshape(N * heads, Lk, hd)
    scale = 1.0 / torch.sqrt(torch.full((), float(hd), dtype=q.dtype,
                                        device=q.device))
    return torch.matmul(q * scale, k.transpose(-1, -2))


@register("_contrib_interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(keys_values, attention, *, heads):
    """att·V over the interleaved keys and values, re-packed to (Lq, N,
    heads*hd) (ref: transformer.cc :: interleaved_matmul_encdec_valatt)."""
    Lk, N, two_hdim = keys_values.shape
    heads = int(heads)
    hd = two_hdim // (2 * heads)
    v = keys_values.reshape(Lk, N, heads, 2, hd)[:, :, :, 1, :].permute(
        1, 2, 0, 3).reshape(N * heads, Lk, hd)
    out = torch.matmul(attention, v)
    Lq = out.shape[1]
    return out.reshape(N, heads, Lq, hd).permute(2, 0, 1, 3).reshape(
        Lq, N, heads * hd)


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(data.shape[-1])."""
    return data / torch.sqrt(torch.full((), float(data.shape[-1]),
                                        dtype=data.dtype, device=data.device))


@register("_contrib_arange_like")
def arange_like(data, *, start=0.0, step=1.0, repeat=1, axis=None):
    """start + step * i in data's dtype, over data's shape, or along
    ``axis`` alone. ``repeat`` is taken and ignored, as in the
    reference."""
    n = data.numel() if axis is None else data.shape[int(axis)]
    out = torch.arange(n, dtype=data.dtype, device=data.device) * step \
        + start
    return out.reshape(data.shape) if axis is None else out


@register("_contrib_boolean_mask")
def boolean_mask(data, index, *, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    Its shape depends on the data, so it runs eagerly only: the card
    tells the host how many slices there are. Inside a hybridized
    block's call it raises, as the reference's does under jit."""
    from .. import cached_op
    if cached_op.in_call():
        raise MXNetError(
            "_contrib_boolean_mask has a data-dependent output shape and "
            "cannot run inside a hybridized (captured) call; call it "
            "eagerly, or use SequenceMask/where")
    idx = torch.nonzero(index.to(torch.bool).reshape(-1))[:, 0]
    return data.index_select(int(axis), idx)


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


# ---------------------------------------------------------------------------
# LM-head cross entropies: the decoder product and the softmax cross
# entropy in one op that keeps only the per-position LSE; the backward
# recomputes the logits (ref: contrib_ops.py :: _lm_head_ce and
# _make_chunked_ce). The reference computes every product with f32
# output (preferred_element_type) from operands promoted as JAX promotes
# them, so bf16 hidden states against f32 weights take an f32 product.
# ---------------------------------------------------------------------------
_NEG_BIG = -1.0e30    # pad bias: exp(_NEG_BIG - lse) underflows to 0 in f32


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result, the operands promoted to their common
    dtype first. Low-precision operands on the card take cuBLAS's f32
    output (no rounding to the operands' dtype); on the CPU they are
    widened, which is exact, so only the sum order separates the two."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if dt == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _check_labels(opname, hidden, labels):
    lead = tuple(hidden.shape[:-1])
    if tuple(labels.shape) != lead:
        # a transposed labels array of the same size would flatten into
        # a silently wrong loss
        raise ValueError("%s: labels shape %s must equal hidden's leading "
                         "shape %s" % (opname, tuple(labels.shape), lead))
    return lead


class _LMHeadCE(torch.autograd.Function):
    """The full-vocab head: (T, V) f32 logits in the forward, recomputed
    in the backward; labels as ``take_along_axis`` reads them (negative
    ids count from the end, others out of range give NaN) and the
    backward's one-hot as ``jax.nn.one_hot`` builds it (zero out of
    range)."""

    @staticmethod
    def forward(ctx, h2, w, b, labels):
        z = _f32_product(h2, w.t()) + b.float()
        m = z.amax(dim=1)
        lse = m + torch.log(torch.exp(z - m[:, None]).sum(dim=1))
        V = w.shape[0]
        idx = torch.where(labels < 0, labels + V, labels)
        ok = (idx >= 0) & (idx < V)
        picked = z.gather(1, idx.clamp(0, V - 1)[:, None])[:, 0]
        picked = torch.where(ok, picked, torch.nan)
        ctx.save_for_backward(h2, w, b, labels, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, dy):
        h2, w, b, labels, lse = ctx.saved_tensors
        V = w.shape[0]
        p = torch.exp(_f32_product(h2, w.t()) + b.float() - lse[:, None])
        _sub_one_hot(p, labels, V)
        # dz drops to the activation dtype before the products
        dz = (p * dy[:, None]).to(h2.dtype)
        dh = _f32_product(dz, w).to(h2.dtype)
        dw = _f32_product(dz.t(), h2).to(w.dtype)
        db = dz.float().sum(dim=0).to(b.dtype)
        return dh, dw, db, None


@register("_contrib_fused_lm_head_ce")
def fused_lm_head_ce(hidden, weight, bias, labels):
    """Decoder product + softmax cross entropy in one op, the logits
    recomputed in the backward. hidden (..., units); weight (vocab,
    units); bias (vocab,); labels (...) ids of hidden's leading shape.
    Returns the per-position loss (...,), f32."""
    lead = _check_labels("_contrib_fused_lm_head_ce", hidden, labels)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    loss = _LMHeadCE.apply(h2, weight, bias, labels.reshape(-1).long())
    return loss.reshape(lead)


def _sub_one_hot(p, local, width):
    """p -= one_hot(local, width) in place, zero where ``local`` is out
    of [0, width), as ``jax.nn.one_hot`` builds it. A scatter of 0 or -1
    into each row: no boolean indexing, so the host never waits on the
    card."""
    hit = (local >= 0) & (local < width)
    p.scatter_add_(1, local.clamp(0, width - 1)[:, None],
                   -hit[:, None].to(p.dtype))


def _ce_chunk(w, b, ci, chunk, last):
    """Chunk ``ci`` of the vocab: its weight rows and f32 bias. The last
    chunk, if the vocab is not whole chunks, is ``last``: padded to
    ``chunk`` rows with zero weights and _NEG_BIG bias (the reference's
    ``_ce_pad``), built once a forward by :func:`_ce_last`."""
    if last is not None and ci == w.shape[0] // chunk:
        return last
    return (w[ci * chunk:(ci + 1) * chunk],
            b[ci * chunk:(ci + 1) * chunk].float())


def _ce_last(w, b, chunk):
    """The padded last chunk, or None when the vocab is whole chunks."""
    c0 = w.shape[0] // chunk * chunk
    pad = chunk - (w.shape[0] - c0)
    if pad == chunk:
        return None
    return (torch.cat([w[c0:], w.new_zeros(pad, w.shape[1])]),
            torch.cat([b[c0:].float(), b.new_full((pad,), _NEG_BIG,
                                                  dtype=torch.float32)]))


class _ChunkedCE(torch.autograd.Function):
    """Online softmax over vocab chunks: one (T, chunk) f32 logits tile
    at a time, in the forward (max, exp-sum and the label's logit) and
    in the backward (the tile recomputed and consumed at once: dh
    accumulated in f32, dW and db per chunk). A Python loop stands in
    for the reference's two ``lax.scan``s; the padded last chunk is
    built once and kept for the backward."""

    @staticmethod
    def forward(ctx, h2, w, b, labels, chunk):
        V = w.shape[0]
        n = -(-V // chunk)
        # out-of-range ids clamp into the vocab (pick's mode='clip')
        labels = labels.clamp(0, V - 1)
        last = _ce_last(w, b, chunk)
        picked = torch.zeros(h2.shape[0], dtype=torch.float32,
                             device=h2.device)
        ms, ss = [], []
        for ci in range(n):
            wc, bc = _ce_chunk(w, b, ci, chunk, last)
            z = _f32_product(h2, wc.t()) + bc
            mc = z.amax(dim=1)
            ms.append(mc)
            ss.append(torch.exp(z - mc[:, None]).sum(dim=1))
            local = labels - ci * chunk
            inchunk = (local >= 0) & (local < chunk)
            pz = z.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
            picked = torch.where(inchunk, pz, picked)
        ms, ss = torch.stack(ms), torch.stack(ss)
        m = ms.amax(dim=0)
        lse = m + torch.log((ss * torch.exp(ms - m)).sum(dim=0))
        ctx.save_for_backward(h2, w, b, labels, lse)
        ctx.chunk, ctx.last = chunk, last
        return lse - picked

    @staticmethod
    def backward(ctx, dy):
        h2, w, b, labels, lse = ctx.saved_tensors
        chunk, last = ctx.chunk, ctx.last
        V = w.shape[0]
        dh = torch.zeros(h2.shape, dtype=torch.float32, device=h2.device)
        dw = torch.empty_like(w)
        db = torch.empty_like(b)
        for ci in range(-(-V // chunk)):
            wc, bc = _ce_chunk(w, b, ci, chunk, last)
            p = torch.exp(_f32_product(h2, wc.t()) + bc - lse[:, None])
            _sub_one_hot(p, labels - ci * chunk, chunk)
            # the same rounding point as the full-vocab head
            dz = (p * dy[:, None]).to(h2.dtype)
            dh = dh + _f32_product(dz, wc)
            # the padded columns of dz are zero: the real rows only
            c0, c1 = ci * chunk, min(V, (ci + 1) * chunk)
            dz = dz[:, :c1 - c0]
            dw[c0:c1] = _f32_product(dz.t(), h2).to(w.dtype)
            db[c0:c1] = dz.float().sum(dim=0).to(b.dtype)
        return dh.to(h2.dtype), dw, db, None, None


def ce_chunk_size(chunk_size, vocab) -> int:
    """The vocab chunk of one call: ``chunk_size``, or with 0
    ``MXNET_CHUNKED_CE_CHUNK`` (the reference's ``_tuned_ce_chunk``
    returns it untouched while ``MXNET_AUTOTUNE`` is off), at most the
    vocab."""
    chunk = int(chunk_size)
    if chunk <= 0:
        if _cfg("MXNET_AUTOTUNE") != "off":
            raise NotImplementedError(
                "MXNET_AUTOTUNE=%r: the tuned LM-head chunk is not ported "
                "yet (ROADMAP.md queue 1, item 15)" % _cfg("MXNET_AUTOTUNE"))
        chunk = int(_cfg("MXNET_CHUNKED_CE_CHUNK"))
    return max(1, min(chunk, vocab))


@register("_contrib_chunked_lm_head_ce")
def chunked_lm_head_ce(hidden, weight, bias, labels, *, chunk_size=0):
    """Decoder product + softmax cross entropy with an online softmax
    over vocab chunks, so the (positions, vocab) logits never exist
    whole; the backward reuses the forward's per-position LSE.
    Out-of-range ids clamp into the vocab. chunk_size 0 reads
    ``MXNET_CHUNKED_CE_CHUNK``. Returns the per-position loss (...,),
    f32."""
    lead = _check_labels("_contrib_chunked_lm_head_ce", hidden, labels)
    chunk = ce_chunk_size(chunk_size, weight.shape[0])
    h2 = hidden.reshape(-1, hidden.shape[-1])
    loss = _ChunkedCE.apply(h2, weight, bias, labels.reshape(-1).long(),
                            chunk)
    return loss.reshape(lead)
