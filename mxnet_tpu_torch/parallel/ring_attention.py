"""Sequence-parallel attention over an ``sp`` mesh axis (counterpart of
``mxnet_tpu/parallel/ring_attention.py``).

:func:`ring_attention` keeps each device's query block and passes the
key/value blocks around the ring, one hop a step, folding each block
into running (max, denominator, numerator) statistics in f32 (the
online softmax), so after ``sp`` steps every query has seen every key.
:func:`ulysses_attention` re-shards sequence -> heads with one
all-to-all, runs :func:`local_attention` over the whole sequence on its
heads, and all-to-alls back.

Both run inside :func:`~.collectives.shard_map` (or a sharded step), on
``[B, T_local, H, D]`` blocks. The reference computes them outside any
Pallas kernel, and so does the port: plain products, no kernel.

Ring attention is one autograd Function with its own backward: the
backward recomputes each block's probabilities from the saved
log-sum-exp and sends the key/value blocks around the ring again, with
their gradient accumulators travelling beside them (one exchange a hop
for all four), so the accumulators arrive home after ``sp`` hops. The K
and V rotations are thus one exchange in a fixed order, whatever order
autograd walks the graph in on each device.
"""
from __future__ import annotations

import torch

from . import collectives as _coll

__all__ = ["ring_attention", "ulysses_attention", "local_attention"]


def _scale_of(q: torch.Tensor, scale):
    """``scale``, or the reference's default in q's dtype: sqrt(d) taken
    in f32, rounded to q's dtype, and its reciprocal taken in q's dtype
    (in f32 the exact value to within f32 rounding; in bf16 the scale
    the reference's bf16 logits see)."""
    if scale is not None:
        return float(scale)
    root = torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    return float(1.0 / root.to(q.dtype))


def local_attention(q, k, v, scale=None):
    """Plain softmax attention on local blocks (q, k, v: ``[B, T, H, D]``)."""
    tq, wrap = _coll._unwrap(q)
    tk, tv = _coll._unwrap(k)[0], _coll._unwrap(v)[0]
    sc = _scale_of(tq, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * sc
    w = torch.softmax(logits, dim=-1)
    return wrap(torch.einsum("bhqk,bkhd->bqhd", w, tv))


def _online_update(carry, logits, v_blk):
    """The streaming softmax-attention recurrence (f32)."""
    m_prev, l_prev, o_prev = carry
    m_blk = logits.amax(dim=-1)                          # [b,h,q]
    m_new = torch.maximum(m_prev, m_blk)
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(logits - m_new[..., None])             # [b,h,q,k]
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk)
    return m_new, l_new, o_new


def _block_logits(qf, kf, scale, causal, q_pos, src, t_loc):
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        k_pos = src * t_loc + torch.arange(t_loc, device=qf.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~mask[None, None], float("-inf"))
    return logits


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, m, axis_name, scale, causal):
        sp = m.axis_size(axis_name)
        my = m.axis_index(axis_name)
        b, t_loc, h, d = q.shape
        dev = q.device
        qf = q.float()
        mx = torch.full((b, h, t_loc), float("-inf"), dtype=torch.float32,
                        device=dev)
        l = torch.zeros((b, h, t_loc), dtype=torch.float32, device=dev)
        o = torch.zeros((b, h, t_loc, d), dtype=torch.float32, device=dev)
        q_pos = my * t_loc + torch.arange(t_loc, device=dev)
        kv = torch.stack([k, v])
        for i in range(sp):
            src = (my - i) % sp
            logits = _block_logits(qf, kv[0].float(), scale, causal, q_pos,
                                   src, t_loc)
            mx, l, o = _online_update((mx, l, o), logits, kv[1].float())
            # the blocks move to the next device each hop: after i hops
            # this one holds device (my - i)'s
            kv = _coll._permute(m, kv, axis_name, 1)
        out = o / torch.clamp(l, min=1e-30)[..., None]   # [b,h,q,d]
        lse = mx + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.m, ctx.axis, ctx.scale, ctx.causal = m, axis_name, scale, causal
        ctx.seq = m.seq
        return out.permute(0, 2, 1, 3).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        m, axis_name, scale, causal = ctx.m, ctx.axis, ctx.scale, ctx.causal
        sp = m.axis_size(axis_name)
        my = m.axis_index(axis_name)
        t_loc = q.shape[1]
        qf = q.float()
        do = dout.float().permute(0, 2, 1, 3)             # [b,h,q,d]
        delta = (do * out).sum(dim=-1)                    # [b,h,q]
        q_pos = my * t_loc + torch.arange(t_loc, device=q.device)
        dq = torch.zeros_like(qf)
        # k, v and their gradient accumulators travel together
        blk = torch.stack([k.float(), v.float(), torch.zeros_like(qf),
                           torch.zeros_like(qf)])
        for i in range(sp):
            src = (my - i) % sp
            kf, vf = blk[0], blk[1]
            logits = _block_logits(qf, kf, scale, causal, q_pos, src, t_loc)
            p = torch.exp(logits - lse[..., None])        # [b,h,q,k]
            dv = torch.einsum("bhqk,bhqd->bkhd", p, do)
            dp = torch.einsum("bhqd,bkhd->bhqk", do, vf)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
            dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            blk = torch.stack([kf, vf, blk[2] + dk, blk[3] + dv])
            blk = _coll._permute(m, blk, axis_name, 1,
                                 key=("ring_attention", ctx.seq, i))
        return (dq.to(q.dtype), blk[2].to(k.dtype), blk[3].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, axis_name: str, scale=None, causal=False):
    """Attention with the sequence sharded over ``axis_name``: q, k, v
    are this device's ``[B, T_local, H, D]`` blocks, contiguous chunks of
    the sequence. ``causal`` masks by global position (``shard index *
    T_local + local position``). The statistics are f32; the output has
    q's dtype."""
    m = _coll._member("ring_attention")
    tq, wrap = _coll._unwrap(q)
    tk, tv = _coll._unwrap(k)[0], _coll._unwrap(v)[0]
    sp = m.axis_size(axis_name)
    # the reference charges its scan body's two permutes sp times each
    for t in (tk, tv):
        _coll.traced(_coll._watch("ppermute", t, sp, count=sp), axis_name,
                     sp)
    return wrap(_RingAttention.apply(tq, tk, tv, m, axis_name,
                                     _scale_of(tq, scale), bool(causal)))


def ulysses_attention(q, k, v, axis_name: str, scale=None):
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses shape):
    ``[B, T/sp, H, D]`` -> ``[B, T, H/sp, D]`` with one all-to-all each
    for q, k and v, :func:`local_attention` over the whole sequence on
    the head shard, then one all-to-all back."""
    q2 = _coll.all_to_all(q, axis_name, split_axis=2, concat_axis=1,
                          tiled=True)
    k2 = _coll.all_to_all(k, axis_name, split_axis=2, concat_axis=1,
                          tiled=True)
    v2 = _coll.all_to_all(v, axis_name, split_axis=2, concat_axis=1,
                          tiled=True)
    out = local_attention(q2, k2, v2, scale)
    return _coll.all_to_all(out, axis_name, split_axis=1, concat_axis=2,
                            tiled=True)
