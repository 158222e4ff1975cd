"""Seeded random state: one ``torch.Generator`` per context
(counterpart of ``mxnet_tpu/random.py``; ref: python/mxnet/random.py).

``seed(s)`` resets every context's stream and ``seed(s, ctx)`` one of
them. The device id is folded into the seed, so two cards draw
independent streams. Nothing in the package draws from torch's global
generator: initializers take their generator from here or from the
caller, and the dropout kernels take their int32 seeds from
:func:`seeds`.

On a CUDA context :func:`seeds` draws from a counter that lives on the
card (one int64 a context, advanced in place by every draw) through the
dropout kernels' counter hash, so a captured CUDA graph that draws seeds
advances the counter on each replay and every replay gets new ones;
``seed()`` resets the counter in place, so captured graphs see the
reset too. On the CPU the seeds come from the context's generator.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from .context import Context, current_context

__all__ = ["seed", "generator", "seeds"]

_lock = threading.Lock()
_seed = 0
_ctx_seed: Dict[Context, int] = {}
_gens: Dict[Context, torch.Generator] = {}
# one int64 counter on each CUDA context's card, never replaced (a
# captured graph holds its address)
_counters: Dict[Context, torch.Tensor] = {}


def _base(ctx: Context) -> int:
    """The counter's start: the context's seed in the high 32 bits."""
    return ((_ctx_seed.get(ctx, _seed) * 1000003 + ctx.device_id)
            % (1 << 31)) << 32


def seed(seed_state: int, ctx: Optional[Context] = None):
    """Reset the generators (ref: mx.random.seed)."""
    global _seed
    with _lock:
        if ctx is None:
            _seed = int(seed_state)
            _ctx_seed.clear()
            _gens.clear()
        else:
            ctx = Context(ctx)
            _ctx_seed[ctx] = int(seed_state)
            _gens.pop(ctx, None)
        for c, counter in _counters.items():
            if ctx is None or c == ctx:
                counter.fill_(_base(c))


def generator(ctx: Optional[Context] = None) -> torch.Generator:
    """The generator of ``ctx`` (created from the current seed on first
    use; draws advance it)."""
    ctx = Context(ctx or current_context())
    with _lock:
        g = _gens.get(ctx)
        if g is None:
            g = torch.Generator(device=ctx.torch_device)
            g.manual_seed((_ctx_seed.get(ctx, _seed) * 1000003
                           + ctx.device_id) % (1 << 63))
            _gens[ctx] = g
        return g


def seeds(n: int, ctx: Optional[Context] = None) -> torch.Tensor:
    """``n`` int32 seeds in [0, 2^31 - 1) on ``ctx``'s device, from its
    generator on the CPU and from its counter on a card (the reference
    draws its dropout kernels' seeds with ``jax.random.randint`` over
    the same range)."""
    ctx = Context(ctx or current_context())
    dev = ctx.torch_device
    if dev.type != "cuda":
        return torch.randint(0, 2 ** 31 - 1, (int(n),),
                             generator=generator(ctx), dtype=torch.int32,
                             device=dev)
    from .ops.cuda_dropout import hash_bits
    with _lock:
        counter = _counters.get(ctx)
        if counter is None:
            counter = torch.full((1,), _base(ctx), dtype=torch.int64,
                                 device=dev)
            _counters[ctx] = counter
    c = counter + torch.arange(int(n), dtype=torch.int64, device=dev)
    counter.add_(int(n))
    bits = hash_bits(c & 0xFFFFFFFF, c >> 32)
    return (bits % (2 ** 31 - 1)).to(torch.int32)
