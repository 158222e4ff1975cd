"""Seeded random state: one ``torch.Generator`` per context
(counterpart of ``mxnet_tpu/random.py``; ref: python/mxnet/random.py).

``seed(s)`` resets every context's stream and ``seed(s, ctx)`` one of
them. The device id is folded into the seed, so two cards draw
independent streams. Nothing in the package draws from torch's global
generator: initializers take their generator from here or from the
caller, and the dropout kernels take their int32 seeds from
:func:`seeds`.
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
    """``n`` int32 seeds in [0, 2^31 - 1) drawn from ``ctx``'s generator,
    on ``ctx``'s device (the reference draws its dropout kernels' seeds
    with ``jax.random.randint`` over the same range)."""
    ctx = Context(ctx or current_context())
    return torch.randint(0, 2 ** 31 - 1, (int(n),), generator=generator(ctx),
                         dtype=torch.int32, device=ctx.torch_device)
