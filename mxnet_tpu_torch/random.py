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

:func:`stream` overrides both on the calling thread: inside it, draws
on a context of the stream's device type come from the stream's own
generator and counter (a sharded step's replica carries its own,
``parallel/sharded.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from .context import Context, current_context

__all__ = ["seed", "generator", "seeds", "stream", "uniform", "normal", "randint",
           "randn", "exponential", "poisson", "gamma", "shuffle",
           "multinomial"]

_lock = threading.Lock()
_seed = 0
_ctx_seed: Dict[Context, int] = {}
_gens: Dict[Context, torch.Generator] = {}
# one int64 counter on each CUDA context's card, never replaced (a
# captured graph holds its address)
_counters: Dict[Context, torch.Tensor] = {}


def _gen_seed(ctx: Context) -> int:
    return (_ctx_seed.get(ctx, _seed) * 1000003 + ctx.device_id) % (1 << 63)


def _base(ctx: Context) -> int:
    """The counter's start: the context's seed in the high 32 bits."""
    return ((_ctx_seed.get(ctx, _seed) * 1000003 + ctx.device_id)
            % (1 << 31)) << 32


def seed(seed_state: int, ctx: Optional[Context] = None):
    """Reset the generators and the on-card counters (ref:
    mx.random.seed), in place."""
    global _seed
    with _lock:
        if ctx is None:
            _seed = int(seed_state)
            _ctx_seed.clear()
        else:
            ctx = Context(ctx)
            _ctx_seed[ctx] = int(seed_state)
        for c, g in _gens.items():
            if ctx is None or c == ctx:
                g.manual_seed(_gen_seed(c))
        for c, counter in _counters.items():
            if ctx is None or c == ctx:
                counter.fill_(_base(c))


_OVR = threading.local()


@contextlib.contextmanager
def stream(gen: torch.Generator, counter: Optional[torch.Tensor] = None):
    """Inside the scope, on this thread, a context of ``gen``'s device
    type draws from ``gen`` (and, on a card, its seeds from ``counter``,
    an int64 tensor of one element advanced in place)."""
    prev = getattr(_OVR, "src", None)
    _OVR.src = (gen, counter)
    try:
        yield
    finally:
        _OVR.src = prev


def _override(ctx: Context):
    src = getattr(_OVR, "src", None)
    if src is None:
        return None
    kind = "cuda" if ctx.device_type == "gpu" else "cpu"
    return src if src[0].device.type == kind else None


def generator(ctx: Optional[Context] = None) -> torch.Generator:
    """The generator of ``ctx`` (created from the current seed on first
    use; draws advance it)."""
    ctx = Context(ctx or current_context())
    src = _override(ctx)
    if src is not None:
        return src[0]
    with _lock:
        g = _gens.get(ctx)
        if g is None:
            g = torch.Generator(device=ctx.torch_device)
            g.manual_seed(_gen_seed(ctx))
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
    src = _override(ctx)
    with _lock:
        counter = src[1] if src is not None else _counters.get(ctx)
        if counter is None:
            counter = torch.full((1,), _base(ctx), dtype=torch.int64,
                                 device=dev)
            _counters[ctx] = counter
    c = counter + torch.arange(int(n), dtype=torch.int64, device=dev)
    counter.add_(int(n))
    bits = hash_bits(c & 0xFFFFFFFF, c >> 32)
    return (bits % (2 ** 31 - 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# MXNet 1.x's mx.random functions
# ---------------------------------------------------------------------------
def _draw(name, params, shape, dtype, ctx, out):
    """``_random_<name>`` with the scalar ``params`` (a dict); the result
    copied into ``out`` when one is given."""
    from .ndarray import invoke
    attrs = dict(params, ctx=ctx)
    if shape is not None:
        attrs["shape"] = shape
    if dtype is not None:
        attrs["dtype"] = dtype
    res = invoke("_random_" + name, [], attrs)
    if out is None:
        return res
    out[:] = res
    return out


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None):
    """Draws from U[low, high)."""
    return _draw("uniform", {"low": low, "high": high}, shape, dtype, ctx,
                 out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    """Draws from N(loc, scale^2)."""
    return _draw("normal", {"loc": loc, "scale": scale}, shape, dtype, ctx,
                 out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    """Normal draws of the shape given by position."""
    return normal(loc, scale, shape, dtype, ctx)


def randint(low, high, shape=None, dtype=None, ctx=None, out=None):
    """Integers in [low, high) (int32 by default)."""
    return _draw("randint", {"low": low, "high": high}, shape, dtype, ctx,
                 out)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None,
                lam=None):
    """Exponential draws of mean ``scale`` (MXNet 1.x), or of rate
    ``lam`` (the reference's keyword)."""
    lam = 1.0 / scale if lam is None else lam
    return _draw("exponential", {"lam": lam}, shape, dtype, ctx, out)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None):
    """Poisson draws of rate ``lam`` (float32 by default)."""
    return _draw("poisson", {"lam": lam}, shape, dtype, ctx, out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None):
    """Gamma draws of shape ``alpha`` and scale ``beta``."""
    return _draw("gamma", {"alpha": alpha, "beta": beta}, shape, dtype, ctx,
                 out)


def shuffle(data):
    """``data`` with its rows (axis 0) in a random order."""
    from .ndarray import invoke
    return invoke("_shuffle", [data], {})


def multinomial(data, shape=None, get_prob=False, out=None, dtype="int32"):
    """Category draws from the probabilities on ``data``'s last axis,
    ``shape`` draws per distribution; with ``get_prob`` also the log
    probability of each draw."""
    from .ndarray import invoke
    res = invoke("_sample_multinomial", [data], {
        "shape": () if shape is None else shape, "get_prob": get_prob,
        "dtype": dtype})
    if out is None:
        return res
    out[:] = res
    return out
