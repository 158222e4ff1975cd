"""The quantized gradient wire: int8 or fp8 on the wire, f32 in the sums
(counterpart of ``mxnet_tpu/parallel/quantize.py``).

The scheme, in the order a sync runs it:

1. **quantize** each replica's contribution blockwise: one f32 absmax
   scale per ``MXNET_KVSTORE_QUANTIZE_BLOCK`` elements, the values on
   the symmetric int8 grid [-127, 127] or cast to ``float8_e4m3fn``
   (round to nearest even);
2. **reduce-scatter in low precision**: the payload and its scales go
   through an ``all_to_all`` (blocks with different scales cannot be
   summed on the wire) and each shard's owner dequantizes and
   accumulates in f32, in source order;
3. **all-gather the re-quantized sum**, dequantized by every receiver.

Error feedback: every quantize site's rounding error is returned in the
domain of the original input (one buffer shaped like the gradient a
replica), and the caller adds it into the next step's input, so

    sum_t out_t == sum_t sum_r grad_{r,t} + (res_0 - res_K)

holds exactly in infinite precision (to a ulp-scaled tolerance in f32).

``MXNET_KVSTORE_QUANTIZE_TIER``: in a staged dcn x ici sync, ``dcn``
quantizes the cross-slice hop only and keeps the in-slice hop f32,
``all`` quantizes both; a flat sync is its own outermost tier and is
quantized under either.

Edge cases: an all-zero block gets scale 1 (exact zeros); a block whose
absmax is not finite gets a NaN or infinite scale, so its whole
dequantized block is NaN and the guard names the parameter, while its
carried error is 0 (a poisoned residual would re-poison every later
step).

Stochastic rounding (int8 only) adds a dither drawn from a
``torch.Generator`` on the replica's device, seeded from the step's seed
folded with the replica's index and the quantize site. Its bits are not
``jax.random``'s: it agrees with the reference by distribution (an
unbiased mean error), not bit for bit.

The functions run inside ``shard_map`` or the ZeRO step (one thread a
mesh device, :mod:`._spmd`); the collectives record their payloads into
:mod:`mxnet_tpu_torch.commwatch` at their wire dtype (``int8``/``fp8``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.elemwise import div_exact

__all__ = ["QuantConfig", "from_env", "wire_dtype", "padded_cols",
           "quantize_rows", "dequantize_rows", "quantized_rs",
           "quantized_ag", "quantized_allreduce", "MODES", "TIERS",
           "note_active", "active_mode", "np_reference_quantize"]

MODES = ("int8", "fp8")
TIERS = ("dcn", "all")

# int8: the symmetric grid [-127, 127]; fp8 e4m3: absmax maps to the
# format's largest normal, 448
_QMAX = {"int8": 127.0, "fp8": 448.0}


@dataclass(frozen=True)
class QuantConfig:
    mode: str = "int8"           # int8 | fp8
    block: int = 256             # elements per absmax scale block
    stochastic: bool = False     # stochastic rounding (int8 only)
    tier: str = "dcn"            # dcn | all: which staged hops quantize

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError("MXNET_KVSTORE_QUANTIZE=%r: expected one "
                             "of %s (or 'off')" % (self.mode,
                                                   "|".join(MODES)))
        if self.tier not in TIERS:
            raise ValueError("MXNET_KVSTORE_QUANTIZE_TIER=%r: expected "
                             "%s" % (self.tier, "|".join(TIERS)))
        if self.block < 8:
            raise ValueError("MXNET_KVSTORE_QUANTIZE_BLOCK=%d: blocks "
                             "under 8 elements spend more on scale "
                             "sidecars than they save" % self.block)

    def key(self) -> tuple:
        """A hashable identity of the configuration."""
        return (self.mode, self.block, self.stochastic, self.tier)


# the mode a sync path of this process last used (the kvstore's reduce,
# the ZeRO engine): set_gradient_compression turns int8 on without the
# environment, and guard events must still name it
_LAST_ACTIVE: Optional[str] = None


def note_active(cfg: Optional[QuantConfig]):
    global _LAST_ACTIVE
    if cfg is not None:
        _LAST_ACTIVE = cfg.mode


def active_mode() -> Optional[str]:
    """The mode in effect: the environment's, else the one a sync path
    last used, else None."""
    cfg = from_env()
    return cfg.mode if cfg is not None else _LAST_ACTIVE


def from_env() -> Optional[QuantConfig]:
    """The QuantConfig of ``MXNET_KVSTORE_QUANTIZE*``, or None when the
    wire is off (the default)."""
    from ..config import get as _cfg
    mode = (_cfg("MXNET_KVSTORE_QUANTIZE") or "off").lower()
    if mode in ("off", "0", "false", ""):
        return None
    cfg = QuantConfig(mode=mode,
                      block=int(_cfg("MXNET_KVSTORE_QUANTIZE_BLOCK")),
                      stochastic=bool(
                          _cfg("MXNET_KVSTORE_QUANTIZE_STOCHASTIC")),
                      tier=(_cfg("MXNET_KVSTORE_QUANTIZE_TIER")
                            or "dcn").lower())
    wire_dtype(cfg)
    return cfg


def wire_dtype(cfg: QuantConfig) -> torch.dtype:
    """The torch dtype of the wire payload."""
    if cfg.mode == "fp8":
        if not hasattr(torch, "float8_e4m3fn"):
            raise ValueError("MXNET_KVSTORE_QUANTIZE=fp8 needs a torch "
                             "with float8_e4m3fn; use int8")
        return torch.float8_e4m3fn
    return torch.int8


def padded_cols(L: int, cfg: QuantConfig) -> int:
    """The wire row length of a row of ``L`` elements: whole scale
    blocks (the padding rides the wire only, never a shard layout)."""
    return -(-L // cfg.block) * cfg.block


# ---------------------------------------------------------------------------
# blockwise quantize and dequantize (plain torch: no kernel of its own)
# ---------------------------------------------------------------------------
def _dither(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


def quantize_rows(x, cfg: QuantConfig, key: Optional[int] = None):
    """Quantize each row of ``x (m, L)`` on its own (a row is one
    destination's chunk: no scale block spans two). Returns ``(q (m, Lp)
    wire dtype, scales (m, Lp / B) f32, err (m, L) f32)``, ``Lp =
    padded_cols(L)``; ``err = x - dequant(q)`` is the error-feedback
    carry, 0 in a block whose scale is not finite. ``key`` seeds the
    stochastic dither (int8 with ``cfg.stochastic``)."""
    m, L = x.shape
    B = cfg.block
    Lp = padded_cols(L, cfg)
    xf = x.float()
    if Lp != L:
        xf = torch.cat([xf, xf.new_zeros((m, Lp - L))], dim=1)
    blocks = xf.reshape(m, Lp // B, B)
    absmax = blocks.abs().amax(dim=2)
    qmax = _QMAX[cfg.mode]
    # absmax 0 -> scale 1; a non-finite absmax stays non-finite on
    # purpose (the block dequantizes to NaN)
    # a 0-d tensor divisor: CUDA divides by a host number as a product
    # with its reciprocal, a last bit away from the CPU's quotient
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         div_exact(absmax, qmax))
    scaled = blocks / scales[:, :, None]
    if cfg.mode == "fp8":
        q = scaled.to(wire_dtype(cfg))
    else:
        if cfg.stochastic and key is not None:
            rounded = torch.floor(scaled + _dither(scaled.shape, key,
                                                   scaled.device))
        else:
            rounded = torch.round(scaled)
        rounded = rounded.clamp(-qmax, qmax)
        # a NaN (a poisoned block) converts to 0, as XLA converts it
        q = torch.where(torch.isnan(rounded), torch.zeros_like(rounded),
                        rounded).to(torch.int8)
    deq = q.float() * scales[:, :, None]
    err = x.float() - deq.reshape(m, Lp)[:, :L]
    err = torch.where(torch.isfinite(err), err, torch.zeros_like(err))
    return q.reshape(m, Lp), scales, err


def dequantize_rows(q, scales, cfg: QuantConfig) -> torch.Tensor:
    """The inverse of :func:`quantize_rows` without the pad slice:
    ``q (m, Lp)`` and ``scales (m, Lp / B)`` -> ``(m, Lp)`` f32."""
    m, Lp = q.shape
    B = cfg.block
    return (q.float().reshape(m, Lp // B, B)
            * scales[:, :, None]).reshape(m, Lp)


# ---------------------------------------------------------------------------
# the collective compositions (inside a mesh run)
# ---------------------------------------------------------------------------
def _t(x) -> torch.Tensor:
    from ..ndarray import NDArray
    return x.tensor() if isinstance(x, NDArray) else x


def _a2a_deq_sum(q, scales, axis_name, cfg: QuantConfig) -> torch.Tensor:
    """The low-precision reduce-scatter: each destination's row goes to
    it through ``all_to_all``, and the owner dequantizes the received
    rows and adds them in f32, in source order. The ``(Lp,)`` shard."""
    from . import collectives as coll
    qx = _t(coll.all_to_all(q, axis_name, split_axis=0, concat_axis=0,
                            tiled=True))
    sx = _t(coll.all_to_all(scales, axis_name, split_axis=0,
                            concat_axis=0, tiled=True))
    deq = dequantize_rows(qx, sx, cfg)
    acc = deq[0].clone()
    for j in range(1, deq.shape[0]):
        acc = acc + deq[j]
    return acc


def _fold(key, axis_name, salt: int) -> Optional[int]:
    """The dither seed of one quantize site: the step's seed folded with
    this device's index along ``axis_name`` and the site's salt."""
    if key is None:
        return None
    from . import collectives as coll
    idx = coll._axis_index(axis_name)
    return int(np.random.SeedSequence(
        [int(key) & 0xFFFFFFFF, int(idx), int(salt)]).generate_state(1)[0])


def quantized_rs(g, ici_axis, dcn_axis, cfg: QuantConfig,
                 key: Optional[int] = None) -> Tuple:
    """Reduce-scatter ``g (n, C)`` (row j: this replica's part of global
    fragment j) with a low-precision wire. Returns ``(shard (C,) f32,
    err (n, C) f32)``, ``err`` in the caller's row domain: a staged hop
    scatters its error into the rows its input covered, so each
    correction re-enters the global sum once. Flat (``dcn_axis`` None):
    one quantized hop. Staged: RS(ici) then RS(dcn); ``tier='dcn'``
    keeps the ici hop f32."""
    from . import collectives as coll
    g = _t(g)
    n, C = g.shape
    if dcn_axis is None:
        q, sc, err = quantize_rows(g, cfg, key=_fold(key, ici_axis, 0))
        shard = _a2a_deq_sum(q, sc, ici_axis, cfg)[:C]
        return shard, err
    n_ici = coll.axis_size(ici_axis)
    n_dcn = coll.axis_size(dcn_axis)
    if cfg.tier == "all":
        g3 = g.reshape(n_ici, n_dcn * C)
        q, sc, e1 = quantize_rows(g3, cfg, key=_fold(key, ici_axis, 0))
        blk = _a2a_deq_sum(q, sc, ici_axis, cfg)[:n_dcn * C] \
            .reshape(n_dcn, C)
        err = e1.reshape(n, C)
    else:
        blk = _t(coll.reduce_scatter(g, ici_axis, scatter_axis=0)).float()
        err = torch.zeros((n, C), dtype=torch.float32, device=g.device)
    q, sc, e2 = quantize_rows(blk, cfg, key=_fold(key, dcn_axis, 1))
    shard = _a2a_deq_sum(q, sc, dcn_axis, cfg)[:C]
    # the hop-2 input covered global rows [i * n_dcn, (i + 1) * n_dcn)
    # of this replica's contribution: its error goes back there
    row0 = coll._axis_index(ici_axis) * n_dcn
    err = err.clone()
    err[row0:row0 + n_dcn] += e2
    return shard, err


def quantized_ag(shard, ici_axis, dcn_axis, cfg: QuantConfig,
                 key: Optional[int] = None) -> Tuple:
    """All-gather ``shard (C,)`` (this device's global fragment) with a
    low-precision wire, inverting :func:`quantized_rs`'s placement.
    Returns ``(full (n, C) f32, row j fragment j; err (C,) f32, this
    device's re-quantization error)``. Staged ``tier='dcn'``: the
    payload crosses dcn quantized and the ici hop carries f32."""
    from . import collectives as coll
    shard = _t(shard)
    C = shard.shape[0]
    q, sc, err = quantize_rows(shard[None], cfg,
                               key=_fold(key, ici_axis, 2))
    qv, sv = q[0], sc[0]
    Lp, nb = qv.shape[0], sv.shape[0]
    if dcn_axis is None:
        n = coll.axis_size(ici_axis)
        qf = _t(coll.allgather(qv, ici_axis))
        sf = _t(coll.allgather(sv, ici_axis))
        full = dequantize_rows(qf.reshape(n, Lp), sf.reshape(n, nb),
                               cfg)[:, :C]
        return full, err[0, :C]
    n_ici = coll.axis_size(ici_axis)
    n_dcn = coll.axis_size(dcn_axis)
    q1 = _t(coll.allgather(qv, dcn_axis))
    s1 = _t(coll.allgather(sv, dcn_axis))
    if cfg.tier == "all":
        qf = _t(coll.allgather(q1, ici_axis))
        sf = _t(coll.allgather(s1, ici_axis))
        n = n_ici * n_dcn
        full = dequantize_rows(qf.reshape(n, Lp), sf.reshape(n, nb),
                               cfg)[:, :C]
    else:
        blk = dequantize_rows(q1.reshape(n_dcn, Lp),
                              s1.reshape(n_dcn, nb), cfg)[:, :C]
        full = _t(coll.allgather(blk.contiguous(), ici_axis, axis=0))
    return full, err[0, :C]


def quantized_allreduce(g, ici_axis, dcn_axis, cfg: QuantConfig,
                        residual=None, key: Optional[int] = None) -> Tuple:
    """The quantized all-reduce of a flat ``g (S,)``: quantized RS, f32
    accumulate, re-quantized AG, with error feedback when ``residual
    (S,)`` is given. Returns ``(out (S,) f32, new_residual (S,) f32)``."""
    from . import collectives as coll
    g = _t(g)
    S = g.shape[0]
    n = coll.axis_size(ici_axis)
    if dcn_axis is not None:
        n = n * coll.axis_size(dcn_axis)
    gin = g.float()
    if residual is not None:
        gin = gin + _t(residual)
    gp = _t(coll.pad_to_multiple(gin, n * cfg.block))
    C = gp.shape[0] // n
    shard, err = quantized_rs(gp.reshape(n, C), ici_axis, dcn_axis, cfg,
                              key=key)
    full, err2 = quantized_ag(shard, ici_axis, dcn_axis, cfg, key=key)
    # the own shard's re-quantization error re-enters the sum through
    # this replica's own row
    own = coll.shard_owner_index(ici_axis, dcn_axis)
    err = err.clone()
    err[own] += err2
    return full.reshape(-1)[:S], err.reshape(-1)[:S]


def np_reference_quantize(x: np.ndarray, cfg: QuantConfig):
    """A numpy version of :func:`quantize_rows` for one row (the tests'
    independent oracle). Returns ``(dequantized, err)``."""
    L = x.shape[0]
    B = cfg.block
    Lp = padded_cols(L, cfg)
    xf = np.zeros(Lp, np.float32)
    xf[:L] = x.astype(np.float32)
    blocks = xf.reshape(Lp // B, B)
    absmax = np.max(np.abs(blocks), axis=1)
    qmax = _QMAX[cfg.mode]
    scales = np.where(absmax == 0, np.float32(1.0),
                      (absmax / qmax).astype(np.float32))
    scaled = blocks / scales[:, None]
    if cfg.mode == "fp8":
        q = torch.from_numpy(np.ascontiguousarray(scaled, np.float32)).to(
            torch.float8_e4m3fn).float().numpy()
    else:
        q = np.clip(np.round(scaled), -qmax, qmax)
    deq = (q * scales[:, None]).reshape(Lp)[:L].astype(np.float32)
    return deq, x.astype(np.float32) - deq
