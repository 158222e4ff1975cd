"""Launch-plan auto-tuner over the port's hand-written CUDA kernels
(counterpart of ``mxnet_tpu/autotune.py``).

Each kernel wrapper computes a launch plan from hand-picked constants:
the LayerNorm grids (``ops/cuda_norm.py``), the epilogue strips
(``ops/cuda_epilogue.py``), the dropout kernel's accesses a thread and
blocks (``ops/cuda_dropout.py``), the dual backward's splits
(``ops/cuda_fused.py``), and the chunked LM-head CE's vocab chunk
(``ops/contrib_ops.py``). This module lets a table pick them per
``(card, kernel, shape)`` instead. The attention kernels have nothing
to tune: the reference tunes their head block, a TPU block shape, and
in the port that number only names the dropout mask's seed blocks (the
kernels' grids do not depend on it), so it stays
``cuda_attention.selfatt_plan``'s.

Modes (``MXNET_AUTOTUNE``):

* ``off`` (default): :func:`lookup` returns the caller's default
  untouched; no table, no candidate, nothing consulted. The kernel
  wrappers read the cached gate :func:`enabled` and then build nothing
  and launch as without the tuner (the launchers that pick their own
  grid are handed 0).
* ``cost``: enumerate the caller's candidate grid (the default first),
  drop the candidates the card cannot launch (the kernel's own queries:
  occupancy, shared memory within the card's opt-in limit, the
  launcher's ranges), and score a roofline ``max(flops / peak FLOP/s,
  bytes / HBM bytes/s)`` over each candidate's analytic figures. The
  lowest wins; a tie keeps the earlier candidate, so where every plan
  does the same work (the row kernels move the same bytes on any grid)
  the default stays. Nothing is built or launched.
* ``measure``: rank by cost first, then time the best candidates and the
  default in interleaved paired rounds on the card (CUDA events, after a
  warm-up; a load spike inflates both halves of a round and cancels in
  the ratio). A candidate is kept only when it beats the default in
  every round and its paired-median ratio is below ``1 -
  MEASURE_MARGIN``: a plan that changes the order of a sum must not be
  picked by noise, run to run. A candidate that fails to build or
  launch is logged and disqualified, and the default runs. A consult
  whose tensors are not on a card ranks by cost alone.

Decisions persist per ``card|kernel|shape`` in a process table, and in
the JSON file ``MXNET_AUTOTUNE_CACHE`` when set (the reference's file
shape: ``{key: {"params", "mode", "score"}}``). An entry that fails its
kernel's validation (stale, hand-edited) logs a warning and the default
runs: a bogus table can cost speed but never correctness, and never
changes which kernel runs. The CUDA peaks are ``telemetry.peak_flops()``
and the HBM rate by card name; on the CPU, where no card is timed, the
roofline uses stated constants, since it only ranks.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["lookup", "Candidate", "mode", "enabled", "refresh", "table",
           "clear", "entry_key", "cache_path", "tuned_plan"]

_LOG = logging.getLogger("mxnet_tpu_torch.autotune")

_LOCK = threading.RLock()
# entry_key -> {"params": dict, "mode": str, "score": float}
_TABLE: Dict[str, dict] = {}
_LOADED_FROM: Optional[str] = None    # cache file already merged in
# the cached gate of the kernel wrappers (None: read the mode again)
_STATE: Dict[str, Optional[bool]] = {"on": None}

# HBM bytes/s by card name (NVIDIA data sheets); the first fragment found
# in the name wins
_HBM_BW_BY_NAME = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12), ("H200", 4.8e12), ("A100", 2.0e12))
_HBM_BW_FALLBACK = 2.0e12
# the roofline's peaks on the CPU, or where the card's FLOP rate is not
# known: stated constants, since the roofline only ranks candidates
CPU_PEAK_FLOPS = 1.0e12
CPU_PEAK_BW = 1.0e11
# the opt-in shared memory a block may take on an H100 (227 KiB), where
# no card answers the query
_SMEM_OPTIN_FALLBACK = 227 * 1024
# CUDA-event timing: launches of one timed call, rounds, and the cycles
# the card sleeps before the first event, so that the calls queue behind
# it and the events time the card rather than the host's enqueue rate
# (about 6 ms on an H100, longer than 10 calls take to enqueue)
_CALLS = 10
_ROUNDS = 5
_SLEEP_CYCLES = 10_000_000
# a measured candidate must be this much faster than the default (paired
# median), besides winning every round
MEASURE_MARGIN = 0.03


class Candidate:
    """One tuning candidate.

    params      : the plan the kernel wrapper launches with.
    flops       : analytic FLOPs of the launch.
    hbm_bytes   : analytic bytes the launch moves to and from HBM.
    smem_bytes  : shared memory a block takes; feasible only within the
                  card's opt-in limit.
    build       : None, or a zero-argument callable returning ``(fn,
                  args)``: ``fn(*args)`` launches the kernel with this plan
                  (the paired measurement's runner).
    feasible    : the kernel's own answer to whether the card can launch
                  this plan (occupancy, the launcher's ranges).
    """

    __slots__ = ("params", "flops", "hbm_bytes", "smem_bytes", "build",
                 "feasible")

    def __init__(self, params: dict, flops: float = 0.0,
                 hbm_bytes: float = 0.0, smem_bytes: float = 0.0,
                 build: Optional[Callable] = None, feasible: bool = True):
        self.params = dict(params)
        self.flops = float(flops)
        self.hbm_bytes = float(hbm_bytes)
        self.smem_bytes = float(smem_bytes)
        self.build = build
        self.feasible = bool(feasible)


# ---------------------------------------------------------------------------
# mode / keys / persistence
# ---------------------------------------------------------------------------
def mode() -> str:
    """Live read of ``MXNET_AUTOTUNE`` (an unknown mode reads as off)."""
    from .config import get as _cfg
    m = str(_cfg("MXNET_AUTOTUNE")).lower()
    return m if m in ("off", "cost", "measure") else "off"


def enabled() -> bool:
    """Cached gate of the kernel wrappers' consults (the launch hot path;
    call :func:`refresh`, or :func:`clear`, after changing
    ``MXNET_AUTOTUNE`` mid-process)."""
    on = _STATE["on"]
    if on is None:
        on = _STATE["on"] = mode() != "off"
    return on


def refresh() -> None:
    """Drop the cached gate (chained from ``telemetry.refresh()``)."""
    _STATE["on"] = None


def _device_kind(device=None) -> str:
    """The card's name (``device``'s, else the current card's), or
    ``"cpu"``."""
    try:
        import torch
        if device is not None:
            dev = torch.device(device)
            if dev.type != "cuda":
                return dev.type
            return _card_name(dev.index if dev.index is not None
                              else torch.cuda.current_device())
        if torch.cuda.is_available():
            return _card_name(torch.cuda.current_device())
    except Exception:
        pass
    return "cpu"


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    import torch
    return torch.cuda.get_device_name(index)


def _on_card(device=None) -> bool:
    """Whether ``device`` (else the current device) is a card."""
    import torch
    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()


def entry_key(kernel: str, key: Dict[str, Any], device=None) -> str:
    sig = ",".join("%s=%s" % (k, key[k]) for k in sorted(key))
    return "%s|%s|%s" % (_device_kind(device), kernel, sig)


def cache_path() -> str:
    from .config import get as _cfg
    return str(_cfg("MXNET_AUTOTUNE_CACHE") or "")


def _load_cache_locked():
    """Merge the JSON cache file into the process table (once a path; a
    changed MXNET_AUTOTUNE_CACHE merges again)."""
    global _LOADED_FROM
    path = cache_path()
    if not path or _LOADED_FROM == path:
        return
    _LOADED_FROM = path
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            for k, v in data.items():
                if isinstance(v, dict) and isinstance(v.get("params"), dict):
                    _TABLE.setdefault(k, v)
    except Exception as e:
        _LOG.warning("autotune: unreadable cache %s (%s: %s) — ignored",
                     path, type(e).__name__, e)


def _save_cache_locked():
    path = cache_path()
    if not path:
        return
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(_TABLE, f, indent=1, sort_keys=True)
        os.replace(tmp, path)      # atomic publish
    except Exception as e:
        _LOG.warning("autotune: cannot write cache %s (%s: %s)",
                     path, type(e).__name__, e)


def table() -> Dict[str, dict]:
    """Copy of the current tuning table."""
    with _LOCK:
        return {k: dict(v) for k, v in _TABLE.items()}


def clear():
    """Drop the in-memory table, forget the merged cache path (the file
    on disk stays) and drop the cached gate."""
    global _LOADED_FROM
    with _LOCK:
        _TABLE.clear()
        _LOADED_FROM = None
    refresh()


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------
def _peaks(device=None):
    """(peak FLOP/s, HBM bytes/s) of the roofline."""
    kind = _device_kind(device)
    if kind == "cpu":
        return CPU_PEAK_FLOPS, CPU_PEAK_BW
    from . import telemetry
    pf = telemetry.peak_flops() or CPU_PEAK_FLOPS
    bw = next((v for frag, v in _HBM_BW_BY_NAME if frag in kind),
              _HBM_BW_FALLBACK)
    return pf, bw


def _smem_limit(device=None) -> int:
    """Shared memory a block may opt into on the card."""
    try:
        import torch
        if _device_kind(device) != "cpu":
            props = torch.cuda.get_device_properties(
                device if device is not None else torch.cuda.current_device())
            v = getattr(props, "shared_memory_per_block_optin", 0)
            if v:
                return int(v)
    except Exception:
        pass
    return _SMEM_OPTIN_FALLBACK


def _roofline(cand: Candidate, peak_flops, peak_bw) -> float:
    return max(cand.flops / max(peak_flops, 1.0),
               cand.hbm_bytes / max(peak_bw, 1.0))


def _score_cost(cands: Sequence[Candidate], device=None):
    """Roofline-score every feasible candidate; returns ``[(score, index,
    candidate)]`` best first, ties in candidate order (enumerators list
    the default first). Builds nothing: a runner allocates on the card
    (and a stream capture would record it); a candidate that cannot be
    built or launched is disqualified by :func:`_measure`."""
    peak_flops, peak_bw = _peaks(device)
    limit = _smem_limit(device)
    scored = []
    for i, c in enumerate(cands):
        if not c.feasible or c.smem_bytes > limit:
            continue
        scored.append((_roofline(c, peak_flops, peak_bw), i, c))
    scored.sort(key=lambda t: (t[0], t[1]))
    return scored


def _paired_median(num, den):
    ratios = sorted(n / d for n, d in zip(num, den))
    m = len(ratios) // 2
    return ratios[m] if len(ratios) % 2 else \
        (ratios[m - 1] + ratios[m]) / 2.0


def _time_once(fn, args, calls: int = _CALLS) -> float:
    """Seconds of ``calls`` calls of ``fn(*args)``: CUDA events on the
    card (the calls queued behind a sleeping kernel), the host clock
    elsewhere."""
    import torch
    if torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    return time.perf_counter() - t0


def _measure(cand: Candidate, base: Candidate,
             repeats: int = _ROUNDS) -> Optional[float]:
    """Time ratio candidate / default: a warm-up, then ``repeats``
    interleaved rounds; the paired median when the candidate won every
    round, else its worst round's ratio (at least 1, so the gate keeps
    the default). None (logged) when either side cannot be built or
    launched."""
    if cand.build is None or base.build is None:
        return None
    try:
        from .ops.cuda_build import uncounted
        with uncounted():
            c_fn, c_args = cand.build()
            b_fn, b_args = base.build()
            _time_once(c_fn, c_args, 1)        # warm-up
            _time_once(b_fn, b_args, 1)
            tc, tb = [], []
            for _ in range(repeats):
                tc.append(_time_once(c_fn, c_args))
                tb.append(_time_once(b_fn, b_args))
        worst = max(c / b for c, b in zip(tc, tb))
        return worst if worst >= 1.0 else _paired_median(tc, tb)
    except Exception as e:
        _LOG.warning("autotune: measuring %r failed (%s: %s) — "
                     "disqualified", cand.params, type(e).__name__, e)
        return None


def _capturing() -> bool:
    try:
        import torch
        return torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()
    except Exception:
        return False


# ---------------------------------------------------------------------------
# the consult point
# ---------------------------------------------------------------------------
def lookup(kernel: str, key: Dict[str, Any], default: Dict[str, Any],
           candidates: Optional[Callable[[], List[Candidate]]] = None,
           validate: Optional[Callable[[Dict[str, Any]], bool]] = None,
           measure_top: int = 2, device=None,
           measure: bool = True) -> Dict[str, Any]:
    """Tuned params for ``(kernel, key)`` on ``device``'s card (the
    current one when None), or ``default``.

    ``off`` mode and every failure return ``default`` untouched.
    ``candidates`` is a lazy enumerator, called only when the signature
    needs tuning; ``validate`` re-checks any table entry against the
    kernel's rules (an entry that fails it is warned about and the
    default runs). ``measure`` False: ``measure`` mode ranks by cost
    alone (a consult with nothing on a card to time)."""
    m = mode()
    if m == "off":
        return default
    if m == "measure" and not measure:
        m = "cost"
    ek = entry_key(kernel, key, device)
    with _LOCK:
        _load_cache_locked()
        entry = _TABLE.get(ek)
    if entry is not None:
        params = entry.get("params")
        if isinstance(params, dict) and \
                (validate is None or _safe_validate(validate, params)):
            return dict(params)
        _LOG.warning("autotune: table entry for %s failed validation "
                     "(%r) — using the default", ek, params)
        return default
    if candidates is None or (m == "measure" and _capturing()):
        return default
    try:
        cands = list(candidates())
    except Exception as e:
        _LOG.warning("autotune: candidate enumeration failed for %s (%s: "
                     "%s) — using the default", ek, type(e).__name__, e)
        return default
    # tune outside the lock: a cache hit on another thread must not wait
    # behind a measurement; two threads tuning one signature both publish
    # and the first wins
    chosen, score = _tune(m, cands, default, measure_top, device)
    with _LOCK:
        entry = _TABLE.get(ek)
        if entry is None:
            _TABLE[ek] = {"params": dict(chosen), "mode": m,
                          "score": score}
            _save_cache_locked()
            return dict(chosen)
        params = entry.get("params")
        if isinstance(params, dict) and \
                (validate is None or _safe_validate(validate, params)):
            return dict(params)
        return default


def _safe_validate(validate, params) -> bool:
    try:
        return bool(validate(params))
    except Exception:
        return False


def _tune(m: str, cands: List[Candidate], default: Dict[str, Any],
          measure_top: int = 2, device=None):
    """Pick params from the grid: the cost ranking, in measure mode
    confirmed on the card against the default. An empty or wholly
    infeasible grid resolves to the default."""
    scored = _score_cost(cands, device)
    if not scored:
        return default, 0.0
    best_score, _, best = scored[0]
    if m == "cost":
        return best.params, best_score
    # measure: the default is the bar, found in the grid by its params;
    # without it there is nothing to measure against, and an unmeasured
    # candidate never replaces the default
    base = next((c for c in cands if c.params == default), None)
    if base is None:
        _LOG.info("autotune: default %r absent from the candidate grid — "
                  "keeping it", default)
        return default, 0.0
    picked, picked_score = default, 0.0
    best_ratio = 1.0 - MEASURE_MARGIN
    for score, _, c in scored[:max(1, measure_top)]:
        if c.params == default:
            continue
        ratio = _measure(c, base)
        if ratio is not None and ratio < best_ratio:
            best_ratio = ratio
            picked, picked_score = c.params, score
    return picked, picked_score


# ---------------------------------------------------------------------------
# the shared consult of the kernel wrappers' launch plans
# ---------------------------------------------------------------------------
def tuned_plan(kernel: str, key: Dict[str, Any], default: Dict[str, Any],
               grid: Callable[[], Sequence[Dict[str, Any]]],
               valid: Callable[[Dict[str, Any]], bool], *,
               cost: Optional[Callable[[Dict[str, Any]], tuple]] = None,
               smem: Optional[Callable[[Dict[str, Any]], float]] = None,
               probe: Optional[Callable[[Dict[str, Any]], Callable]] = None,
               device=None) -> Dict[str, Any]:
    """The launch plan of one call: ``default`` (always in off mode), or
    the table's plan for ``(kernel, key)``.

    ``grid()`` lists the other candidate plans (called only to tune);
    the enumerator puts the default first, so a roofline tie keeps it.
    ``valid(plan)`` is the kernel's feasibility rule (its launcher's
    ranges and its own occupancy or shared-memory queries): a candidate
    must pass it to be scored, and a table entry to be used.
    ``cost(plan)`` gives the plan's analytic (FLOPs, bytes),
    ``smem(plan)`` a block's shared memory, ``probe(plan)`` the
    measurement's ``build`` (timed only on a card: elsewhere ``measure``
    ranks by cost). Whatever the table says, the answer is a plan that
    passes ``valid``."""
    if mode() == "off":
        return default
    on_card = _on_card(device)

    def _candidates():
        plans = [default] + [p for p in grid() if p != default]
        out = []
        for p in plans:
            flops, nbytes = cost(p) if cost is not None else (0.0, 0.0)
            out.append(Candidate(
                p, flops=flops, hbm_bytes=nbytes,
                smem_bytes=smem(p) if smem is not None else 0.0,
                build=None if probe is None or not on_card else probe(p),
                feasible=_safe_validate(valid, p)))
        return out

    out = lookup(kernel, key, default, candidates=_candidates,
                 validate=valid, device=device, measure=on_card)
    return out if _safe_validate(valid, out) else default
