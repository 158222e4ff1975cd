"""Deterministic fault-injection registry (counterpart of
``mxnet_tpu/faultinject.py``): named injection points that fire with a
configured probability and an optional budget, so every recovery path
can be exercised on demand.

Configuration: ``MXNET_FAULT_INJECT=site:prob[:max_fires],...``, e.g.
``MXNET_FAULT_INJECT=nan_grad:1:1``. A bare ``site`` means probability
1. ``MXNET_FAULT_INJECT_SEED`` seeds the draw, so fractional
probabilities replay deterministically. Tests arm sites with
:func:`set_fault`, which takes precedence over the environment.

Every site of the reference is registered, so one spec drives both
packages. In the port these fire so far, with ``engine_op`` and
``engine_dep_drop`` (``engine.py``) and ``dl_worker`` and
``dl_worker_respawn`` (the DataLoader's workers):

``nan_grad``     the grad guard's entry point poisons the first gradient
                 with NaN (``guardrails.inject_grad_faults``; inside a
                 K-step chunk the same draw, made when the step is
                 buffered, selects NaN in the captured graph, scan.py).
                 A Trainer with a kvstore draws it before the reduce, on
                 its first replica, so the dist store's finite vote sees
                 the rank it came from.
``scaled_grad``  the last gradient is multiplied by 1e4 at the same
                 points: finite but out of distribution.
``rendezvous``   one ``dist.initialize`` rendezvous attempt fails: the
                 retry with backoff runs, under
                 ``MXNET_DIST_INIT_TIMEOUT``.
``barrier``      ``dist.barrier`` never completes (a lost rank): its
                 watchdog (``MXNET_BARRIER_TIMEOUT``) raises MXNetError.
``kv_hang``      one dist kvstore call hangs: the per-call deadline
                 (``MXNET_KVSTORE_TIMEOUT``) trips and the bounded retry
                 runs (``kvstore/dist.py`` through
                 ``dist.call_with_deadline``).
``ckpt_write``   a checkpoint write (``model.save_checkpoint``) is cut
                 to half its bytes and fails; the error surfaces at
                 ``wait_checkpoints``, and no ``.params`` is published.
``replica_crash`` a serving replica dies after the compute and before
                 its reply (a process replica exits hard; an in-process
                 one drops its connections and stops renewing its
                 lease): the router detects the death and resubmits the
                 request to another replica exactly once
                 (``serve/fleet.py``).
``replica_slow`` a serving replica sleeps before it replies: a hedged
                 request wins on another replica, and the per-replica
                 p99 table names the slow one.
``kv_flap``      one fleet-KV operation raises ConnectionError
                 (``dist.KV``): the router keeps its last-known-good
                 routing table instead of ejecting the fleet.
``slice_preempt`` an elastic poll (``elastic.poll_survivors``) sees a
                 preemption notice that keeps the front half of the
                 contexts: ``Estimator.fit`` under ``MXNET_ELASTIC``
                 moves the live run onto them.
``reshard_fail`` a live transition fails at its entry
                 (``Trainer.reshard_to``, ``reshard.reshard_fragments``,
                 ``reshard.redistribute``; not the restore's own
                 ``place_from_host``): the transition degrades to the
                 newest checkpoint.

``engine_collective_overlap`` comes with the engine's collective pushes
(ROADMAP.md queue 1, item 11). Every fire counts in
``mx_fault_injections_total{site}``.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Optional

__all__ = ["should_fail", "maybe_fail", "set_fault", "clear", "fires",
           "active", "reset", "SITES"]

SITES = ("ckpt_write", "dl_worker", "dl_worker_respawn", "rendezvous",
         "barrier", "nan_grad", "scaled_grad", "engine_op",
         "engine_dep_drop", "engine_collective_overlap", "kv_hang",
         "slice_preempt", "reshard_fail", "replica_crash",
         "replica_slow", "kv_flap")

_LOCK = threading.Lock()
_ENV_RAW = [None]                      # last parsed MXNET_FAULT_INJECT value
_ENV_SITES: Dict[str, dict] = {}       # parsed from the environment
_PROG_SITES: Dict[str, dict] = {}      # set_fault's, which take precedence
_RNG = [None]


def _parse(spec: str) -> Dict[str, dict]:
    sites: Dict[str, dict] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0].strip()
        try:
            prob = float(fields[1]) if len(fields) > 1 else 1.0
            max_fires = int(fields[2]) if len(fields) > 2 else None
        except ValueError:
            raise ValueError(
                "malformed MXNET_FAULT_INJECT entry %r — expected "
                "site:prob[:max_fires]" % part)
        sites[name] = {"prob": prob, "max_fires": max_fires, "fires": 0}
    return sites


def _env_sites() -> Dict[str, dict]:
    from .config import get as _cfg
    raw = _cfg("MXNET_FAULT_INJECT")
    if raw != _ENV_RAW[0]:
        # a changed spec resets the fire counts and the draw stream
        _ENV_RAW[0] = raw
        _ENV_SITES.clear()
        _ENV_SITES.update(_parse(raw))
        _RNG[0] = None
    return _ENV_SITES


def _rng() -> random.Random:
    if _RNG[0] is None:
        from .config import get as _cfg
        _RNG[0] = random.Random(_cfg("MXNET_FAULT_INJECT_SEED"))
    return _RNG[0]


def set_fault(site: str, prob: float = 1.0,
              max_fires: Optional[int] = None) -> None:
    """Arm ``site`` (over the environment's spec); armed faults are
    process-global, so pair this with :func:`clear`."""
    with _LOCK:
        _PROG_SITES[site] = {"prob": float(prob), "max_fires": max_fires,
                             "fires": 0}


def clear(site: Optional[str] = None) -> None:
    """Disarm one site armed by :func:`set_fault`, or all of them; the
    environment's sites stay."""
    with _LOCK:
        if site is None:
            _PROG_SITES.clear()
        else:
            _PROG_SITES.pop(site, None)


def reset() -> None:
    """Disarm every armed site and drop the parsed environment (its fire
    counts and draw stream restart even if the spec is unchanged)."""
    with _LOCK:
        _PROG_SITES.clear()
        _ENV_RAW[0] = None
        _ENV_SITES.clear()
        _RNG[0] = None


def should_fail(site: str) -> bool:
    """One draw at ``site``; True consumes a fire."""
    with _LOCK:
        st = _PROG_SITES.get(site)
        if st is None:
            st = _env_sites().get(site)
        if st is None or st["prob"] <= 0:
            return False
        if st["max_fires"] is not None and st["fires"] >= st["max_fires"]:
            return False
        if st["prob"] < 1.0 and _rng().random() >= st["prob"]:
            return False
        st["fires"] += 1
    try:                      # outside _LOCK: telemetry must not nest
        from . import telemetry
        telemetry.fault_event(site)
    except Exception:  # noqa: BLE001 - a counter never stops a fault
        pass
    return True


def maybe_fail(site: str, exc_type=None, msg: Optional[str] = None) -> None:
    """Raise at ``site`` when it fires."""
    if should_fail(site):
        if exc_type is None:
            from .base import MXNetError
            exc_type = MXNetError
        raise exc_type(msg or "injected fault: %s" % site)


def fires(site: str) -> int:
    """How many times ``site`` has fired in this process."""
    with _LOCK:
        st = _PROG_SITES.get(site) or _env_sites().get(site)
        return 0 if st is None else st["fires"]


def active() -> bool:
    """Whether any site is configured (a cheap gate for hot paths)."""
    with _LOCK:
        return bool(_PROG_SITES) or bool(_env_sites())
