"""Preemption notices and live topology transitions (counterpart of
``mxnet_tpu/elastic.py``).

When capacity goes away mid-run (a card lost, a slice preempted), the
fit loop is told which contexts survive and moves the live run onto
them through ``Trainer.reshard_to`` (:mod:`.parallel.reshard`), without
a restart; a failed move, or fewer survivors than
``MXNET_ELASTIC_MIN_DEVICES``, restores the newest checkpoint instead.

Notice sources, polled every ``MXNET_ELASTIC_POLL`` steps of
``Estimator.fit`` under ``MXNET_ELASTIC``, in this order:

1. the ``slice_preempt`` fault site (the front half survives);
2. **programmatic**: :func:`request_preemption` (tests, an agent
   embedding the process);
3. **SIGTERM**: opt in with ``MXNET_ELASTIC_SIGTERM``
   (:func:`install_sigterm_handler`, lock free; the front half
   survives), so importing the library never takes the signal;
4. **the KV notice**: the key ``mx/elastic/preempt`` on the process
   group's store (:func:`mxnet_tpu_torch.dist._coord_client`), posted by
   :func:`announce` on any rank; a poll that reads it consumes it (the
   key deleted, or tombstoned on a client without delete, and its value
   remembered), so a stale notice never fires after a later grow.

A survivor spec is an integer k (the first k contexts), a comma
separated list of context positions ("0,2,4,6"), or "half".
:func:`consume_kv_notice` is also the serving fleet's drain notice
(``serve/fleet.py``).
"""
from __future__ import annotations

import logging
import threading
from typing import List, Optional, Sequence, Union

from . import config
from . import faultinject
from .base import MXNetError

__all__ = ["request_preemption", "clear", "pending", "poll_survivors",
           "announce", "install_sigterm_handler", "run_transition",
           "consume_kv_notice", "KV_KEY"]

KV_KEY = "mx/elastic/preempt"

_LOCK = threading.Lock()
_NOTICE: List[Optional[str]] = [None]   # the pending survivor spec
# SIGTERM's flag: the handler runs on the main thread and may interrupt
# a holder of _LOCK, so it only assigns this (atomic in CPython) and the
# next poll folds it in under the lock
_SIGTERM_FLAG = [False]
_SIGTERM_INSTALLED = [False]
_KV_CONSUMED: List[Optional[str]] = [None]  # the last KV spec acted on


def _spec_of(survivors: Union[int, str, Sequence[int]]) -> str:
    if isinstance(survivors, str):
        return survivors
    if isinstance(survivors, int):
        return str(int(survivors))
    return ",".join(str(int(i)) for i in survivors)


def request_preemption(survivors: Union[int, str, Sequence[int]]):
    """Raise the in-process notice: ``survivors`` an int (the first k
    contexts survive), a sequence of context positions or a spec string.
    The next poll starts the transition."""
    from . import telemetry
    with _LOCK:
        _NOTICE[0] = _spec_of(survivors)
    telemetry.counter("mx_elastic_preemptions_total",
                      source="request").inc()


def clear():
    """Drop any pending notice (and forget the last KV notice)."""
    with _LOCK:
        _NOTICE[0] = None
    _SIGTERM_FLAG[0] = False
    _KV_CONSUMED[0] = None


def pending() -> bool:
    if _SIGTERM_FLAG[0]:
        return True
    with _LOCK:
        return _NOTICE[0] is not None


def announce(survivors: Union[int, str, Sequence[int]]) -> bool:
    """Post the survivor spec on the process group's store, so every
    rank's poll sees it; False without a group (one process: use
    :func:`request_preemption`)."""
    from . import dist
    client = dist._coord_client()
    if client is None:
        return False
    try:
        client.key_value_set(KV_KEY, _spec_of(survivors),
                             allow_overwrite=True)
        return True
    except Exception as e:
        logging.warning("elastic.announce failed (%s: %s)",
                        type(e).__name__, e)
        return False


def consume_kv_notice(key: str, dedup: List[Optional[str]],
                      client=None) -> Optional[str]:
    """Consume the notice at ``key``: its value, or None when the key is
    absent, empty (a tombstone) or already consumed. A returned notice
    is deleted from the store (tombstoned with an empty value where the
    client has no ``key_value_delete``) and remembered in ``dedup``, a
    1-slot list the caller owns, so it never fires again; a fresh post
    overwrites the key with a new value and fires.

    ``client`` is any client of the coordination-service shape
    (``key_value_try_get`` and ``key_value_set``, optionally
    ``key_value_delete``); by default the process group's store, and
    None outside a group (no notice)."""
    if client is None:
        from . import dist
        client = dist._coord_client()
    if client is None or not hasattr(client, "key_value_try_get"):
        return None
    try:
        val = client.key_value_try_get(key)
        spec = val.decode() if isinstance(val, bytes) else str(val)
    except Exception:
        return None
    if not spec.strip():                   # tombstone / empty key
        return None
    if spec == dedup[0]:                   # already acted on this one
        return None
    dedup[0] = spec
    try:
        delete = getattr(client, "key_value_delete", None)
        if delete is not None:
            delete(key)
        else:
            client.key_value_set(key, "", allow_overwrite=True)
    except Exception as e:
        logging.warning("elastic: could not consume KV notice %r "
                        "(%s: %s); relying on local dedup",
                        key, type(e).__name__, e)
    return spec


def _kv_notice() -> Optional[str]:
    return consume_kv_notice(KV_KEY, _KV_CONSUMED)


def install_sigterm_handler():
    """SIGTERM -> a preemption notice with the default shrink (the front
    half survives); idempotent, main thread only. The previous handler
    still runs."""
    import signal
    if _SIGTERM_INSTALLED[0]:
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            # lock free: the main thread may be inside a _LOCK section
            # (a poll) when the signal arrives
            _SIGTERM_FLAG[0] = True
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)
        _SIGTERM_INSTALLED[0] = True
    except (ValueError, OSError) as e:     # not the main thread
        logging.warning("elastic: SIGTERM handler not installed (%s)", e)


def _parse_spec(spec: str, contexts) -> Optional[list]:
    """The surviving contexts of a spec (their order kept), or None for
    a malformed one."""
    n = len(contexts)
    spec = spec.strip()
    try:
        if spec == "half":
            return list(contexts[:max(1, (n + 1) // 2)])
        if "," in spec:
            idx = [int(s) for s in spec.split(",") if s.strip() != ""]
            if not idx or any(i < 0 or i >= n for i in idx):
                return None
            return [contexts[i] for i in idx]
        k = int(spec)
        if k <= 0:
            return None
        return list(contexts[:min(k, n)])
    except ValueError:
        return None


def poll_survivors(contexts) -> Optional[list]:
    """One poll: the surviving contexts when a notice is pending (it is
    consumed), else None. A malformed spec is logged and dropped: a
    garbled notice must not stop a healthy run."""
    from . import telemetry
    spec = None
    if faultinject.should_fail("slice_preempt"):
        spec = "half"
        telemetry.counter("mx_elastic_preemptions_total",
                          source="slice_preempt").inc()
    if spec is None:
        with _LOCK:
            spec, _NOTICE[0] = _NOTICE[0], None
        if _SIGTERM_FLAG[0]:
            # an explicit pending spec wins; the default is "half"
            _SIGTERM_FLAG[0] = False
            telemetry.counter("mx_elastic_preemptions_total",
                              source="sigterm").inc()
            spec = spec or "half"
    if spec is None:
        spec = _kv_notice()
        if spec is not None:
            telemetry.counter("mx_elastic_preemptions_total",
                              source="kv").inc()
    if spec is None:
        return None
    survivors = _parse_spec(spec, list(contexts))
    if survivors is None:
        logging.warning("elastic: malformed survivor spec %r for %d "
                        "contexts — notice dropped", spec, len(contexts))
        return None
    return survivors


def run_transition(trainer, survivors, restore=None) -> str:
    """One topology transition: the live reshard
    (``Trainer.reshard_to``) first; if it fails (the ``reshard_fail``
    site, a plan mismatch, anything), ``restore(survivors)`` (the
    Estimator's checkpoint restore). Returns ``"live"`` or
    ``"restored"`` and counts ``mx_elastic_transitions_total{kind}``;
    raises only when both fail. Fewer survivors than
    ``MXNET_ELASTIC_MIN_DEVICES`` skip the live attempt."""
    from . import telemetry
    min_dev = max(1, int(config.get("MXNET_ELASTIC_MIN_DEVICES")))
    if len(survivors) >= min_dev:
        try:
            trainer.reshard_to(survivors)
            telemetry.counter("mx_elastic_transitions_total",
                              kind="live").inc()
            return "live"
        except Exception as e:
            logging.warning(
                "elastic: live reshard onto %d devices failed (%s: %s)"
                " — degrading to checkpoint-restore",
                len(survivors), type(e).__name__, e)
            telemetry.counter("mx_elastic_transitions_total",
                              kind="live_failed").inc()
    else:
        logging.warning(
            "elastic: survivor set of %d is below "
            "MXNET_ELASTIC_MIN_DEVICES=%d — degrading to "
            "checkpoint-restore", len(survivors), min_dev)
    if restore is None:
        raise MXNetError(
            "elastic transition failed and no checkpoint-restore path "
            "is available (fit() without ckpt_prefix)")
    restore(survivors)
    telemetry.counter("mx_elastic_transitions_total",
                      kind="restored").inc()
    return "restored"
