"""KV notices, consumed on read (counterpart of the notice half of
``mxnet_tpu/elastic.py``).

:func:`consume_kv_notice` is the notice semantics the serving fleet's
drain uses (``serve/fleet.py``): a replica polls its drain key, and a
notice it reads is consumed (the key deleted, or tombstoned on a client
without delete) and remembered, so a stale notice never fires twice. A
notice is posted by writing its key (``ReplicaManager.drain``).

The rest of the reference's module, preemption notices and the live
transition onto the surviving devices, waits with multi-GPU
(ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import logging
from typing import List, Optional

__all__ = ["consume_kv_notice", "KV_KEY"]

KV_KEY = "mx/elastic/preempt"


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
    ``key_value_delete``). Without one (the process group's own store
    waits with item 11) there is no notice."""
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
