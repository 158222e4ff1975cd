"""The distributed kvstore over the process group (counterpart of
``mxnet_tpu/kvstore/dist.py``; ref: src/kvstore/kvstore_dist.h ::
KVStoreDist and p3store_dist.h).

There are no server processes: every process is a worker, and a push is
first the local sum over this process's replicas, then one
``torch.distributed.all_reduce`` of a coalesced bucket (one flat buffer
a device and dtype for all the keys of a call) across the group, on the
backend :mod:`mxnet_tpu_torch.dist` chose (NCCL, or gloo for CPU
contexts and ranks sharing a card). Every rank ends with the same sum.

Modes, all the same synchronous all-reduce:

- ``dist_sync``: MXNet's synchronous reduce;
- ``dist_sync_device`` / ``dist_device_sync``: the same (the sum never
  stages through the host here);
- ``dist_async``: MXNet's asynchronous server updates cannot be a
  collective; the mode is accepted and behaves as ``dist_sync``, a
  stronger consistency, as the reference documents;
- ``p3store_dist``: arrays above ``MXNET_KVSTORE_BIGARRAY_BOUND``
  elements are cut into row slices, each its own collective, the last
  parameters first (ref: p3store_dist.h).

The comms watchdogs: every verb runs under ``MXNET_KVSTORE_TIMEOUT``
with ``MXNET_KVSTORE_RETRIES`` retries (``dist.call_with_deadline``, the
``kv_hang`` fault site), counts ``mx_kvstore_calls_total{verb}`` and
``mx_kvstore_bytes_total{verb,key}``, and times a ``kvstore::<verb>``
span. With ``MXNET_GUARD_COMM_VOTE`` every rank votes its gradients'
finiteness in a one-hot all-reduce before they are summed, and every
rank raises NonFiniteGradientError naming the rank(s) they came from.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import torch

from .. import dist as dist_mod
from ..base import MXNetError  # noqa: F401  (the reference's names)
from ..ndarray import NDArray  # noqa: F401
from . import KVStore, _group_bytes, _nbytes, _normalize, _synchronize
from .base import KVStoreBase

__all__ = ["KVStoreDist", "P3StoreDist"]


class _GlobalReducer:
    """The sum across the process group: one all-reduce a coalesced
    bucket of a (device, dtype)."""

    def allreduce(self, tensors):
        """The group-wide sums of ``tensors`` (new tensors, the inputs
        are not written), in order."""
        import torch.distributed as tdist
        from .. import commwatch, profiler
        nw = dist_mod.num_workers()
        buckets = OrderedDict()
        for i, t in enumerate(tensors):
            buckets.setdefault((t.device, t.dtype), []).append(i)
        out = [None] * len(tensors)
        watching = commwatch.enabled() or profiler.state() == "run"
        # the cross-process sync blocks the step's thread: exposed
        with commwatch.comm_span(
                "allreduce", "kv.dcn" if nw > 1 else "kv",
                _group_bytes([[t] for t in tensors]) if watching else 0,
                nw, exposed=True, key="%d keys" % len(tensors)) as span:
            with torch.no_grad():
                for idx in buckets.values():
                    flat = torch.cat([tensors[i].reshape(-1) for i in idx])
                    tdist.all_reduce(flat)
                    off = 0
                    for i in idx:
                        n = tensors[i].numel()
                        out[i] = flat[off:off + n].view(tensors[i].shape)
                        off += n
            if span.live:
                _synchronize(out)
        return out


@KVStoreBase.register("dist_sync")
@KVStoreBase.register("dist_async")
@KVStoreBase.register("dist_sync_device")
@KVStoreBase.register("dist_device_sync")
@KVStoreBase.register("dist")
class KVStoreDist(KVStore):
    def __init__(self, name: str = "dist_sync"):
        dist_mod.initialize()   # idempotent; the DMLC_* rendezvous
        super().__init__(name)
        self._global = _GlobalReducer()
        self._vote_suppressed = False

    def _check_quantize(self):
        """The quantized wire across processes (MXNET_KVSTORE_QUANTIZE,
        set_gradient_compression on a dist store) is not ported: the
        in-process stores and ZeRO carry it."""
        if self._quant_cfg() is not None:
            raise NotImplementedError(
                "kvstore %s: the quantized wire across processes is not "
                "ported yet (ROADMAP.md queue 1, item 11); the in-process "
                "stores and MXNET_ZERO run it" % self._type)

    @property
    def rank(self) -> int:
        return dist_mod.rank()

    @property
    def num_workers(self) -> int:
        return dist_mod.num_workers()

    @property
    def backend(self) -> str:
        """The group's transport: ``"nccl"`` or ``"gloo"``."""
        return dist_mod.backend()

    def barrier(self, timeout=None):
        """The group's barrier under its watchdog: ``timeout`` seconds (0
        disables it) wins over ``MXNET_BARRIER_TIMEOUT``."""
        dist_mod.barrier(
            tag="kv-%s" % self.type,
            timeout=None if timeout is None else float(timeout))

    # ------------------------------------------------------------------
    # the comms watchdogs
    # ------------------------------------------------------------------
    def _comm_call(self, what, fn):
        from .. import faultinject
        from .. import telemetry
        from ..config import get as _cfg
        if faultinject.active():
            real_fn = fn

            def fn(real_fn=real_fn):
                if faultinject.should_fail("kv_hang"):
                    import threading
                    threading.Event().wait()   # a wedged transport
                return real_fn()
        if telemetry.enabled():
            telemetry.counter("mx_kvstore_calls_total", verb=what).inc()
        with telemetry.span("kvstore::%s" % what, "comm",
                            hist="mx_kvstore_call_seconds", verb=what):
            return dist_mod.call_with_deadline(
                fn, _cfg("MXNET_KVSTORE_TIMEOUT"),
                "%s(%s)" % (what, self.type),
                retries=_cfg("MXNET_KVSTORE_RETRIES"))

    def _record_bytes(self, verb, keys, values):
        """``mx_kvstore_bytes_total{verb,key}``: the bytes of every local
        replica handed to the call (a P3 slice counts under its key)."""
        from .. import telemetry
        if not telemetry.enabled():
            return
        if not isinstance(keys, (list, tuple)):
            keys, values = [keys], [values]
        for k, v in zip(keys, values):
            vals = v if isinstance(v, (list, tuple)) else [v]
            nbytes = sum(_nbytes(a) if isinstance(a, torch.Tensor)
                         else a.size * a.dtype.itemsize for a in vals)
            label = re.sub(r"_p3_\d+$", "_p3", _normalize(k))
            telemetry.counter("mx_kvstore_bytes_total", verb=verb,
                              key=label).inc(nbytes)

    def _vote_enabled(self) -> bool:
        if self._vote_suppressed:
            return False        # the outer call voted (P3 slices)
        from ..config import get as _cfg
        return bool(_cfg("MXNET_GUARD_COMM_VOTE"))

    def _finite_vote(self, values):
        """Each rank's all-finite bit in a one-hot (num_workers,) vector
        summed over the group, so every rank learns which rank(s) hold
        non-finite gradients. A collective: every rank calls it."""
        import torch.distributed as tdist
        from .. import guardrails
        flat = []
        for v in values:
            flat.extend(v if isinstance(v, (list, tuple)) else [v])
        by_dev = OrderedDict()
        for a in flat:
            by_dev.setdefault(a.tensor().device, []).append(a)
        local_ok = all(guardrails.all_finite(arrs)
                       for arrs in by_dev.values())
        nw, me = self.num_workers, self.rank
        dev = torch.device("cuda", dist_mod._PG.card) \
            if self.backend == "nccl" else torch.device("cpu")
        vec = torch.zeros(max(1, nw), dtype=torch.float32, device=dev)
        vec[me] = 1.0 if local_ok else 0.0
        tdist.all_reduce(vec)
        counts = vec.cpu().tolist()
        bad = [r for r in range(nw) if counts[r] == 0]
        if bad:
            guardrails.emit("nonfinite", where="kvstore", ranks=bad,
                            rank=me)
            raise guardrails.NonFiniteGradientError(
                "non-finite gradient(s) detected before the all-reduce: "
                "originating rank(s) %s (this is rank %d/%d; "
                "MXNET_GUARD_COMM_VOTE); the global model was not "
                "corrupted" % (bad, me, nw))

    # every verb goes through the guarded wrapper; the vote (itself a
    # collective that can hang on a dead rank) runs inside the deadline
    def push(self, key, value, priority=0):
        self._record_bytes("push", key, value)

        def _do():
            if self._vote_enabled():
                self._finite_vote(value if isinstance(value, (list, tuple))
                                  else [value])
            return KVStore.push(self, key, value, priority=priority)
        return self._comm_call("push", _do)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is not None:
            self._record_bytes("pull", key, out)
        return self._comm_call(
            "pull", lambda: KVStore.pull(self, key, out=out,
                                         priority=priority,
                                         ignore_sparse=ignore_sparse))

    def pushpull(self, key, value, out=None, priority=0):
        self._record_bytes("pushpull", key, value)

        def _do():
            if self._vote_enabled():
                self._finite_vote(value if isinstance(value, (list, tuple))
                                  else [value])
            return KVStore.pushpull(self, key, value, out=out,
                                    priority=priority)
        return self._comm_call("pushpull", _do)

    def pushpull_list(self, keys, values, outs=None, priority=0):
        self._record_bytes("pushpull", keys, values)

        def _do():
            if self._vote_enabled():
                self._finite_vote(values)
            return self._pushpull_list(keys, values, outs)
        return self._comm_call("pushpull_list", _do)

    def _pushpull_list(self, keys, values, outs=None):
        """Each key's local sum on its first replica's context, then one
        coalesced all-reduce for every key."""
        self._check_quantize()
        keys = [_normalize(k) for k in keys]
        outs = values if outs is None else outs
        vlists = [v if isinstance(v, (list, tuple)) else [v] for v in values]
        olists = [o if isinstance(o, (list, tuple)) else [o] for o in outs]
        locs = [KVStore._reduce_tensors(
            self, [v.tensor().detach() for v in vals],
            vals[0].context.torch_device) for vals in vlists]
        for k, dsts, red in zip(keys, olists, self._global.allreduce(locs)):
            self._write(dsts, red)
            self._commit(k, red)

    def _reduce_tensors(self, ts, dev) -> torch.Tensor:
        # every push is a collective across the group: the local sum,
        # then the group's
        return self._global.allreduce(
            [KVStore._reduce_tensors(self, ts, dev)])[0]


@KVStoreBase.register("p3store_dist")
@KVStoreBase.register("p3store")
class P3StoreDist(KVStoreDist):
    """Priority-based parameter propagation (ref: src/kvstore/
    p3store_dist.h): an array above ``MXNET_KVSTORE_BIGARRAY_BOUND``
    elements is cut into row slices under the bound, each its own
    collective, the tail parameters (whose gradients backward writes
    first) first."""

    def __init__(self, name: str = "p3store_dist"):
        super().__init__(name)
        from ..config import get as _cfg
        self._bigarray_bound = int(_cfg("MXNET_KVSTORE_BIGARRAY_BOUND"))

    def pushpull_list(self, keys, values, outs=None, priority=0):
        # one vote over the whole arrays (under a deadline), none for
        # the slices
        if self._vote_enabled():
            self._comm_call("finite_vote",
                            lambda: self._finite_vote(values))
        self._vote_suppressed = True
        try:
            return self._pushpull_list_chunked(keys, values, outs)
        finally:
            self._vote_suppressed = False

    def _pushpull_list_chunked(self, keys, values, outs=None):
        outs = values if outs is None else outs
        vlists = [v if isinstance(v, (list, tuple)) else [v]
                  for v in values]
        olists = [o if isinstance(o, (list, tuple)) else [o] for o in outs]
        for i in reversed(range(len(keys))):   # the tail first
            k, vals, dsts = _normalize(keys[i]), vlists[i], olists[i]
            size = vals[0].size
            if size <= self._bigarray_bound or vals[0].ndim == 0 \
                    or vals[0].shape[0] < 2:
                KVStoreDist.pushpull_list(self, [k], [vals], [dsts])
                continue
            rows = vals[0].shape[0]
            per_row = max(1, size // rows)
            chunk_rows = max(1, self._bigarray_bound // per_row)
            srcs = [v.tensor().detach() for v in vals]
            dev = vals[0].context.torch_device
            for s in range(0, rows, chunk_rows):
                e = min(rows, s + chunk_rows)
                ck = "%s_p3_%d" % (k, s)
                chunk = [t[s:e] for t in srcs]
                self._record_bytes("pushpull", ck, chunk)

                def _do(chunk=chunk, s=s, e=e):
                    red = self._reduce_tensors(chunk, dev)
                    with torch.no_grad():
                        for d in dsts:
                            d.tensor()[s:e].copy_(red)
                self._comm_call("pushpull_list", _do)
            # the slices bypass the store: refresh (or create) its entry
            # from the reduced result, so a later pull sees it
            store = self._store.get(k)
            if store is None:
                self._store[k] = dsts[0].copy()
            else:
                self._commit(k, dsts[0].tensor().detach())

