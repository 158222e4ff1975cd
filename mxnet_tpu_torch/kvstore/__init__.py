"""KVStore: parameter synchronisation (counterpart of
``mxnet_tpu/kvstore/__init__.py``; ref: src/kvstore/ KVStoreLocal,
comm.h, kvstore_nccl.h, and python/mxnet/kvstore/).

``create("local" | "device" | "nccl")`` makes the in-process store;
``nccl`` is MXNet 1.x's name for the grouped reduce and the counterpart
of the reference's ``tpu``. ``dist_*`` and ``p3store_dist`` join the
process group (:mod:`.dist`), ``horovod`` loads the plugin
(:mod:`.horovod`).

How a key's replicas are summed (the reference's ``_reduce`` and
``pushpull_list``):

- replicas on distinct CUDA devices take one grouped NCCL all-reduce
  for the whole group of keys: one coalesced flat buffer per device and
  dtype, summed in place by ``torch.cuda.nccl.all_reduce`` and split
  back (:class:`_CollectiveReducer`);
- replicas that share a device, or mix the CPU and CUDA, are summed in
  order on the store's context (the reference's tree-sum).

A reduced value is committed on the store entry's context, written into
the entry's own tensor, so no store entry aliases a caller's gradient.

The quantized wire (``MXNET_KVSTORE_QUANTIZE``, or
``set_gradient_compression``, which routes every compression type to
int8): ``pushpull_list`` sums the float keys whose replicas lie on
distinct contexts through :func:`~..parallel.quantize.quantized_allreduce`
over a mesh of those contexts, one flat buffer a device set, with an
error-feedback residual a device (the carried rounding error, added into
the next step's input). ``quant_residuals_export`` sums them by key for a
checkpoint and ``quant_residuals_restore`` splits them back at the next
reduce. ``row_sparse_pull`` waits for the sparse arrays (ROADMAP.md queue
1, item 16) and raises.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from .base import KVStoreBase

__all__ = ["KVStore", "KVStoreBase", "create"]


def _normalize(key):
    return str(key)


# set_gradient_compression's deprecation warning, once a process
_COMPRESSION_WARNED = False


def _quantizable(t: torch.Tensor) -> bool:
    """Float payloads of at most 32 bits ride the quantized wire (f64
    would lose range; integer gradients are exact by contract)."""
    return t.dtype.is_floating_point and torch.finfo(t.dtype).bits <= 32


def _not_ported(what, item):
    return NotImplementedError("kvstore: %s is not ported yet (ROADMAP.md "
                               "queue 1, item %d)" % (what, item))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_bytes(groups) -> int:
    """The logical all-reduce payload: one replica buffer a key (the
    reduced size, NCCL-tests' message-size convention)."""
    return sum(_nbytes(g[0]) for g in groups)


def _synchronize(tensors):
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)


def coalesced_allreduce(groups, allreduce):
    """Sum ``groups[k][d]`` (key k's replica on device d, the same device
    order for every key) through one flat buffer per device and dtype:
    the keys of a dtype are concatenated on each device, ``allreduce``
    sums the list of per-device buffers in place, and each key's slice
    comes back as a view of its device's buffer. Returns the per-key
    lists of per-device results; the inputs are not written."""
    ndev = len(groups[0])
    by_dtype: Dict[torch.dtype, List[int]] = OrderedDict()
    for k, reps in enumerate(groups):
        by_dtype.setdefault(reps[0].dtype, []).append(k)
    results = [[None] * ndev for _ in groups]
    for idx in by_dtype.values():
        flats = [torch.cat([groups[k][d].reshape(-1) for k in idx])
                 for d in range(ndev)]
        allreduce(flats)
        for d in range(ndev):
            off = 0
            for k in idx:
                n = groups[k][d].numel()
                results[k][d] = flats[d][off:off + n].view(
                    groups[k][d].shape)
                off += n
    return results


def _nccl_allreduce(flats):
    """Sum per-device buffers in place with one in-process NCCL
    all-reduce (ref: kvstore_nccl.h's grouped ncclAllReduce). NCCL is
    required: there is no other transport to fall back to."""
    from torch.cuda import nccl
    if not nccl.is_available(flats):
        raise MXNetError("kvstore: the grouped reduce across %d CUDA "
                         "devices needs NCCL, which this torch build "
                         "cannot run on them" % len(flats))
    nccl.all_reduce(flats)


class _CollectiveReducer:
    """The grouped reduce over the CUDA devices that hold a key's
    replicas: every key of the group in one coalesced NCCL all-reduce a
    dtype, every device receiving the sum."""

    # commwatch's axis: the in-process reduce across this process's
    # contexts
    _comm_axis = "kv"

    def __init__(self, allreduce=None):
        self._allreduce = allreduce or _nccl_allreduce

    def reduce_groups(self, groups):
        """``groups``: per-key lists of tensors, one a distinct CUDA
        device, the same device order for every key. Returns the per-key
        lists of per-device sums."""
        ndev = len(groups[0])
        if ndev == 1:
            return [[g[0]] for g in groups]
        from .. import commwatch, profiler
        watching = commwatch.enabled() or profiler.state() == "run"
        with commwatch.comm_span(
                "allreduce", self._comm_axis,
                _group_bytes(groups) if watching else 0, ndev,
                key="%d keys" % len(groups)) as span:
            with torch.no_grad():
                results = coalesced_allreduce(
                    [[t.detach() for t in g] for g in groups],
                    self._allreduce)
            if span.live:
                # the span times the collective's completion
                _synchronize([r for rs in results for r in rs])
        return results


def _distinct_cuda(tensors) -> bool:
    devs = [t.device for t in tensors]
    return len(devs) > 1 and all(d.type == "cuda" for d in devs) and \
        len(set(devs)) == len(devs)


@KVStoreBase.register("local")
@KVStoreBase.register("device")
@KVStoreBase.register("nccl")
class KVStore(KVStoreBase):
    """In-process key-value store (ref: KVStoreLocal::PushImpl sums each
    key's replica list; KVStoreNCCL groups the keys into one
    collective)."""

    def __init__(self, name: str = "local"):
        self._type = name
        self._store: Dict[str, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer = None
        self._reducer = _CollectiveReducer()
        self._compression = None          # (type, threshold)
        self._quant_state: Dict = {}      # (keys, contexts) -> residuals
        self._quant_restore: Dict = {}    # key -> numpy residual
        self._quant_step = 0              # stochastic-rounding seed clock

    # ------------------------------------------------------------------
    def set_gradient_compression(self, compression_params):
        """MXNet 1.x's gradient compression (ref:
        src/kvstore/gradient_compression.cc). Every type is served by the
        int8 quantized wire with error feedback
        (:mod:`..parallel.quantize`), as in the reference: the legacy
        ``threshold`` is accepted and ignored, with one FutureWarning a
        process. ``MXNET_KVSTORE_QUANTIZE`` is the native spelling."""
        ctype = compression_params.get("type", "2bit")
        if ctype not in ("1bit", "2bit"):
            raise MXNetError("unsupported compression type %r" % ctype)
        global _COMPRESSION_WARNED
        if not _COMPRESSION_WARNED:
            _COMPRESSION_WARNED = True
            import warnings
            warnings.warn(
                "set_gradient_compression(type=%r) now rides the int8 "
                "quantized collectives with error feedback "
                "(MXNET_KVSTORE_QUANTIZE); the legacy threshold parameter "
                "is ignored" % ctype, FutureWarning, stacklevel=2)
        self._compression = (ctype,
                             float(compression_params.get("threshold", 0.5)))

    def _quant_cfg(self):
        """The wire's configuration: the environment's, or int8 when
        set_gradient_compression asked for it; None for the f32 wire."""
        from ..parallel import quantize as qz
        cfg = qz.from_env()
        if cfg is None and self._compression is not None:
            cfg = qz.QuantConfig()
        return cfg

    def quant_residuals_export(self) -> Dict[str, Any]:
        """``{store key: residual}`` (flat numpy): each key's residuals
        summed over the devices (the carry conserves the sum)."""
        import numpy as np
        out: Dict[str, Any] = {}
        for ent in self._quant_state.values():
            total = None
            for r in ent["res"]:
                a = r.detach().cpu().numpy().astype(np.float32)
                total = a if total is None else total + a
            off = 0
            for k, size in zip(ent["keys"], ent["sizes"]):
                out[k] = total[off:off + size].copy()
                off += size
        return out

    def quant_residuals_restore(self, residuals: Dict[str, Any]):
        """Queue checkpointed residuals for the next grouped reduce (the
        group's layout is known only then)."""
        self._quant_state.clear()
        self._quant_restore = dict(residuals or {})

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # ------------------------------------------------------------------
    def init(self, key, value):
        keys, values = self._key_value(key, value)
        for k, v in zip(keys, values):
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._store[k] = vv.copy()

    def _commit(self, key, t: torch.Tensor):
        """Write a reduced value into the store entry ``key`` on the
        entry's context (a missing entry stays missing)."""
        store = self._store.get(key)
        if store is None:
            return
        with torch.no_grad():
            store.tensor().copy_(t)

    @staticmethod
    def _write(dsts, t: torch.Tensor):
        """Copy ``t`` into each destination array, in place (gradient
        buffers stay the arrays autograd writes)."""
        with torch.no_grad():
            for d in dsts:
                dt = d.tensor()
                if dt.device != t.device or dt.data_ptr() != t.data_ptr():
                    dt.copy_(t)

    def push(self, key, value, priority=0):
        keys, values = self._key_value(key, value)
        for k, v in zip(keys, values):
            vals = v if isinstance(v, (list, tuple)) else [v]
            if k not in self._store:
                raise MXNetError("key %s not initialized in kvstore" % k)
            target = self._store[k]
            reduced = self._reduce(vals, target.context, key=k)
            self._apply(k, reduced, target)

    def _apply(self, k, reduced: torch.Tensor, target: NDArray):
        """A pushed sum into the store: through the updater (the
        optimizer on the store) or written as the new value."""
        if self._updater is not None:
            # the store's key (a string, as in the reference) is the
            # updater's index, so the states blob is the reference's
            self._updater(k, NDArray(reduced, target.context), target)
        else:
            with torch.no_grad():
                target.tensor().copy_(reduced)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._key_value(key, out)
        for k, o in zip(keys, outs):
            src = self._store.get(k)
            if src is None:
                raise MXNetError("key %s not initialized in kvstore" % k)
            self._write(o if isinstance(o, (list, tuple)) else [o],
                        src.tensor().detach())

    def pushpull(self, key, value, out=None, priority=0):
        """Sum then broadcast (ref: KVStoreBase.pushpull); the store is
        not written."""
        keys, values = self._key_value(key, value)
        _, outs = self._key_value(key, out if out is not None else value)
        for k, v, o in zip(keys, values, outs):
            vals = v if isinstance(v, (list, tuple)) else [v]
            red = self._reduce(vals, vals[0].context, key=k)
            self._write(o if isinstance(o, (list, tuple)) else [o], red)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Sparse rows of a store entry: refused with the sparse
        arrays."""
        raise _not_ported("row_sparse_pull (sparse arrays)", 16)

    # ------------------------------------------------------------------
    def set_optimizer(self, optimizer):
        """The optimizer on the store: a pushed sum updates the stored
        weight."""
        from .. import optimizer as opt_mod
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def is_capable(self, capability: str) -> bool:
        return {"optimizer": True}.get(capability, False)

    def _set_updater(self, updater):
        self._updater = updater

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # ------------------------------------------------------------------
    def pushpull_list(self, keys, values, outs=None, priority=0):
        """Sum many keys at once: the keys whose replicas lie on distinct
        CUDA devices in one grouped reduce per device set, the others
        key by key on their first replica's context. Results go into
        ``outs`` (default ``values``) and into the store. With the
        quantized wire on, the float keys whose replicas lie on distinct
        contexts go through one quantized all-reduce a context set
        instead."""
        keys = [_normalize(k) for k in keys]
        outs = values if outs is None else outs
        vlists = [v if isinstance(v, (list, tuple)) else [v] for v in values]
        olists = [o if isinstance(o, (list, tuple)) else [o] for o in outs]
        cfg = self._quant_cfg()
        by_sig: Dict[tuple, list] = OrderedDict()
        by_ctx: Dict[tuple, list] = OrderedDict()
        for i, vals in enumerate(vlists):
            ts = [v.tensor() for v in vals]
            ctxs = tuple(v.context for v in vals)
            if cfg is not None and len(vals) > 1 and \
                    len(set(ctxs)) == len(ctxs) and _quantizable(ts[0]):
                by_ctx.setdefault(ctxs, []).append(i)
            elif _distinct_cuda(ts):
                by_sig.setdefault(tuple(t.device for t in ts), []).append(i)
            else:
                red = self._reduce(vals, vals[0].context, key=keys[i])
                self._write(olists[i], red)
                self._commit(keys[i], red)
        for idx in by_sig.values():
            results = self._reducer.reduce_groups(
                [[v.tensor() for v in vlists[i]] for i in idx])
            for i, reps in zip(idx, results):
                self._place(olists[i], keys[i], reps)
        for ctxs, idx in by_ctx.items():
            results = self._quant_reduce(
                ctxs, [[v.tensor() for v in vlists[i]] for i in idx],
                [keys[i] for i in idx], cfg)
            for i, reps in zip(idx, results):
                self._place(olists[i], keys[i], reps)
        return None

    def _quant_reduce(self, ctxs, groups, keys, cfg):
        """The quantized grouped all-reduce of ``groups`` (per key, one
        replica a context of ``ctxs``): each context's keys concatenated
        into one flat f32 buffer, its residual added, the quantized
        all-reduce run over a mesh of the contexts (one thread a
        context), the new residual kept and the sums split back. Returns
        the per-key lists of per-context sums, in the keys' dtypes."""
        import numpy as np
        from .. import commwatch
        from ..parallel import _spmd
        from ..parallel import quantize as qz
        qz.note_active(cfg)
        n = len(ctxs)
        sizes = [g[0].numel() for g in groups]
        S = int(sum(sizes))
        rkey = (tuple(keys), ctxs)
        ent = self._quant_state.get(rkey)
        if ent is None:
            base = np.zeros(S, np.float32)
            off = 0
            for k, size in zip(keys, sizes):
                pend = self._quant_restore.pop(k, None)
                if pend is not None:
                    # a checkpoint holds the sum over the devices: split
                    # back evenly, so the round trip keeps the sum
                    base[off:off + size] = np.asarray(
                        pend, np.float32).reshape(-1) / n
                off += size
            ent = {"res": [torch.from_numpy(base).to(c.torch_device)
                           for c in ctxs],
                   "keys": tuple(keys), "sizes": tuple(sizes)}
            self._quant_state[rkey] = ent
        seed = None
        if cfg.stochastic and cfg.mode == "int8":
            self._quant_step += 1
            seed = self._quant_step
        mesh, axis = self._quant_mesh(ctxs)

        def body(m):
            p = m.pos
            with torch.no_grad():
                flat = torch.cat([g[p].detach().reshape(-1).float()
                                  for g in groups]) \
                    if len(groups) > 1 else \
                    groups[0][p].detach().reshape(-1).float()
                out, new_res = qz.quantized_allreduce(
                    flat, axis, None, cfg, residual=ent["res"][p],
                    key=seed)
                ent["res"][p] = new_res
                res, off = [], 0
                for g, size in zip(groups, sizes):
                    res.append(out[off:off + size].reshape(g[p].shape)
                               .to(g[p].dtype))
                    off += size
                return res
        with commwatch.program_watch(("kv.quant", ctxs, tuple(sizes)),
                                     "kv.quant_reduce", exposed=True):
            run = _spmd.Run(mesh, collector=commwatch.current_collector())
            per_dev = run.execute(body)
            if commwatch.enabled():
                _synchronize([t for r in per_dev for t in r])
        return [[per_dev[p][k] for p in range(n)]
                for k in range(len(groups))]

    def _quant_mesh(self, ctxs):
        """``(mesh, axis)`` the quantized reduce runs over: the replica
        contexts on one axis, ``kv`` (its commwatch label)."""
        from ..parallel.mesh import contexts_mesh
        return contexts_mesh(ctxs, ("kv",)), "kv"

    def _place(self, dsts, key, reps):
        """Write a grouped reduce's per-device results: each destination
        and the store entry from the replica on its own device when
        there is one."""
        by_dev = {r.device: r for r in reps}
        with torch.no_grad():
            for d in dsts:
                dt = d.tensor()
                dt.copy_(by_dev.get(dt.device, reps[0]))
            store = self._store.get(key)
            if store is not None:
                st = store.tensor()
                st.copy_(by_dev.get(st.device, reps[0]))

    def _reduce(self, vals: List[NDArray], ctx, key=None) -> torch.Tensor:
        """The sum of a key's replicas as a tensor on ``ctx``'s device
        (one replica on that device comes back as its own tensor)."""
        return self._reduce_tensors([v.tensor().detach() for v in vals],
                                    ctx.torch_device)

    def _reduce_tensors(self, ts, dev) -> torch.Tensor:
        """:meth:`_reduce` on tensors."""
        if len(ts) == 1:
            return ts[0] if ts[0].device == dev else ts[0].to(dev)
        if _distinct_cuda(ts):
            reps = self._reducer.reduce_groups([ts])[0]
            for r in reps:
                if r.device == dev:
                    return r
            return reps[0].to(dev)
        # replicas share a device or mix the CPU and CUDA: summed in
        # order on the store's context
        with torch.no_grad():
            out = ts[0].to(dev)
            for t in ts[1:]:
                out = out + t.to(dev)
        return out

    @staticmethod
    def _key_value(key, value):
        if isinstance(key, (list, tuple)):
            return [_normalize(k) for k in key], list(value)
        return [_normalize(key)], [value]


def create(name: str = "local") -> KVStoreBase:
    """A kvstore by name (ref: kvstore.create): ``local``, ``device`` and
    ``nccl`` in process; ``dist_sync``, ``dist_async``,
    ``dist_sync_device``, ``dist_device_sync`` and ``p3store_dist`` join
    the process group (the ``DMLC_*`` rendezvous of
    :mod:`mxnet_tpu_torch.dist`); ``horovod`` needs horovod."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name.startswith("dist") or name.startswith("p3"):
        from . import dist as _dist  # noqa: F401  (registers the stores)
    elif name == "horovod":
        from . import horovod as _hvd  # noqa: F401
    kls = KVStoreBase.get(name)
    if kls is None:
        raise MXNetError("unknown kvstore type %r" % name)
    import inspect
    try:
        takes_name = len(inspect.signature(kls).parameters) >= 1
    except (TypeError, ValueError):
        takes_name = False
    return kls(name) if takes_name else kls()
