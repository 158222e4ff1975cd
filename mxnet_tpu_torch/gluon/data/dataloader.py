"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
ref: python/mxnet/gluon/data/dataloader.py).

Three paths, as in the reference: ``num_workers=0`` loads in the calling
thread; ``num_workers > 0`` forks worker processes that batchify in
parallel and hand each batch back in one POSIX shared-memory segment;
``thread_pool=True`` batchifies in one worker thread. Errors in a worker
surface in the consumer. A worker that dies is respawned, up to
``MXNET_DATALOADER_RESTARTS`` a epoch; past that the loader warns and
loads the rest of the epoch in-process.

A forked child of a process that has initialised CUDA must never touch
CUDA: a worker runs with the CPU as its current context and one torch
thread, and the chain it runs must be numpy only. Before the first fork
the loader probes one sample in the parent; a chain that yields NDArrays
(the Gluon vision transforms do) goes to the threaded prefetcher with a
warning, as in the reference. The parent copies each segment into
page-locked memory when the batches go to a card, and unlinks it.

Batches land on the context current when the iteration starts (the card
by default). With ``MXNET_PREFETCH_DEPTH`` above 0 (the default is 2),
batches are made on the host and up to that many ahead of the consumer
are staged onto that context, onto a card by non-blocking copies from
pinned memory, so their upload overlaps the steps before them. Each
wait of the consumer for its next batch is a ``dataloader::next`` span
(``mx_dataloader_batch_seconds``), each read-ahead batch a
``dataloader::prefetch`` span, as in the reference; the end of the epoch
is not a batch and records nothing.
"""
from __future__ import annotations

import glob
import multiprocessing
import os
import queue
import secrets
import threading
import traceback
import warnings
from collections import deque
from typing import List

import numpy as np
import torch

from ... import config
from ... import faultinject
from ... import ndarray as nd
from ... import telemetry
from ...context import Context, cpu, current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch on the current context (ref:
    dataloader.py :: default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return nd.invoke("stack", list(data), {})
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype if data.dtype != np.float64
                    else np.float32)


def default_mp_batchify_fn(data):
    """Worker-side batchify: stacks into numpy, which the worker packs
    into one shared-memory segment (ref: dataloader.py ::
    default_mp_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], np.ndarray):
        return np.stack(data)
    if isinstance(data[0], tuple):
        return [default_mp_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return data.astype(np.float32) if data.dtype == np.float64 else data


def _stage(batch, ctx):
    """``batch`` with every NDArray leaf not on ``ctx`` copied there
    without blocking the host (pinned source, copy on the current
    stream)."""
    if isinstance(batch, NDArray):
        if batch.context == ctx:
            return batch
        dev = ctx.torch_device          # raises for a card that is absent
        t = batch.tensor().pin_memory()
        return NDArray(t.to(dev, non_blocking=True), ctx)
    if isinstance(batch, (list, tuple)):
        out = [_stage(b, ctx) for b in batch]
        return tuple(out) if isinstance(batch, tuple) else out
    if isinstance(batch, dict):
        return {k: _stage(v, ctx) for k, v in batch.items()}
    return batch


# ---------------------------------------------------------------------------
# shared-memory batch transport
# ---------------------------------------------------------------------------
# the port's segments under /dev/shm, apart from Python's own psm_ ones
SHM_PREFIX = "mxt_dl_"

def _flatten_batch(batch, leaves):
    """The batch's tree with its array leaves replaced by their index in
    ``leaves``, where they are collected in order."""
    if isinstance(batch, NDArray):
        leaves.append(np.ascontiguousarray(batch.asnumpy()))
        return ("leaf", len(leaves) - 1)
    if isinstance(batch, np.ndarray):
        leaves.append(np.ascontiguousarray(batch))
        return ("leaf", len(leaves) - 1)
    if isinstance(batch, (list, tuple)):
        return ("seq", type(batch) is tuple,
                [_flatten_batch(b, leaves) for b in batch])
    if isinstance(batch, dict):
        return ("dict", [(k, _flatten_batch(v, leaves))
                         for k, v in batch.items()])
    return ("py", batch)   # scalars and strings ride the queue


def _rebuild(tree, arrays):
    kind = tree[0]
    if kind == "leaf":
        return arrays[tree[1]]
    if kind == "seq":
        out = [_rebuild(c, arrays) for c in tree[2]]
        return tuple(out) if tree[1] else out
    if kind == "dict":
        return {k: _rebuild(c, arrays) for k, c in tree[1]}
    return tree[1]


def _pack_shm(batch):
    """Worker side: every array leaf of ``batch`` into ONE segment, at
    64-byte aligned offsets; returns (segment name, tree, leaf meta).
    The segments are named ``SHM_PREFIX`` + pid + random hex."""
    from multiprocessing import resource_tracker, shared_memory

    leaves: List[np.ndarray] = []
    tree = _flatten_batch(batch, leaves)
    offs, total = [], 0
    for a in leaves:
        total = (total + 63) // 64 * 64
        offs.append(total)
        total += a.nbytes
    shm = shared_memory.SharedMemory(
        name="%s%d_%s" % (SHM_PREFIX, os.getpid(), secrets.token_hex(6)),
        create=True, size=max(total, 1))
    for a, off in zip(leaves, offs):
        np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)[...] = a
    meta = [(off, a.shape, a.dtype.str) for a, off in zip(leaves, offs)]
    name = shm.name
    shm.close()
    # the parent owns the segment from here (it unlinks it once it has
    # its copy): this process's resource tracker must not unlink it too
    resource_tracker.unregister("/" + name, "shared_memory")
    return name, tree, meta


def _unlink_segments_of(pids):
    """Unlink the segments that the worker processes ``pids``, all gone,
    created and never handed over (Linux lists them under /dev/shm)."""
    from multiprocessing import shared_memory

    for pid in pids:
        for path in glob.glob("/dev/shm/%s%d_*" % (SHM_PREFIX, pid)):
            try:
                shm = shared_memory.SharedMemory(name=os.path.basename(path))
            except FileNotFoundError:
                continue
            shm.close()
            shm.unlink()


def _host_array(arr, pin):
    """A CPU NDArray holding a copy of ``arr``, in page-locked memory
    when ``pin`` (the batch goes on to a card)."""
    src = torch.from_numpy(arr)
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
    out.copy_(src)
    return NDArray(out, cpu())


def _unpack_shm(name, tree, meta, pin=False):
    """Parent side: copy each leaf out of the segment into a CPU
    NDArray, then close and unlink the segment."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    try:
        arrays = []
        for off, shape, dtype in meta:
            view = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf,
                              offset=off)
            arrays.append(_host_array(view, pin))
            del view            # no export of the mapping may outlive it
    finally:
        shm.close()
        shm.unlink()
    return _rebuild(tree, arrays)


def _host_batch(batch, pin):
    """A worker-side batch made in-process, its numpy leaves as CPU
    NDArrays: what ``_unpack_shm`` gives for the same batch."""
    leaves: List[np.ndarray] = []
    tree = _flatten_batch(batch, leaves)
    return _rebuild(tree, [_host_array(a, pin) for a in leaves])


def _worker_loop(dataset, batchify_fn, task_q, res_q, seed, generation=0):
    """Worker process body (ref: dataloader.py :: worker_loop).
    ``generation`` counts respawn rounds: 0 for the first workers, which
    fire the ``dl_worker`` fault site, ``dl_worker_respawn`` after."""
    # a forked child of a CUDA process: nothing here may touch the card
    Context._default.stack = [cpu()]
    torch.set_num_threads(1)
    if seed is not None:
        np.random.seed(seed)
    site = "dl_worker" if generation == 0 else "dl_worker_respawn"
    while True:
        task = task_q.get()
        if task is None:
            break
        if faultinject.should_fail(site):
            os._exit(1)   # a simulated OOM kill: no result, no cleanup
        seq, indices = task
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            res_q.put((seq, "ok", _pack_shm(batch)))
        except Exception:
            res_q.put((seq, "err", traceback.format_exc()))


def _walk_ndarray(v):
    if isinstance(v, NDArray):
        return True
    if isinstance(v, (list, tuple)):
        return any(_walk_ndarray(x) for x in v)
    if isinstance(v, dict):
        return any(_walk_ndarray(x) for x in v.values())
    return False


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        self._dataset = dataset
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be set if sampler is given")
            if last_batch is None:
                last_batch = "keep"
            batch_sampler = BatchSampler(sampler, batch_size, last_batch)
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch must not be set "
                "if batch_sampler is given")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._mp = (self._num_workers > 0 and not thread_pool
                    and hasattr(os, "fork"))
        self._fork_safe_cache = None
        self._default_batchify = batchify_fn is None
        if batchify_fn is None:
            batchify_fn = default_mp_batchify_fn if self._mp \
                else default_batchify_fn
        self._batchify_fn = batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices, ctx):
        with ctx:
            return self._batchify_fn([self._dataset[i] for i in indices])

    def _iter_threaded(self, batches, ctx):
        out_q: "queue.Queue" = queue.Queue(maxsize=max(self._prefetch, 2))
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            # an error in the dataset or batchify surfaces in the consumer
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    put(("ok", self._make_batch(batch_idx, ctx)))
            except Exception:
                put(("err", traceback.format_exc()))
            else:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get(timeout=self._timeout)
                if item is None:
                    break
                status, payload = item
                if status == "err":
                    raise RuntimeError(
                        "DataLoader worker failed:\n%s" % payload)
                yield payload
        finally:
            stop.set()
            t.join(timeout=1.0)

    def _iter_multiprocess(self, batches, ctx, pin):
        """Batches from forked workers in sampler order (a reorder buffer
        holds those that come early), each copied out of its segment and
        staged onto ``ctx``; dead workers respawned within the restart
        budget, then the rest loaded in-process (ref: dataloader.py ::
        _iter_multiprocess)."""
        if ctx.device_type == "gpu":
            ctx.torch_device                # raises for a card that is absent
        mp = multiprocessing.get_context("fork")
        task_q = mp.Queue()
        res_q = mp.Queue()
        seed_base = np.random.randint(0, 2 ** 31 - 1)
        generation = [0]
        spawned = [0]   # a replacement never reuses a live worker's seed
        pids = []

        def spawn():
            i = spawned[0]
            spawned[0] += 1
            w = mp.Process(target=_worker_loop,
                           args=(self._dataset, self._batchify_fn, task_q,
                                 res_q, seed_base + i, generation[0]),
                           daemon=True)
            # Python 3.12 warns when a process with other threads forks
            # (CUDA's, torch's pool, the queue's feeder): a lock one of
            # them holds stays locked in the child. The child takes none
            # of theirs: it runs the numpy chain, the pickler and its own
            # queue thread, never CUDA or torch's pool.
            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "ignore", message=r".*use of fork\(\) may lead to "
                    r"deadlocks", category=DeprecationWarning)
                w.start()
            pids.append(w.pid)
            return w

        def unpack(payload):
            return _stage(_unpack_shm(*payload, pin=pin), ctx)

        workers = [spawn() for _ in range(self._num_workers)]
        n = len(batches)
        inflight_cap = self._num_workers + self._prefetch
        pending = {}   # seq -> batch that came before its turn
        sent = 0
        max_restarts = max(0, config.get("MXNET_DATALOADER_RESTARTS"))
        restarts = 0
        degraded = False
        try:
            while sent < min(inflight_cap, n):
                task_q.put((sent, batches[sent]))
                sent += 1
            want = 0
            waited = 0.0
            while want < n:
                if degraded:
                    # the pool is gone: what already came, then the rest
                    # loaded in-process
                    yield pending.pop(want) if want in pending else \
                        _stage(_host_batch(self._make_batch(
                            batches[want], cpu()), pin), ctx)
                    want += 1
                    continue
                if want in pending:
                    if sent < n:
                        task_q.put((sent, batches[sent]))
                        sent += 1
                    yield pending.pop(want)
                    want += 1
                    waited = 0.0
                    continue
                try:
                    seq, status, payload = res_q.get(timeout=1.0)
                except queue.Empty:
                    dead = [w for w in workers if not w.is_alive()]
                    if not dead:
                        waited += 1.0
                        if self._timeout and waited >= self._timeout:
                            raise RuntimeError(
                                "DataLoader batch %d not produced within "
                                "timeout=%ss (worker alive but stuck)"
                                % (want, self._timeout))
                        continue
                    codes = [w.exitcode for w in dead]
                    workers = [w for w in workers if w.is_alive()]
                    restarts += len(dead)
                    if restarts > max_restarts:
                        warnings.warn(
                            "DataLoader: worker process(es) died "
                            "(exitcodes %s) and the restart budget "
                            "(MXNET_DATALOADER_RESTARTS=%d) is spent; "
                            "degrading to in-process loading for the "
                            "rest of this epoch" % (codes, max_restarts),
                            RuntimeWarning)
                        # keep what already came, then retire the pool
                        try:
                            while True:
                                seq, status, payload = res_q.get_nowait()
                                if status == "ok":
                                    b = unpack(payload)
                                    if seq >= want and seq not in pending:
                                        pending[seq] = b
                        except queue.Empty:
                            pass
                        for w in workers:
                            w.terminate()
                        degraded = True
                        continue
                    generation[0] += 1
                    warnings.warn(
                        "DataLoader: respawning %d dead worker(s) "
                        "(exitcodes %s; restart %d of %d)"
                        % (len(dead), codes, restarts, max_restarts),
                        RuntimeWarning)
                    for _ in range(len(dead)):
                        workers.append(spawn())
                    # the dead worker's task is unknown: resend every batch
                    # in flight; duplicates are dropped below
                    for i in range(want, sent):
                        if i not in pending:
                            task_q.put((i, batches[i]))
                    waited = 0.0
                    continue
                if status == "err":
                    raise RuntimeError(
                        "DataLoader worker failed:\n%s" % payload)
                if seq < want or seq in pending:
                    _unpack_shm(*payload)   # a duplicate: free its segment
                    continue
                pending[seq] = unpack(payload)
                waited = 0.0
        finally:
            for _ in workers:
                try:
                    task_q.put_nowait(None)
                except Exception:
                    pass
            for w in workers:
                w.join(timeout=1.0)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=1.0)
            # free the segments of batches made after the consumer stopped
            try:
                while True:
                    seq, status, payload = res_q.get_nowait()
                    if status == "ok":
                        _unpack_shm(*payload)
            except Exception:
                pass
            # and those whose worker died before its result left the
            # process (a crash kills the queue's feeder thread with it)
            _unlink_segments_of(pids)

    def _fork_safe(self, batches):
        """Whether the chain may run in forked workers: one sample,
        ``batches[0][0]``, made in the parent before the first fork, must
        hold no NDArray (a child of a CUDA process must not touch the
        card). Cached: the chain is fixed at construction. A chain of
        NDArrays goes to the threaded prefetcher with a warning (ref:
        dataloader.py :: _fork_safe)."""
        if self._fork_safe_cache is not None:
            return self._fork_safe_cache
        try:
            sample = self._dataset[batches[0][0]] if batches else None
            safe = not _walk_ndarray(sample)
        except Exception:
            safe = True   # the worker will surface the real error
        if not safe:
            warnings.warn(
                "DataLoader: the dataset/transform chain produces "
                "NDArrays, which cannot be made in forked worker processes "
                "(CUDA is not fork-safe); using the threaded prefetcher "
                "for num_workers=%d instead. For real multiprocess "
                "workers, keep worker-side code numpy-only."
                % self._num_workers, RuntimeWarning)
            if self._default_batchify:
                # in-process batches are NDArrays, not the numpy of the
                # shared-memory hop
                self._batchify_fn = default_batchify_fn
        self._fork_safe_cache = safe
        return safe

    def _iter_batches(self, ctx, pin=False):
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._make_batch(batch_idx, ctx)
            return
        # made a list once: a generator batch sampler must not lose batch
        # 0 to the probe
        batches = list(self._batch_sampler)
        if self._mp and self._fork_safe(batches):
            yield from self._iter_multiprocess(batches, ctx, pin)
        else:
            yield from self._iter_threaded(batches, ctx)

    def __iter__(self):
        ctx = current_context()
        pin = ctx.device_type == "gpu"
        depth = max(0, int(config.get("MXNET_PREFETCH_DEPTH")))
        if depth == 0:
            it = self._iter_batches(ctx, pin)
            try:
                while True:
                    with telemetry.span(
                            "dataloader::next", "io",
                            hist="mx_dataloader_batch_seconds") as sp:
                        try:
                            batch = next(it)
                        except StopIteration:
                            sp.cancel()
                            return
                    yield batch
            finally:
                it.close()
        # read-ahead: batches made on the host, up to `depth` of them
        # staged onto the loader's context beyond the one being consumed;
        # the refill runs after each yield, while the consumer computes
        it = self._iter_batches(cpu(), pin)
        ahead: deque = deque()
        exhausted, error = False, None
        try:
            while True:
                while not exhausted and len(ahead) < depth:
                    with telemetry.span("dataloader::prefetch", "io") as sp:
                        try:
                            ahead.append(_stage(next(it), ctx))
                        except StopIteration:
                            sp.cancel()
                            exhausted = True
                        except Exception as e:  # raised after the batches
                            sp.cancel()         # before it
                            exhausted, error = True, e
                with telemetry.span("dataloader::next", "io",
                                    hist="mx_dataloader_batch_seconds") \
                        as sp:
                    if not ahead:
                        sp.cancel()
                        if error is not None:
                            raise error
                        return
                    batch = ahead.popleft()
                yield batch
        finally:
            it.close()
