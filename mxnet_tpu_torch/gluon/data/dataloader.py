"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``;
ref: python/mxnet/gluon/data/dataloader.py).

Two paths of the reference are ported: ``num_workers=0`` loads in the
calling thread, and ``thread_pool=True`` batchifies in one worker thread
whose errors surface in the consumer. ``num_workers > 0`` without
``thread_pool`` selects the reference's forked workers with shared-memory
batches, which are not ported (ROADMAP queue 1, item 9): it raises
rather than quietly running threads instead.

Batches land on the context current when the iteration starts (the card
by default). With ``MXNET_PREFETCH_DEPTH`` above 0 (the default is 2),
batches are made on the host and up to that many ahead of the consumer
are staged onto that context, onto a card by non-blocking copies from
pinned memory, so their upload overlaps the steps before them. The reference's telemetry
spans around each batch wait for ``telemetry.py`` (ROADMAP queue 1,
item 13).
"""
from __future__ import annotations

import queue
import threading
import traceback
from collections import deque

import numpy as np

from ... import config
from ... import ndarray as nd
from ...base import MXNetError
from ...context import cpu, current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


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
        if self._num_workers > 0 and not thread_pool:
            raise MXNetError(
                "DataLoader(num_workers=%d) selects worker processes with "
                "shared-memory batches, which are not ported yet (ROADMAP "
                "queue 1, item 9); pass thread_pool=True for a worker "
                "thread, or num_workers=0" % self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
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

    def _iter_batches(self, ctx):
        if self._num_workers == 0:
            for batch_idx in self._batch_sampler:
                yield self._make_batch(batch_idx, ctx)
            return
        yield from self._iter_threaded(list(self._batch_sampler), ctx)

    def __iter__(self):
        ctx = current_context()
        depth = max(0, int(config.get("MXNET_PREFETCH_DEPTH")))
        if depth == 0:
            yield from self._iter_batches(ctx)
            return
        # read-ahead: batches made on the host, up to `depth` of them
        # staged onto the loader's context beyond the one being consumed;
        # the refill runs after each yield, while the consumer computes
        it = self._iter_batches(cpu())
        ahead: deque = deque()
        exhausted, error = False, None
        while True:
            while not exhausted and len(ahead) < depth:
                try:
                    ahead.append(_stage(next(it), ctx))
                except StopIteration:
                    exhausted = True
                except Exception as e:  # raised after the batches before it
                    exhausted, error = True, e
            if not ahead:
                if error is not None:
                    raise error
                return
            yield ahead.popleft()
