"""Data iterators (counterpart of ``mxnet_tpu/io/__init__.py``; ref:
python/mxnet/io/io.py :: DataIter, NDArrayIter, ResizeIter,
PrefetchingIter; DataBatch/DataDesc) and ``ImageRecordIter`` on the
native pipeline (``csrc/io.cc``, built by :mod:`mxnet_tpu_torch.native`;
ref: src/io/iter_image_recordio_2.cc).

The native pipeline emits NHWC uint8 batches on the host. On a card the
hand-off replaces the reference's engine op: the batch is copied out of
the producer's buffer on the calling thread (the producer recycles it at
the next ``MXIONext``) into one of a small ring of page-locked staging
tensors, uploaded with a non-blocking copy on a side stream, and the
consumer's current stream waits on that upload's event; a staging slot
is reused only once its event has completed. The cast, mean and std
normalisation and the NHWC to NCHW change then run as torch ops on the
consumer's stream (no Pallas kernel stands behind them in the
reference). Each batch an iterator's ``__next__`` returns is an
``io::<Iter>.next`` span (``mx_dataiter_batch_seconds{iter}``); the
exhausted probe at the end is not.
"""
from __future__ import annotations

import ctypes
import threading
from collections import namedtuple
from typing import List

import numpy as np
import torch

from .. import native
from .. import ndarray as nd
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, current_context
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        from .. import telemetry
        with telemetry.span("io::%s.next" % type(self).__name__, "io",
                            hist="mx_dataiter_batch_seconds",
                            iter=type(self).__name__) as sp:
            try:
                return self.next()
            except StopIteration:
                sp.cancel()     # the exhausted probe is not a batch
                raise

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, list or dict")
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            v = nd.array(np.asarray(v))
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py :: NDArrayIter), with
    pad/discard/roll_over last-batch handling. A batch is gathered on
    the arrays' own device."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        self.cursor = -batch_size
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._shuffled_indices = np.arange(self.num_data)
        if shuffle:
            self._do_shuffle()

    def _do_shuffle(self):
        np.random.shuffle(self._shuffled_indices)

    @property
    def provide_data(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self) -> List[DataDesc]:
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            self._do_shuffle()
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None)

    def _take(self, arrays):
        start = self.cursor
        end = min(start + self.batch_size, self.num_data)
        idx = self._shuffled_indices[start:end]
        pad = self.batch_size - (end - start)
        if pad and self.last_batch_handle == "pad":
            idx = np.concatenate([idx, self._shuffled_indices[:pad]])
        out = []
        for _, v in arrays:
            t = v.tensor()
            out.append(NDArray(t[torch.from_numpy(idx).to(t.device)],
                               v.context))
        return out

    def getdata(self):
        if self.last_batch_handle == "discard" and \
                self.cursor + self.batch_size > self.num_data:
            raise StopIteration
        return self._take(self.data)

    def getlabel(self):
        if not self.label:
            return None
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize an iterator to fixed batches per epoch (ref: io.py)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffer wrapper over iterators in background threads (ref:
    io.py :: PrefetchingIter, src/io/iter_prefetcher.h)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    def __del__(self):
        try:
            self.started = False
            for e in self.data_taken:
                e.set()
            for t in self.prefetch_threads:
                t.join(timeout=0.1)
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            return False
        self.current_batch = self.next_batch[0]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _Slot:
    """One page-locked staging pair (pixels, labels) and the event of
    the upload that last read it."""

    def __init__(self, data_shape, label_shape):
        self.data = torch.empty(data_shape, dtype=torch.uint8,
                                pin_memory=True)
        self.label = torch.empty(label_shape, dtype=torch.float32,
                                 pin_memory=True)
        self.event = None


class ImageRecordIter(DataIter):
    """Image RecordIO iterator on the native pipeline (ref:
    src/io/iter_image_recordio_2.cc :: ImageRecordIOParser2 behind
    MXDataIterCreateIter('ImageRecordIter')). The C++ producer reads the
    .rec (and, to shuffle, the .idx), decodes JPEG or takes raw records
    of the target size, resizes the short side, crops (random or
    centre), mirrors, and double-buffers the batches; decode and augment
    run on ``preprocess_threads`` threads a batch, each record's draws
    from its own generator, so a seed gives the same batches whatever
    the scheduling.

    Batches land on ``ctx`` (the current context, the card by default;
    ``ctx=mx.cpu()`` keeps them on the host) as ``data_layout`` (NCHW by
    default) in ``dtype``, normalised as ``(x - mean) / std`` per
    channel (the subtraction only where a mean is non-zero, the division
    only where a std is not one; the division is a multiplication by the
    f32 reciprocal, as the reference's compiled program does it). A short last batch is filled by
    repeating its records (``round_batch``) or with zeros, and ``pad``
    says how many rows are filler.
    """

    STAGING_SLOTS = 3

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, resize=0,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0,
                 data_layout="NCHW", dtype="float32", seed=0,
                 round_batch=True, ctx=None, device=True,
                 preprocess_threads=1, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise ValueError("data_shape must be (3, H, W)")
        if shuffle and not path_imgidx:
            raise MXNetError("shuffle=True needs path_imgidx")
        self._handle = None
        self._lib = native.load_io_lib()
        self._c, self._h, self._w = (int(data_shape[0]), int(data_shape[1]),
                                     int(data_shape[2]))
        self._label_width = int(label_width)
        self._layout = data_layout
        self._tdtype = torch_dtype(dtype)
        self._dtype = np_dtype(self._tdtype)
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
        std = np.array([std_r, std_g, std_b], np.float32)
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self._device = self._ctx.torch_device
        self._mean = torch.from_numpy(mean).to(self._device).view(1, 1, 1, 3) \
            if (mean != 0).any() else None
        # the reference divides by std in an XLA program, which
        # multiplies by the f32 reciprocal of the constant; so does the
        # port, and the batches agree bit for bit
        self._rstd = torch.from_numpy(np.float32(1) / std).to(
            self._device).view(1, 1, 1, 3) if (std != 1).any() else None
        self._round_batch = bool(round_batch)
        self._slots = []
        self._turn = 0
        self._stream = None
        idx = path_imgidx.encode() if (path_imgidx and shuffle) else None
        self._handle = self._lib.MXIOCreateImageRecordIter(
            path_imgrec.encode(), idx, int(batch_size), self._h, self._w,
            self._label_width, int(bool(shuffle)), int(bool(rand_crop)),
            int(bool(rand_mirror)), int(resize), int(preprocess_threads),
            int(seed))
        if not self._handle:
            raise MXNetError("ImageRecordIter init failed: %s"
                             % native.last_error(self._lib))

    @property
    def provide_data(self):
        shape = (self.batch_size, self._c, self._h, self._w) \
            if self._layout == "NCHW" \
            else (self.batch_size, self._h, self._w, self._c)
        return [DataDesc("data", shape, self._dtype, self._layout)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape, np.float32, "N")]

    def reset(self):
        self._lib.MXIOReset(self._handle)

    def _fill(self, buf, lab, data, label):
        """Copy the producer's ``count`` records into ``data``/``label``
        (numpy, ``batch_size`` rows): a short batch is filled by
        repeating its records (``round_batch``) or with zeros. Returns
        the number of filler rows."""
        count = buf.shape[0]
        if count == self.batch_size:
            data[...] = buf
            label[...] = lab
            return 0
        if self._round_batch:
            rows = np.arange(self.batch_size) % count
            np.take(buf, rows, axis=0, out=data)
            np.take(lab, rows, axis=0, out=label)
        else:
            data[:count] = buf
            data[count:] = 0
            label[:count] = lab
            label[count:] = 0
        return self.batch_size - count

    def _slot(self):
        """The staging slot for the next batch, round the ring."""
        if not self._slots:
            self._slots = [
                _Slot((self.batch_size, self._h, self._w, self._c),
                      (self.batch_size, self._label_width))
                for _ in range(self.STAGING_SLOTS)]
            self._stream = torch.cuda.Stream(self._device)
        slot = self._slots[self._turn % len(self._slots)]
        self._turn += 1
        return slot

    def _upload(self, slot):
        """The slot's pixels and labels on the card, uploaded on the side
        stream; the consumer's stream waits for the upload."""
        try:
            with torch.cuda.stream(self._stream):
                data = slot.data.to(self._device, non_blocking=True)
                label = slot.label.to(self._device, non_blocking=True)
                slot.event = torch.cuda.Event()
                slot.event.record(self._stream)
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(slot.event)
            data.record_stream(consumer)
            label.record_stream(consumer)
        except RuntimeError as e:
            raise MXNetError("ImageRecordIter: the upload to %s failed: %s"
                             % (self._ctx, e)) from e
        return data, label

    def _postprocess(self, raw):
        """NHWC uint8 to the batch: f32, minus the mean, times the
        reciprocal of the std, NCHW, ``dtype`` (the reference's
        operations in its order)."""
        y = raw.to(torch.float32)
        if self._mean is not None:
            y = y - self._mean
        if self._rstd is not None:
            y = y * self._rstd
        if self._layout == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y.to(self._tdtype).contiguous()

    def next(self):
        data_p = ctypes.POINTER(ctypes.c_uint8)()
        label_p = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int(0)
        rc = self._lib.MXIONext(self._handle, ctypes.byref(data_p),
                                ctypes.byref(label_p), ctypes.byref(n))
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise MXNetError("ImageRecordIter: %s"
                             % native.last_error(self._lib))
        count = n.value
        # views of the producer's buffer, which it recycles at the next
        # MXIONext: copied out here, on this thread
        buf = np.ctypeslib.as_array(data_p,
                                    shape=(count, self._h, self._w, self._c))
        lab = np.ctypeslib.as_array(label_p,
                                    shape=(count, self._label_width))
        if self._device.type == "cuda":
            slot = self._slot()
            if slot.event is not None:
                slot.event.synchronize()   # its last upload has read it
            pad = self._fill(buf, lab, slot.data.numpy(), slot.label.numpy())
            raw, label = self._upload(slot)
        else:
            raw = torch.empty((self.batch_size, self._h, self._w, self._c),
                              dtype=torch.uint8)
            label = torch.empty((self.batch_size, self._label_width),
                                dtype=torch.float32)
            pad = self._fill(buf, lab, raw.numpy(), label.numpy())
        if self._label_width == 1:
            label = label[:, 0]
        return DataBatch([NDArray(self._postprocess(raw), self._ctx)],
                         [NDArray(label.contiguous(), self._ctx)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.MXIOFree(self._handle)
                self._handle = None
        except Exception:
            pass
