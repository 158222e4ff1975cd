"""Image loading and augmentation in Python (counterpart of
``mxnet_tpu/image.py``; ref: python/mxnet/image/image.py ::
imread/imdecode/resize_short/center_crop/random_crop, ImageIter and the
Augmenter classes).

The flexible surface; the throughput path is the native pipeline behind
:class:`io.ImageRecordIter` (``csrc/io.cc``). Images are NDArrays in HWC
uint8 or float, RGB (``imdecode(to_rgb=True)``), on the current context.
Decoding and resizing are OpenCV's, as in the reference; the random
draws are Python's ``random`` module's, so a seeded run matches the
reference's draw for draw."""
from __future__ import annotations

import os
import random as pyrandom
from typing import List, Optional

import numpy as np

from .base import MXNetError
from . import ndarray as nd
from . import io as io_mod
from . import recordio

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "HorizontalFlipAug",
           "CastAug", "ResizeAug", "ForceResizeAug", "CenterCropAug",
           "RandomCropAug", "ColorNormalizeAug", "CreateAugmenter", "Augmenter",
           "ImageIter"]


def _cv2():
    import cv2
    return cv2


def imread(filename, flag=1, to_rgb=True):
    cv2 = _cv2()
    img = cv2.imread(filename, cv2.IMREAD_COLOR if flag else
                     cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("cannot read image %s" % filename)
    if to_rgb and img.ndim == 3:
        img = img[:, :, ::-1]
    return nd.array(np.ascontiguousarray(img), dtype=np.uint8)


def imdecode(buf, flag=1, to_rgb=True):
    cv2 = _cv2()
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) \
        else buf.asnumpy().astype(np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR if flag else
                       cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("imdecode failed")
    if to_rgb and img.ndim == 3:
        img = img[:, :, ::-1]
    return nd.array(np.ascontiguousarray(img), dtype=np.uint8)


def imresize(src, w, h, interp=1):
    cv2 = _cv2()
    out = cv2.resize(src.asnumpy(), (w, h), interpolation=interp)
    return nd.array(out, dtype=src.dtype)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) if src.dtype == np.uint8 else src
    out = src - mean
    if std is not None:
        out = out / std
    return out


# ---------------------------------------------------------------- augmenters
class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return nd.array(src.asnumpy()[:, ::-1].copy(), dtype=src.dtype)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        # Python floats, so that dumps() can write them (the reference
        # keeps numpy scalars, and its dumps raises)
        super().__init__(mean=[float(v) for v in np.ravel(mean)],
                         std=[float(v) for v in np.ravel(std)]
                         if std is not None else None)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Ref: image.py :: CreateAugmenter — standard augmenter list."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None and mean is not False:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ------------------------------------------------------------------ ImageIter
class ImageIter(io_mod.DataIter):
    """Python image iterator over .rec files or .lst+images (ref:
    image.py :: ImageIter). Flexible/augmentable; for throughput use
    io.ImageRecordIter (native pipeline)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, aug_list=None,
                 imglist=None, dtype="float32", last_batch_handle="pad",
                 **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise ValueError("data_shape must be (3, H, W)")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.imgrec = None
        self.imglist = None
        self.seq: Optional[list] = None
        if path_imgrec:
            idx = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx):
                self.imgrec = recordio.MXIndexedRecordIO(idx, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
        elif path_imglist or imglist is not None:
            entries = {}
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) < 3:
                            continue
                        entries[int(parts[0])] = (
                            np.array([float(x) for x in parts[1:-1]],
                                     np.float32), parts[-1])
            else:
                for i, item in enumerate(imglist):
                    entries[i] = (np.asarray(item[0], np.float32).reshape(-1),
                                  item[1])
            self.imglist = entries
            self.seq = list(entries.keys())
        else:
            raise MXNetError("need path_imgrec or path_imglist/imglist")
        self.path_root = path_root
        if aug_list is None:
            aug_list = CreateAugmenter(data_shape)
        self.auglist = aug_list
        self.cur = 0
        self._allow_read = True
        self.reset()

    @property
    def provide_data(self):
        return [io_mod.DataDesc("data", (self.batch_size,) + self.data_shape,
                                self.dtype)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [io_mod.DataDesc("softmax_label", shape, np.float32, "N")]

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                rec = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(rec)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return label, f.read()
        rec = self.imgrec.read()
        if rec is None:
            raise StopIteration
        header, img = recordio.unpack(rec)
        return header.label, img

    def next(self):
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), self.dtype)
        batch_label = np.zeros((self.batch_size, self.label_width), np.float32)
        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                label, payload = self.next_sample()
                raw_size = h * w * c
                if isinstance(payload, (bytes, bytearray)) and \
                        len(payload) == raw_size:
                    img = nd.array(np.frombuffer(payload, np.uint8)
                                   .reshape(h, w, c).copy())
                else:
                    img = imdecode(payload)
                for aug in self.auglist:
                    img = aug(img)
                arr = img.asnumpy()
                if arr.shape[:2] != (h, w):
                    raise MXNetError(
                        "augmented image %s != data_shape %s"
                        % (arr.shape, (h, w)))
                batch_data[i] = arr.transpose(2, 0, 1)
                lab = np.ravel(np.asarray(label, np.float32))
                batch_label[i, :len(lab[:self.label_width])] = \
                    lab[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
            if self.last_batch_handle == "discard":
                raise StopIteration
            for j in range(i, self.batch_size):
                batch_data[j] = batch_data[j % max(i, 1)]
                batch_label[j] = batch_label[j % max(i, 1)]
        label_out = batch_label[:, 0] if self.label_width == 1 else batch_label
        return io_mod.DataBatch([nd.array(batch_data, dtype=self.dtype)],
                                [nd.array(label_out)], pad=pad,
                                provide_data=self.provide_data,
                                provide_label=self.provide_label)
