"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; ref:
python/mxnet/gluon/data/vision/transforms.py).

Each transform takes an HWC image (numpy or NDArray), computes on the
host in numpy with the reference's arithmetic and its ``np.random``
draws, and returns an ``nd.array`` on the current context. A chain of
these yields NDArrays, so the DataLoader runs it in a thread, not in
worker processes, as the reference does (``dataloader.py``
``_fork_safe``).
"""
from __future__ import annotations

import numbers

import numpy as np

from .... import ndarray as nd
from ....ndarray import NDArray
from ...block import Block
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight",
           "RandomFlipTopBottom"]


def _to_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class Compose(Sequential):
    """Transforms run in order (ref: transforms.Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if isinstance(x, NDArray):
            return x.astype(self._dtype)
        return nd.array(_to_numpy(x).astype(self._dtype))


class ToTensor(Block):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (ref: ToTensor)."""

    def forward(self, x):
        arr = _to_numpy(x).astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return nd.array(arr)


class Normalize(Block):
    """(x - mean) / std per channel of a CHW tensor (ref: Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32)
        self._std = np.asarray(std, dtype=np.float32)

    def forward(self, x):
        arr = _to_numpy(x).astype(np.float32)
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return nd.array((arr - mean) / std)


class Resize(Block):
    """Bilinear resize to ``size`` = (w, h) (ref: transforms.Resize);
    a uint8 result is truncated, as the reference's."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, numbers.Number) else size

    def forward(self, x):
        arr = _to_numpy(x)
        h, w = arr.shape[:2]
        nh, nw = self._size[1], self._size[0]
        ys = (np.arange(nh) + 0.5) * h / nh - 0.5
        xs = (np.arange(nw) + 0.5) * w / nw - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        a = arr[np.ix_(y0, x0)].astype(np.float32)
        b = arr[np.ix_(y0, x1)].astype(np.float32)
        c = arr[np.ix_(y1, x0)].astype(np.float32)
        d = arr[np.ix_(y1, x1)].astype(np.float32)
        out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
               + c * wy * (1 - wx) + d * wy * wx)
        return nd.array(out.astype(arr.dtype if arr.dtype == np.float32
                                   else np.uint8))


class CenterCrop(Block):
    """The central (w, h) window (ref: CenterCrop)."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, numbers.Number) else size

    def forward(self, x):
        arr = _to_numpy(x)
        h, w = arr.shape[:2]
        cw, ch = self._size
        y0 = max((h - ch) // 2, 0)
        x0 = max((w - cw) // 2, 0)
        return nd.array(arr[y0:y0 + ch, x0:x0 + cw])


class RandomResizedCrop(Block):
    """A crop of random area and aspect ratio resized to ``size``, ten
    tries, then the central crop (ref: RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, numbers.Number) else size
        self._scale = scale
        self._ratio = ratio
        self._resize = Resize(self._size)

    def forward(self, x):
        arr = _to_numpy(x)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.exp(np.random.uniform(np.log(self._ratio[0]),
                                              np.log(self._ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = np.random.randint(0, w - cw + 1)
                y0 = np.random.randint(0, h - ch + 1)
                crop = arr[y0:y0 + ch, x0:x0 + cw]
                return self._resize(nd.array(crop))
        return self._resize(CenterCrop(self._size)(nd.array(arr)))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        arr = _to_numpy(x)
        if np.random.rand() < 0.5:
            arr = arr[:, ::-1].copy()
        return nd.array(arr)


class RandomFlipTopBottom(Block):
    def forward(self, x):
        arr = _to_numpy(x)
        if np.random.rand() < 0.5:
            arr = arr[::-1].copy()
        return nd.array(arr)
