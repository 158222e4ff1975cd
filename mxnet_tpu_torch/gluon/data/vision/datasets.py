"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; ref:
python/mxnet/gluon/data/vision/datasets.py).

The datasets read the standard local files (MNIST idx, gz or not; the
CIFAR binary batches) under ``root`` and raise the reference's
``FileNotFoundError`` where one is missing: nothing is downloaded. The
images stay numpy (HWC uint8) until a transform or the batchify turns
them into NDArrays. ``SyntheticImageDataset`` draws seeded images and
labels with the same interface. ``ImageRecordDataset`` and
``ImageFolderDataset`` decode with :mod:`mxnet_tpu_torch.image` (OpenCV)
and return RGB NDArrays, as MXNet 1.x does (the reference's
``ImageRecordDataset`` returns BGR: ROADMAP queue 3).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..dataset import Dataset, RecordFileDataset, _DownloadedDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticImageDataset"]


class MNIST(_DownloadedDataset):
    """MNIST from local idx files (ref: datasets.py :: MNIST)."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz",)
        self._train_label = ("train-labels-idx1-ubyte.gz",)
        self._test_data = ("t10k-images-idx3-ubyte.gz",)
        self._test_label = ("t10k-labels-idx1-ubyte.gz",)
        super().__init__(root, transform)

    def _get_data(self):
        if self._train:
            data_file, label_file = self._train_data[0], self._train_label[0]
        else:
            data_file, label_file = self._test_data[0], self._test_label[0]
        data_path = os.path.join(self._root, data_file)
        label_path = os.path.join(self._root, label_file)
        for p in (data_path, label_path):
            if not os.path.exists(p) and not os.path.exists(p[:-3]):
                raise FileNotFoundError(
                    "MNIST file %s not found (no network in this "
                    "environment — place the idx files under %s, or use "
                    "SyntheticImageDataset for smoke tests)"
                    % (p, self._root))

        def _open(p):
            if os.path.exists(p):
                return gzip.open(p, "rb")
            return open(p[:-3], "rb")

        with _open(label_path) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
        with _open(data_path) as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(num, rows, cols, 1)
        self._label = label
        self._data = data


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from its binary batches (ref: datasets.py :: CIFAR10)."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3073)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            files = ["test_batch.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(
                    "CIFAR10 file %s not found (no network; place the "
                    "binary batches under %s)" % (p, self._root))
        data, label = zip(*[self._read_batch(p) for p in paths])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR-100: the coarse label, or the fine one with ``fine_label``."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root=root, train=train, transform=transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3074)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 if not self._fine_label else 1].astype(np.int32)

    def _get_data(self):
        files = ["train.bin"] if self._train else ["test.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError("CIFAR100 file %s not found" % p)
        data, label = zip(*[self._read_batch(p) for p in paths])
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class SyntheticImageDataset(Dataset):
    """Seeded random images (HWC) and labels: the stand-in for a real
    dataset in smoke tests and input-pipeline measurements."""

    def __init__(self, num_samples=1024, shape=(32, 32, 3), num_classes=10,
                 seed=42, dtype="uint8"):
        rng = np.random.RandomState(seed)
        self._data = rng.randint(0, 256, size=(num_samples,) + tuple(shape)) \
            .astype(dtype)
        self._label = rng.randint(0, num_classes,
                                  size=(num_samples,)).astype(np.int32)

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]


class ImageRecordDataset(RecordFileDataset):
    """Images from a RecordIO pack (ref: datasets.py ::
    ImageRecordDataset): each item is ``(image, label)``, the image
    decoded by ``image.imdecode`` (HWC, RGB; ``flag`` 0 for grayscale),
    passed through ``transform(image, label)`` when one is given."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image, recordio
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = image.imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """Images arranged in class folders, ``root/<class>/<image>`` (ref:
    datasets.py :: ImageFolderDataset): the classes are the sorted
    folder names (``synsets``), each label the folder's index; items are
    ``(image, label)``, read by ``image.imread`` (HWC, RGB)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from .... import image
        img = image.imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
