"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``; ref:
python/mxnet/gluon/utils.py).

``clip_global_norm`` is the reference's arithmetic: each array's sum of
squares in float32, the global norm their root, every array scaled in
place by ``min(1, max_norm / (norm + 1e-8))``. With ``check_isfinite``
(the default) it reads the norm back to the host, warns when it is not
finite, and returns it as a float; without, it returns the norm as an
array and never syncs. ``download`` needs the network and is not ported.
"""
from __future__ import annotations

import hashlib
import warnings
from typing import List

import numpy as np

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "shape_is_known", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split a batch along ``batch_axis`` into ``num_slice`` slices."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d" % (str(data.shape), num_slice, batch_axis))
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and put slice i on ``ctx_list[i]``."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays: List[NDArray], max_norm: float,
                     check_isfinite=True):
    """Scale ``arrays`` in place so that their global L2 norm is at most
    ``max_norm``; returns the norm before scaling."""
    assert len(arrays) > 0
    ctx = arrays[0].ctx
    total = None
    for arr in arrays:
        sq = (arr.astype("float32") ** 2).sum().as_in_context(ctx)
        total = sq if total is None else total + sq
    total_norm = total.sqrt()
    if check_isfinite:
        val = float(total_norm.asscalar())
        if not np.isfinite(val):
            warnings.warn("nan or inf found in gradients")
    scale = nd.minimum(nd.ones((1,), ctx=ctx), max_norm / (total_norm + 1e-8))
    for arr in arrays:
        arr *= scale.as_in_context(arr.ctx)
    if check_isfinite:
        return val
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def shape_is_known(shape):
    if shape is None:
        return False
    return all(s > 0 for s in shape)


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Refused, as the reference refuses it: nothing is fetched over the
    network; place the files locally."""
    from ..base import MXNetError
    raise MXNetError(
        "download() requires network access, which is unavailable in this "
        "environment; place files locally instead")
