"""`mx.nd` — the imperative NDArray namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``).

Creation helpers, ``save`` and ``load`` live here; every registered op
is reachable as ``nd.<op name>`` through the same namespace
``hybrid_forward`` gets.

``save``/``load`` use MXNet's binary NDArray container (ref:
src/c_api/c_api.cc :: MXNDArraySave, src/ndarray/ndarray.cc ::
NDArray::Save/Load), the reference's byte for byte:

    uint64 list magic 0x112, uint64 reserved, uint64 n_arrays, then per
    array: uint32 V2 magic, int32 stype (0 = dense), uint32 ndim and
    int64 dims, int32 dev_type and int32 dev_id (cpu(0) in the file:
    ``load`` places the arrays), int32 type flag, the row-major bytes;
    then uint64 n_names and, per name, uint64 length and utf-8 bytes.

Legacy V1 records (no stype field) and the reference's first ``.npz``
container also read. Saving from the card copies every array to the
host asynchronously and waits once.
"""
from __future__ import annotations

import numbers
import struct

import numpy as np
import torch
import torch.utils.dlpack

from ..base import MXNetError
from ..context import Context, current_context
from .ndarray import (NDArray, array, concatenate, empty, host_copies,
                      host_numpy, host_tensor, invoke, ones, waitall, zeros)
from ..ops import F as _F

__all__ = ["NDArray", "array", "zeros", "ones", "invoke", "host_tensor",
           "concatenate", "waitall", "stack_list", "moveaxis", "maximum",
           "minimum", "save", "load", "full", "arange", "linspace", "eye",
           "empty", "to_dlpack_for_read", "to_dlpack_for_write",
           "from_dlpack"]

_LIST_MAGIC = 0x112          # kMXAPINDArrayListMagic
_ND_MAGIC_V2 = 0xF993FAC9    # NDARRAY_V2_MAGIC (dense, with stype)
_ND_MAGIC_V1 = 0xF993FAC8    # legacy, no stype field
# mshadow's TypeFlag; 12 is bfloat16
_TYPE_FLAGS = {0: torch.float32, 1: torch.float64, 2: torch.float16,
               3: torch.uint8, 4: torch.int32, 5: torch.int8,
               6: torch.int64, 7: torch.bool, 12: torch.bfloat16}
_TYPE_FLAGS_INV = {v: k for k, v in _TYPE_FLAGS.items()}


def _unpack(fmt, f):
    """``struct.unpack`` of the next bytes of ``f``; a short read is a
    truncated file."""
    raw = f.read(struct.calcsize(fmt))
    if len(raw) != struct.calcsize(fmt):
        raise ValueError("truncated NDArray file")
    return struct.unpack(fmt, raw)


def _write_ndarray(f, t: torch.Tensor):
    """One V2 record of the CPU tensor ``t``."""
    flag = _TYPE_FLAGS_INV.get(t.dtype)
    if flag is None:
        raise TypeError("cannot save dtype %s" % t.dtype)
    f.write(struct.pack("<Ii", _ND_MAGIC_V2, 0))
    f.write(struct.pack("<I", t.dim()))
    f.write(struct.pack("<%dq" % t.dim(), *t.shape))
    f.write(struct.pack("<iii", 1, 0, flag))
    f.write(np.ascontiguousarray(host_numpy(t)).tobytes())


def _read_ndarray(f) -> torch.Tensor:
    """One record (V2 or V1) as a CPU tensor."""
    magic, = _unpack("<I", f)
    if magic == _ND_MAGIC_V2:
        stype, = _unpack("<i", f)
        if stype not in (-1, 0):
            _raise_stype(stype)
    elif magic != _ND_MAGIC_V1:
        raise ValueError("invalid NDArray record magic 0x%x" % magic)
    ndim, = _unpack("<I", f)
    shape = _unpack("<%dq" % ndim, f)
    _unpack("<ii", f)  # the context in the file, ignored
    flag, = _unpack("<i", f)
    dtype = _TYPE_FLAGS.get(flag)
    if dtype is None:
        raise ValueError("unknown dtype flag %d in NDArray file" % flag)
    npdt = np.dtype(np.int16 if dtype == torch.bfloat16
                    else str(dtype).replace("torch.", ""))
    nbytes = (int(np.prod(shape)) if shape else 1) * npdt.itemsize
    raw = f.read(nbytes)
    if len(raw) != nbytes:
        raise ValueError("truncated NDArray record")
    t = torch.from_numpy(np.frombuffer(raw, dtype=npdt).reshape(shape).copy())
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _raise_stype(stype):
    raise MXNetError("sparse NDArray records (stype=%d) not supported by "
                     "nd.load (ndarray/sparse.py is ROADMAP.md queue 1, "
                     "item 16)" % stype)


def save(fname: str, data):
    """Write an NDArray, a list of them or a dict of named ones to
    ``fname`` in the binary container (ref: nd.save)."""
    if isinstance(data, NDArray):
        arrays, names = [data], []
    elif isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        raise TypeError("save expects NDArray, list, or dict")
    hosts = host_copies([a.tensor() for a in arrays])
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for t in hosts:
            _write_ndarray(f, t)
        f.write(struct.pack("<Q", len(names)))
        for k in names:
            b = k.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname: str, ctx=None):
    """The arrays of ``fname`` on ``ctx`` (the current context when
    None): a dict when the file names them, else a list (ref:
    nd.load)."""
    ctx = Context(ctx or current_context())
    with open(fname, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError("truncated NDArray file %r" % fname)
        magic, = struct.unpack("<Q", head)
        if magic != _LIST_MAGIC:
            return _load_npz(fname, ctx)
        _, n = _unpack("<QQ", f)  # reserved, count
        arrays = [NDArray(ctx.place(_read_ndarray(f)), ctx)
                  for _ in range(n)]
        n_names, = _unpack("<Q", f)
        names = []
        for _ in range(n_names):
            ln, = _unpack("<Q", f)
            names.append(f.read(ln).decode("utf-8"))
    if not names:
        return arrays
    return dict(zip(names, arrays))


def _load_npz(fname: str, ctx: Context):
    """The reference's first container: an ``.npz`` of ``__single__``,
    ``__list__<i>`` or named arrays."""
    loaded = np.load(fname, allow_pickle=False)
    keys = list(loaded.keys())
    if keys == ["__single__"]:
        return array(loaded["__single__"], ctx=ctx)
    if all(k.startswith("__list__") for k in keys):
        keys.sort(key=lambda k: int(k[len("__list__"):]))
        return [array(loaded[k], ctx=ctx) for k in keys]
    return {k: array(loaded[k], ctx=ctx) for k in keys}


def full(shape, val, ctx=None, dtype="float32"):
    """The ``_full`` op with MXNet's positional order."""
    return invoke("_full", [], {"shape": shape, "value": val, "ctx": ctx,
                                "dtype": dtype})


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """The ``_arange`` op with MXNet's positional order."""
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat, "ctx": ctx,
                                  "dtype": dtype})


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    """The ``_linspace`` op with MXNet's positional order."""
    return invoke("_linspace", [], {"start": start, "stop": stop,
                                    "num": num, "endpoint": endpoint,
                                    "ctx": ctx, "dtype": dtype})


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    """The ``_eye`` op with MXNet's positional order."""
    return invoke("_eye", [], {"N": N, "M": M, "k": k, "ctx": ctx,
                               "dtype": dtype})


def stack_list(arrays, axis=0):
    return invoke("stack", list(arrays), {"axis": axis})


def moveaxis(data, source, destination):
    axes = list(range(data.ndim))
    axes.remove(source % data.ndim)
    axes.insert(destination % data.ndim, source % data.ndim)
    return data.transpose(axes)


def _minmax(lhs, rhs, name):
    """MXNet 1.x's ``nd.maximum``/``nd.minimum``: broadcasting between
    two arrays, or an array and a scalar."""
    if isinstance(lhs, numbers.Number):
        lhs, rhs = rhs, lhs
    if isinstance(rhs, numbers.Number):
        return invoke("_%s_scalar" % name, [lhs], {"scalar": float(rhs)})
    return invoke("broadcast_" + name, [lhs, rhs], {})


def maximum(lhs, rhs):
    return _minmax(lhs, rhs, "maximum")


def minimum(lhs, rhs):
    return _minmax(lhs, rhs, "minimum")


class _ImageNamespace:
    """``nd.image.<name>``: the ``_image_<name>`` ops (MXNet 1.x's
    ``mx.nd.image``: to_tensor, normalize, resize, crop, the flips, the
    random colour ops and lighting)."""

    def __getattr__(self, name):
        return getattr(_F, "_image_" + name)

    def __dir__(self):
        from ..ops import _OPS
        return sorted(n[len("_image_"):] for n in _OPS
                      if n.startswith("_image_"))


image = _ImageNamespace()


def __getattr__(name):
    return getattr(_F, name)


# -- DLPack exchange (ref: MXNDArrayToDLPack / MXNDArrayFromDLPack) ---------
def to_dlpack_for_read(data: NDArray):
    """A DLPack capsule sharing ``data``'s memory."""
    return torch.utils.dlpack.to_dlpack(data.tensor().detach())


def to_dlpack_for_write(data: NDArray):
    """A DLPack capsule sharing ``data``'s memory; writes through it are
    seen by ``data``."""
    return torch.utils.dlpack.to_dlpack(data.tensor().detach())


def from_dlpack(capsule) -> NDArray:
    """An NDArray over a DLPack capsule, or any object with
    ``__dlpack__`` (numpy, torch, ...), sharing its memory."""
    t = torch.utils.dlpack.from_dlpack(capsule)
    from ..context import context_of
    return NDArray(t, context_of(t.device))
