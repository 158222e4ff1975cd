"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

A :class:`Mesh` is an n-d array of mesh devices with named axes, as a
``jax.sharding.Mesh`` is. A mesh device (:class:`Device`) is one of the
port's contexts in one process of the group: ``gpu(i)`` or ``cpu(i)``,
with its process's rank and its ordinal in the mesh's device list. The
process that drives a mesh runs its local devices; the part of a
collective that crosses processes goes through the process group of
:func:`mxnet_tpu_torch.dist.initialize` (:mod:`._spmd`).

Axis names: ``dcn`` (replicas across processes, outermost), ``pp``,
``dp`` (data), ``fsdp``, ``ep``, ``sp``, ``tp`` (innermost), the
reference's order. A :class:`P` (``PartitionSpec``) names, for each
dimension of an array, the mesh axis (or tuple of axes) it is split
over, ``None`` for a dimension kept whole; a :class:`NamedSharding`
pairs one with a mesh.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError
from ..context import Context

__all__ = ["MeshConfig", "make_mesh", "P", "NamedSharding", "Mesh"]


@dataclass
class MeshConfig:
    dcn: int = 1   # data-parallel replicas across processes
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    fsdp: int = 1

    def total(self) -> int:
        return (self.dcn * self.dp * self.tp * self.sp * self.pp * self.ep
                * self.fsdp)

    def axes(self) -> List[Tuple[str, int]]:
        # 'dcn' is the outermost (slowest-varying) axis: consecutive
        # devices stay within one process, so only the 'dcn' axis's
        # collectives cross the process group
        out = []
        for name in ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp"):
            n = getattr(self, name)
            if n > 1:
                out.append((name, n))
        if not out:
            out = [("dp", 1)]
        return out


class Device:
    """One member of a mesh: a context of process ``process_index``,
    ``id`` its ordinal in the device list the mesh was made from."""

    __slots__ = ("id", "process_index", "context")

    def __init__(self, id: int, process_index: int, context: Context):
        self.id = int(id)
        self.process_index = int(process_index)
        self.context = Context(context)

    def __eq__(self, other):
        return isinstance(other, Device) and \
            (self.process_index, self.context) == \
            (other.process_index, other.context)

    def __hash__(self):
        return hash((self.process_index, self.context))

    def __repr__(self):
        return "Device(id=%d, process=%d, %s)" % (
            self.id, self.process_index, self.context)


class P(tuple):
    """A partition spec: one entry a dimension, a mesh axis name, a
    tuple of them, or None (ref: ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self) if len(self) != 1
                        else "(%r)" % (self[0],))


class Mesh:
    """Devices in an n-d array with named axes. ``shape`` maps each axis
    name to its size; ``devices`` is the array of :class:`Device`.
    ``with mesh:`` is accepted, as for the reference's mesh, and does
    nothing."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = list(np.asarray(devices, dtype=object).flat)
        for i, d in enumerate(flat):
            arr.flat[i] = d
        if arr.ndim != len(axis_names):
            raise MXNetError("Mesh: %d axis names for a %d-d device array"
                             % (len(axis_names), arr.ndim))
        if len(set(flat)) != len(flat):
            raise MXNetError("Mesh: a device appears twice: %s" % (flat,))
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_indices(self) -> List[int]:
        return sorted({d.process_index for d in self.devices.flat})

    def local_devices(self, rank: Optional[int] = None) -> List[Device]:
        """The devices of process ``rank`` (default: this process), in
        mesh order."""
        if rank is None:
            from .. import dist
            rank = dist.rank()
        return [d for d in self.devices.flat if d.process_index == rank]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%r: %d" % kv
                                      for kv in self.shape.items())


class NamedSharding:
    """A partition spec on a mesh (ref: ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and tuple(other.spec) == tuple(self.spec)

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def _local_contexts() -> List[Context]:
    """This process's contexts: ``MXNET_DIST_CPU_DEVICES`` CPU ones when
    it is set, else every card this process sees."""
    from .. import dist
    from ..context import gpu, num_gpus
    if dist.is_initialized():
        return list(dist.local_contexts())
    from ..config import getenv_raw
    n = int(getenv_raw("MXNET_DIST_CPU_DEVICES") or 0)
    if n:
        from ..context import cpu
        return [cpu(i) for i in range(n)]
    return [gpu(i) for i in range(num_gpus())]


def default_devices() -> List[Device]:
    """Every process's contexts in rank order: this process's are
    :func:`_local_contexts`, and every process of the group has as many
    of the same kind (the counterpart of ``jax.devices()``)."""
    from .. import dist
    local = _local_contexts()
    if not local:
        raise MXNetError("make_mesh: this process has no device (no card; "
                         "set MXNET_DIST_CPU_DEVICES=N for N CPU contexts, "
                         "or pass devices=)")
    nproc = dist.num_workers()
    if nproc > 1:
        counts = dist.allgather_floats([len(local)], tag="mesh")
        if len({int(c[0]) for c in counts}) != 1:
            raise MXNetError("make_mesh: the processes hold %s devices; "
                             "a default mesh needs the same count in each"
                             % [int(c[0]) for c in counts])
    out = []
    for r in range(nproc):
        for c in local:
            out.append(Device(len(out), r, c))
    return out


def _as_devices(devices) -> List[Device]:
    """``devices`` (contexts of this process, or :class:`Device`\\ s) as
    mesh devices."""
    from .. import dist
    out = []
    for d in devices:
        if isinstance(d, Device):
            out.append(Device(len(out), d.process_index, d.context))
        else:
            out.append(Device(len(out), dist.rank(), Context(d)))
    return out


def contexts_mesh(contexts: Sequence, axis_names: Sequence[str] = ("dp",),
                  shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over this process's ``contexts`` in their order, reshaped
    to ``shape`` (default: one axis) with ``axis_names``: the mesh the
    ZeRO engine, the kvstore's quantized reduce and the reshard's
    transition check run their replicas on."""
    devs = np.empty(len(contexts), dtype=object)
    for i, d in enumerate(_as_devices(contexts)):
        devs[i] = d
    return Mesh(devs.reshape(tuple(shape) if shape else (len(contexts),)),
                axis_names)


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Optional[Sequence] = None,
              axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: :func:`default_devices`):
    the axes of ``config`` (or ``axis_sizes``; default every device on
    ``dp``) in the reference's order, the fastest-varying (``tp``) on
    consecutive devices. On a mesh that spans processes, the ``dcn``
    axis is the process axis: its devices must be grouped by process."""
    devices = default_devices() if devices is None else _as_devices(devices)
    if config is None:
        if axis_sizes:
            config = MeshConfig(**axis_sizes)
        else:
            config = MeshConfig(dp=len(devices))
    axes = config.axes()
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(
            "mesh needs %d devices but only %d available" % (total, len(devices)))
    devices = devices[:total]
    if config.dcn > 1:
        _check_dcn(devices, config.dcn)
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(sizes), axis_names=tuple(names))


def _check_dcn(devices, dcn):
    """The counterpart of the reference's hybrid device mesh: the
    ``dcn`` blocks (consecutive runs of ``len / dcn`` devices) should
    each lie in one process, so the inner axes stay inside a process.
    A mesh over several processes whose order does not group them so
    warns with the reference's text."""
    procs = [d.process_index for d in devices]
    if len(set(procs)) < 2:
        return
    per = len(devices) // dcn
    grouped = all(len(set(procs[i * per:(i + 1) * per])) == 1
                  for i in range(dcn))
    if grouped:
        return
    ordered = all(a <= b for a, b in zip(procs, procs[1:]))
    warnings.warn(
        "create_hybrid_device_mesh failed on multi-slice devices "
        "(%s); falling back to reshape, which %s group the dcn axis "
        "by slice_index. Cross-slice collectives may ride DCN "
        "inside 'ICI' axes if the order is wrong." %
        ("the dcn blocks mix processes", "DOES" if ordered else "does NOT"),
        RuntimeWarning)
