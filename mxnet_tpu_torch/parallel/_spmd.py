"""The SPMD runtime under ``shard_map`` and the sharded step.

The reference compiles one program for the whole mesh and XLA places the
collectives. The port runs the function once per local mesh device
instead (:class:`Run`): in the calling thread when the process holds one
device of the mesh, else in one thread a device, each under its own
context. A collective called in those runs meets across them: every
local run of the mesh calls the same collectives in the same order
(SPMD), so the k-th collective of each run is one exchange. The last run
to arrive computes every group's result, in the order of the groups, and
wakes the others.

Two exchanges underlie every collective: ``sum`` (the group's values
added in group order: one grouped NCCL all-reduce when the group's local
members are distinct cards, else in order on the first member's device,
the kvstore's grouped reduce) and ``gather`` (the group's values in group
order). The part of a group in other processes joins through the process
group of :func:`mxnet_tpu_torch.dist.initialize`: ``all_reduce`` for a
sum, ``all_gather`` for a gather. Every process walks its groups in the
same order, so the process group sees the same sequence of calls in each.
A group that spans some but not all of the processes is refused.

A run's failure (an exception in one device's thread) wakes the others,
which raise too; :meth:`Run.execute` raises the first.

A backward exchange (the differentiable ``ring_permute`` and
``all_to_all`` of :mod:`.collectives`) is keyed by the sequence number
of its forward exchange instead of taking the next one: autograd may
walk two independent chains in another order on another device, and a
keyed exchange can never pair one chain's cotangent with the other's
(crossed orders stop at the timeout instead). Gradients are taken
inside the run, on every device (a backward after :meth:`Run.execute`
returned would wait for devices that no longer run).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..ops import nn as _nn

_TLS = threading.local()
# seconds a device waits at a collective for the others
WAIT_SECONDS = 600.0


def member() -> Optional["Member"]:
    """The mesh device this thread runs for, inside a :class:`Run`."""
    return getattr(_TLS, "member", None)


def axes_of(axis) -> Tuple[str, ...]:
    """An axis name or a tuple of them, as a tuple."""
    if isinstance(axis, (tuple, list)):
        return tuple(axis)
    return (axis,)


class _Aborted(MXNetError):
    """Another device's run failed: this one stops at its collective."""


class Member:
    """One local device of a run: its position among the local devices,
    its :class:`~.mesh.Device` and mesh coordinates, the number of
    collectives it has called."""

    __slots__ = ("run", "pos", "device", "coords", "seq", "state")

    def __init__(self, run, pos, device, coords):
        self.run, self.pos, self.device, self.coords = run, pos, device, coords
        self.seq = 0
        self.state = {}

    @property
    def torch_device(self) -> torch.device:
        return self.device.context.torch_device

    def axis_size(self, axis) -> int:
        return self.run.axis_size(axis)

    def axis_index(self, axis) -> int:
        """This device's position along ``axis`` (row-major over a tuple
        of axes, in the order given)."""
        return self.run.group_position(self.coords, axes_of(axis))


class Run:
    """One SPMD execution over this process's devices of ``mesh``."""

    def __init__(self, mesh, collector=None):
        from .. import dist
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.shape = tuple(mesh.devices.shape)
        self.rank = dist.rank()
        self.procs = mesh.process_indices
        if len(self.procs) > 1 and (not dist.is_initialized()
                                    or self.procs != list(range(
                                        dist.num_workers()))):
            raise MXNetError(
                "a mesh over processes %s needs the process group of "
                "dist.initialize with exactly those ranks" % self.procs)
        self.coords = {}
        for idx in np.ndindex(*self.shape):
            self.coords[mesh.devices[idx]] = tuple(int(i) for i in idx)
        local = mesh.local_devices(self.rank)
        if not local:
            raise MXNetError("process %d holds no device of %r"
                             % (self.rank, mesh))
        self.members = [Member(self, i, d, self.coords[d])
                        for i, d in enumerate(local)]
        self.collector = collector
        self._cond = threading.Condition()
        self._slots: Dict[object, dict] = {}
        self._failed: Optional[BaseException] = None
        self.done = False

    # ------------------------------------------------------------------
    def axis_size(self, axis) -> int:
        out = 1
        for a in axes_of(axis):
            if a not in self.names:
                raise MXNetError("unknown mesh axis %r (the mesh has %s)"
                                 % (a, self.names))
            out *= self.shape[self.names.index(a)]
        return out

    def group_position(self, coords, axes) -> int:
        pos = 0
        for a in axes:
            i = self.names.index(a)
            pos = pos * self.shape[i] + coords[i]
        return pos

    def _group_key(self, coords, axes):
        keep = [i for i, n in enumerate(self.names) if n not in axes]
        return tuple(coords[i] for i in keep)

    def group(self, coords, axes) -> List:
        """The devices of the group of ``coords`` along ``axes``, in
        group order."""
        key = self._group_key(coords, axes)
        devs = [d for d, c in self.coords.items()
                if self._group_key(c, axes) == key]
        return sorted(devs, key=lambda d: self.group_position(
            self.coords[d], axes))

    # ------------------------------------------------------------------
    def execute(self, fn: Callable[[Member], object],
                setup: Optional[Callable] = None) -> List:
        """``fn(member)`` for every local device, each under
        ``setup(member)`` (a context manager factory) when given; the
        results in local order. One local device runs in the calling
        thread."""
        if len(self.members) == 1:
            try:
                return [self._run_one(self.members[0], fn, setup)]
            finally:
                self.done = True
        out = [None] * len(self.members)
        errs: List[Optional[BaseException]] = [None] * len(self.members)
        from .. import commwatch

        def body(m):
            try:
                with commwatch.bound_collector(self.collector):
                    out[m.pos] = self._run_one(m, fn, setup)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs[m.pos] = e
                self.fail(e)
        threads = [threading.Thread(target=body, args=(m,), daemon=True,
                                    name="mx-spmd-%s" % m.device.context)
                   for m in self.members]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.done = True
        real = [e for e in errs if e is not None
                and not isinstance(e, _Aborted)]
        if real:
            raise real[0]
        if any(e is not None for e in errs):
            raise next(e for e in errs if e is not None)
        return out

    def _run_one(self, m, fn, setup):
        prev = getattr(_TLS, "member", None)
        _TLS.member = m
        try:
            if setup is None:
                return fn(m)
            with setup(m):
                return fn(m)
        finally:
            _TLS.member = prev

    def fail(self, exc: BaseException):
        with self._cond:
            if self._failed is None:
                self._failed = exc
            self._cond.notify_all()

    # ------------------------------------------------------------------
    def exchange(self, m: Member, kind: str, axes, value: torch.Tensor,
                 watch: Optional[tuple] = None, key=None):
        """The ``kind`` exchange (``sum`` or ``gather``) of ``value``
        over ``axes`` for member ``m``: the group's sum on m's device,
        or the list of the group's values in group order. ``watch`` is
        ``(op, nbytes, dtype_label[, count])``, recorded into commwatch
        once for the collective. ``key`` (a backward exchange's) pairs
        the members by that key instead of by their call order."""
        axes = axes_of(axes)
        for a in axes:
            if a not in self.names:
                raise MXNetError("unknown mesh axis %r (the mesh has %s)"
                                 % (a, self.names))
        if len(self.members) == 1:
            res = self._resolve({0: (kind, axes, value)}, watch)
            return res[0]
        if key is not None and self.done:
            raise MXNetError(
                "a backward exchange after its run ended: take gradients "
                "through mesh collectives inside shard_map's function, on "
                "every device")
        with self._cond:
            if key is None:
                seq = m.seq
                m.seq += 1
            else:
                seq = ("key",) + tuple(key)
            if self._failed is not None:
                raise _Aborted("another device's run failed: %s"
                               % self._failed)
            slot = self._slots.setdefault(
                seq, {"in": {}, "out": None, "left": len(self.members)})
            slot["in"][m.pos] = (kind, axes, value)
            if len(slot["in"]) == len(self.members):
                try:
                    slot["out"] = self._resolve(slot["in"], watch)
                except BaseException as e:  # noqa: BLE001
                    self._failed = self._failed or e
                    self._cond.notify_all()
                    raise
                self._cond.notify_all()
            else:
                ok = self._cond.wait_for(
                    lambda: slot["out"] is not None
                    or self._failed is not None, WAIT_SECONDS)
                if slot["out"] is None:
                    if self._failed is None:
                        self._failed = MXNetError(
                            "collective %s (%s over %s) timed out after "
                            "%g s waiting for the other devices"
                            % (seq, kind, axes, WAIT_SECONDS))
                        self._cond.notify_all()
                    if not ok or self._failed is not None:
                        raise _Aborted("collective %s stopped: %s"
                                       % (seq, self._failed))
            res = slot["out"][m.pos]
            slot["left"] -= 1
            if slot["left"] == 0:
                del self._slots[seq]
            return res

    def _resolve(self, entries: Dict[int, tuple], watch):
        kinds = {(e[0], e[1]) for e in entries.values()}
        if len(kinds) != 1:
            raise MXNetError("the devices of a mesh called different "
                             "collectives at the same point: %s"
                             % sorted(kinds))
        kind, axes = kinds.pop()
        groups: Dict[tuple, List[int]] = {}
        for pos in sorted(entries):
            c = self.members[pos].coords
            groups.setdefault(self._group_key(c, axes), []).append(pos)
        out: Dict[int, object] = {}
        participants = self.axis_size(axes)
        for key in sorted(groups):
            poss = sorted(groups[key], key=lambda p: self.group_position(
                self.members[p].coords, axes))
            devs = self.group(self.members[poss[0]].coords, axes)
            vals = [entries[p][2] for p in poss]
            remote = sorted({d.process_index for d in devs} - {self.rank})
            if remote and sorted(set(remote) | {self.rank}) != self.procs:
                raise MXNetError(
                    "a collective over %s spans processes %s of %s: a group "
                    "over some of the processes is not supported"
                    % (axes, sorted(set(remote) | {self.rank}), self.procs))
            if kind == "sum":
                total = _ordered_sum(vals)
                if remote:
                    _world_all_reduce(total)
                for p in poss:
                    dev = self.members[p].torch_device
                    out[p] = total if (p == poss[0]) else total.to(
                        dev, copy=True)
                    if out[p].device != dev:
                        out[p] = out[p].to(dev)
            elif kind == "gather":
                allv = _world_gather(vals, devs, self.rank) if remote \
                    else vals
                for p in poss:
                    dev = self.members[p].torch_device
                    out[p] = [v if v.device == dev else v.to(dev)
                              for v in allv]
            else:
                raise MXNetError("unknown exchange %r" % kind)
        if watch is not None and participants > 1:
            from .. import commwatch
            op, nbytes, label, count = (tuple(watch) + (1,))[:4]
            commwatch.traced_collective(op, axes if len(axes) > 1
                                        else axes[0], None, participants,
                                        count=count, nbytes=nbytes,
                                        dtype=label)
        return out


def _ordered_sum(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """The values' sum: one NCCL all-reduce over distinct cards, else
    added in order on the first value's device (a new tensor)."""
    with torch.no_grad():
        devs = [v.device for v in vals]
        if len(vals) > 1 and all(d.type == "cuda" for d in devs) and \
                len(set(devs)) == len(devs):
            from ..kvstore import _nccl_allreduce
            bufs = [v.detach().clone() for v in vals]
            _nccl_allreduce(bufs)
            return bufs[0]
        out = vals[0].detach().clone()
        for v in vals[1:]:
            out = out + v.detach().to(out.device)
        return out


def _world_all_reduce(t: torch.Tensor):
    import torch.distributed as tdist
    tdist.all_reduce(t)


def _world_gather(vals, devs, rank) -> List[torch.Tensor]:
    """Every process's values of one group, in group order (the group's
    devices grouped by process in rank order)."""
    import torch.distributed as tdist
    procs = [d.process_index for d in devs]
    if procs != sorted(procs):
        raise MXNetError("a gather across processes needs the group's "
                         "devices grouped by process, in rank order")
    nproc = len(set(procs))
    per = len(devs) // nproc
    if len(vals) != per or any(procs.count(p) != per for p in set(procs)):
        raise MXNetError("a gather across processes needs the same number "
                         "of the group's devices in each process")
    local = torch.stack([v.detach() for v in vals])
    dtype = local.dtype
    if dtype.itemsize == 1 and dtype.is_floating_point:
        # an fp8 payload crosses as its bytes (gloo has no fp8)
        local = local.view(torch.uint8)
    bufs = [torch.empty_like(local) for _ in range(nproc)]
    tdist.all_gather(bufs, local.contiguous())
    return [b.view(dtype)[i] for b in bufs for i in range(per)]


def batch_group_size() -> int:
    """The number of devices the current sharded step's batch is split
    over (1 outside a step, or for replicated data)."""
    m = member()
    if m is None:
        return 1
    axes = m.state.get("batch_axes")
    if not axes:
        return 1
    return m.run.axis_size(axes)


def allreduce_batch(t: torch.Tensor, m: Optional[Member] = None,
                    op: str = "allreduce") -> torch.Tensor:
    """The sum of ``t`` over the batch axes of member ``m``'s sharded
    step (default: this thread's member)."""
    m = m or member()
    axes = m.state["batch_axes"]
    nbytes = t.numel() * t.element_size()
    return m.run.exchange(m, "sum", axes, t, (op, nbytes, None))


def _bn_reducer():
    """BatchNorm's reducer on this thread (``ops/nn.py``): the sum over
    the batch axes of this thread's member, when its step's batch is
    split over more than one device."""
    m = member()
    if m is None or batch_group_size() <= 1:
        return None
    return lambda t: allreduce_batch(t, m)


_nn.set_batch_reducer_source(_bn_reducer)
