"""Array redistribution across device sets (counterpart of
``mxnet_tpu/parallel/reshard.py``).

Elastic training moves state that lives under one layout on one set of
contexts to another layout on another set, without a whole copy of a
large tensor on any one device: the transfer is cut into rectangular
piece moves (the intersections of the source and destination
partitions), staged in blocks of ``MXNET_ELASTIC_BLOCK`` bytes so a
device holds at most its destination shard plus one block, and closed
by a transition check on the destination set (one all-reduce of a count
over its mesh: every shard took part).

Two levels:

``redistribute`` / ``redistribute_tree``
    The general form: an array given as its per-device shards under a
    :class:`~.mesh.NamedSharding` (a :class:`Sharded`, or a whole tensor
    taken as replicated) moved to another NamedSharding, possibly on
    other contexts.

``FragLayout`` / ``plan_moves`` / ``reshard_fragments`` / ``place_from_host``
    The flat-fragment path the ZeRO engine needs (``gluon/zero.py``):
    its state is one flat buffer a group and device, fragment ownership a
    permutation (the dcn x ici owner map) no partition spec expresses.
    Plans are made on the host in shard-local coordinates with the
    clamps explicit: a fragment that is all padding moves nothing, and
    destination padding is zeroed from the start, so a parameter smaller
    than one fragment a replica lands exactly.

The ``reshard_fail`` fault site fires at a live plan's entry
(``reshard_fragments``, ``redistribute``, ``Trainer.reshard_to``), so
the degradation to a checkpoint restore can be driven on demand;
``place_from_host``, the restore's own placement, has none.

Counters: ``mx_reshard_transitions_total{kind}``,
``mx_reshard_moved_bytes_total{kind}``, ``mx_reshard_blocks_total{kind}``;
gauges ``mx_reshard_planned_peak_bytes{kind}`` and
``mx_reshard_block_bytes{kind}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..base import MXNetError

__all__ = [
    "ReshardError", "FragLayout", "Move", "plan_moves", "stage_blocks",
    "reshard_fragments", "place_from_host", "gather_to_host",
    "redistribute", "redistribute_tree", "owner_permutation",
    "block_bytes", "peak_live_bytes", "sharding_manifest",
    "transition_programs", "Sharded",
]


class ReshardError(MXNetError):
    """A redistribution plan could not run (geometry mismatch, the
    injected failure, a failed transition check): the live path then
    restores a checkpoint (elastic.py)."""


def block_bytes() -> int:
    """The staged block in bytes (MXNET_ELASTIC_BLOCK)."""
    b = int(config.get("MXNET_ELASTIC_BLOCK"))
    return b if b > 0 else (4 << 20)


def peak_live_bytes(shard_nbytes: int, blk: Optional[int] = None) -> int:
    """The most a staged plan may hold on one device: the destination
    shard it assembles plus one block in flight."""
    return int(shard_nbytes) + int(blk if blk is not None else block_bytes())


def owner_permutation(n: int, n_dcn: int = 0) -> Tuple[int, ...]:
    """Device position -> global fragment, ZeRO's dcn x ici ownership:
    position p of ``n_dcn`` slices owns ``(p % n_ici) * n_dcn + p //
    n_ici``; flat (``n_dcn`` 0 or 1) is the identity."""
    if n_dcn and n_dcn > 1:
        if n % n_dcn:
            raise ReshardError("n_dcn=%d does not divide n=%d"
                               % (n_dcn, n))
        n_ici = n // n_dcn
        return tuple((p % n_ici) * n_dcn + (p // n_ici) for p in range(n))
    return tuple(range(n))


@dataclass(frozen=True)
class FragLayout:
    """The flat-fragment layout of one array of ``size`` elements over
    ``n`` devices: fragments of ``ceil(size / n)`` (the tail padded),
    device position p owning global fragment ``owner[p]`` at ``offset``
    of its shard buffer (ZeRO packs many parameters into one)."""
    size: int
    n: int
    owner: Tuple[int, ...]
    offset: int = 0

    @property
    def frag(self) -> int:
        return -(-self.size // self.n) if self.size else 0

    @classmethod
    def build(cls, size: int, n: int, n_dcn: int = 0,
              offset: int = 0) -> "FragLayout":
        return cls(int(size), int(n), owner_permutation(n, n_dcn),
                   int(offset))

    def data_extent(self, r: int) -> Tuple[int, int]:
        """Global ``[lo, hi)`` of the real data in fragment ``r``; a
        fragment past the data (``hi == lo``) is all padding."""
        lo = r * self.frag
        hi = min(self.size, lo + self.frag)
        return (lo, max(lo, hi))

    def pos_of(self, r: int) -> int:
        """The device position holding global fragment ``r``."""
        return self.owner.index(r)


class Move(NamedTuple):
    """One contiguous copy in shard-local elements: source shard
    ``src_pos`` ``[src_lo, src_hi)`` to destination shard ``dst_pos`` at
    ``dst_lo`` (the offsets folded in)."""
    src_pos: int
    src_lo: int
    src_hi: int
    dst_pos: int
    dst_lo: int

    @property
    def elems(self) -> int:
        return self.src_hi - self.src_lo


def plan_moves(src: FragLayout, dst: FragLayout) -> List[Move]:
    """The host-side move plan of one array between two fragment
    layouts: each move the intersection of a source and a destination
    data extent in global coordinates, in shard-local ones; padding
    never moves."""
    if src.size != dst.size:
        raise ReshardError("reshard size mismatch: src=%d dst=%d"
                           % (src.size, dst.size))
    moves: List[Move] = []
    if src.size == 0:
        return moves
    for dp in range(dst.n):
        dr = dst.owner[dp]
        dlo, dhi = dst.data_extent(dr)
        if dhi <= dlo:
            continue                      # the destination is padding
        fs = src.frag
        for sr in range(dlo // fs, (dhi - 1) // fs + 1):
            slo, shi = src.data_extent(sr)
            lo, hi = max(dlo, slo), min(dhi, shi)
            if hi <= lo:
                continue
            sp = src.pos_of(sr)
            moves.append(Move(
                sp, src.offset + (lo - sr * fs),
                src.offset + (hi - sr * fs),
                dp, dst.offset + (lo - dr * dst.frag)))
    return moves


def stage_blocks(moves: Sequence[Move],
                 block_elems: int) -> List[List[Move]]:
    """The moves in staged blocks of at most ``block_elems`` elements
    each; a move larger than a block is split, so the bound holds for
    one giant fragment too."""
    block_elems = max(1, int(block_elems))
    split: List[Move] = []
    for m in moves:
        lo = m.src_lo
        dlo = m.dst_lo
        while lo < m.src_hi:
            hi = min(m.src_hi, lo + block_elems)
            split.append(Move(m.src_pos, lo, hi, m.dst_pos, dlo))
            dlo += hi - lo
            lo = hi
    blocks: List[List[Move]] = []
    cur: List[Move] = []
    cur_elems = 0
    for m in split:
        if cur and cur_elems + m.elems > block_elems:
            blocks.append(cur)
            cur, cur_elems = [], 0
        cur.append(m)
        cur_elems += m.elems
    if cur:
        blocks.append(cur)
    return blocks


# ----------------------------------------------------------------------
# the transition check on the destination set
# ----------------------------------------------------------------------
_TRANSITIONS: Dict[tuple, object] = {}


def transition_programs() -> int:
    """How many distinct transition geometries this process has
    checked."""
    return len(_TRANSITIONS)


def _contexts(devices) -> list:
    """Destination devices as contexts: contexts pass through; a torch
    device maps to gpu(i), or to the next cpu(k) not taken yet."""
    from ..context import Context
    out, cpus = [], 0
    for d in devices:
        if isinstance(d, Context):
            out.append(d)
        elif isinstance(d, torch.device) and d.type == "cuda":
            out.append(Context("gpu", d.index or 0))
        else:
            out.append(Context("cpu", cpus))
            cpus += 1
    return out


def _transition(ctxs, key, label):
    """The destination set's check: every device adds 1 in one
    all-reduce over a mesh of the contexts (an exact int32 count);
    raises ReshardError unless it is the device count."""
    from .. import commwatch, telemetry
    from . import _spmd
    from .mesh import contexts_mesh
    from . import collectives as coll
    n = len(ctxs)
    _TRANSITIONS.setdefault(key, True)
    if len(set(ctxs)) == n and n > 1:
        run = _spmd.Run(contexts_mesh(ctxs),
                        collector=commwatch.current_collector())

        def one(m):
            t = torch.ones((), dtype=torch.int32, device=m.torch_device)
            return int(coll.allreduce_sum(t, "dp"))
        got = run.execute(one)[0]
    else:
        got = n
    if got != n:
        raise ReshardError("reshard transition check failed for %r: "
                           "psum(shards)=%d expected %d" % (label, got, n))
    telemetry.counter("mx_reshard_transitions_total", kind=label).inc()


def _note_peak(dst_shard_nbytes: int, blk_bytes: int, label: str):
    from .. import telemetry
    telemetry.gauge("mx_reshard_planned_peak_bytes", kind=label).set(
        peak_live_bytes(dst_shard_nbytes, blk_bytes))
    telemetry.gauge("mx_reshard_block_bytes", kind=label).set(blk_bytes)


# ----------------------------------------------------------------------
# the fragment path (ZeRO)
# ----------------------------------------------------------------------
def reshard_fragments(src_bufs, moves: Sequence[Move], n_dst: int,
                      dst_shard_len: int, dst_devices,
                      blk_bytes: Optional[int] = None,
                      label: str = "fragments"):
    """Run a fragment move plan device to device: each destination shard
    is allocated once, zeroed (its padding and holes stay zero), and the
    staged blocks' pieces are copied into it slice to slice (a copy
    across devices goes straight into the destination, one block at a
    time), then the transition check runs on the destination set.
    Returns the ``(dst_shard_len,)`` tensors in ``dst_devices`` order.

    ``src_bufs`` are the source shards, one 1-D tensor a source
    position; a shard no move reads is never touched. A destination
    device holds at most its shard plus one block in flight
    (:func:`peak_live_bytes`)."""
    from .. import faultinject
    from .. import telemetry
    faultinject.maybe_fail("reshard_fail", ReshardError)
    ctxs = _contexts(dst_devices)
    if n_dst != len(ctxs):
        raise ReshardError("n_dst=%d but %d destination devices"
                           % (n_dst, len(ctxs)))
    dtype = src_bufs[0].dtype if len(src_bufs) else torch.float32
    item = torch.empty((), dtype=dtype).element_size()
    blk = int(blk_bytes if blk_bytes is not None else block_bytes())
    block_elems = max(1, blk // max(1, item))
    _note_peak(int(dst_shard_len) * item, blk, label)

    # the plan checked on the host before any device work: destination
    # spans disjoint and inside the shard
    spans: List[List[Tuple[int, int]]] = [[] for _ in range(n_dst)]
    for m in moves:
        spans[m.dst_pos].append((m.dst_lo, m.dst_lo + m.elems))
    for dp, sp in enumerate(spans):
        sp.sort()
        cursor = 0
        for lo, hi in sp:
            if lo < cursor:
                raise ReshardError(
                    "overlapping moves at dst_pos=%d lo=%d" % (dp, lo))
            cursor = hi
        if cursor > int(dst_shard_len):
            raise ReshardError(
                "move past destination shard at dst_pos=%d: hi=%d > "
                "shard_len=%d" % (dp, cursor, int(dst_shard_len)))

    out = [torch.zeros(int(dst_shard_len), dtype=dtype,
                       device=c.torch_device) for c in ctxs]
    moved = nblocks = 0
    with torch.no_grad():
        for block in stage_blocks(moves, block_elems):
            for m in block:
                out[m.dst_pos][m.dst_lo:m.dst_lo + m.elems].copy_(
                    src_bufs[m.src_pos][m.src_lo:m.src_hi])
                moved += m.elems
            nblocks += 1
    telemetry.counter("mx_reshard_moved_bytes_total", kind=label).inc(
        moved * item)
    telemetry.counter("mx_reshard_blocks_total", kind=label).inc(nblocks)
    _transition(ctxs, ("flat", n_dst, int(dst_shard_len), str(dtype),
                       tuple(ctxs)), label)
    return out


def place_from_host(entries, n: int, shard_len: int, dst_devices,
                    dtype, label: str = "restore"):
    """A checkpoint restore's placement: ``entries`` are ``(flat numpy
    array, FragLayout)`` pairs that share one shard buffer of
    ``shard_len`` elements on ``n`` devices. The shard-local placement
    takes the same clamps as :func:`plan_moves` (tiny parameters exact,
    padding zero); each device then receives its shard in one copy and
    the transition check runs. Returns the ``(shard_len,)`` tensors."""
    from ..base import torch_dtype
    # no reshard_fail site: this is the target a failed live transition
    # degrades to, and it must work while the fault is armed
    np_dt = np.dtype(dtype) if not isinstance(dtype, torch.dtype) else None
    if np_dt is None:
        from ..base import np_dtype
        np_dt = np.dtype(np_dtype(dtype))
    shards = [np.zeros(int(shard_len), np_dt) for _ in range(n)]
    for arr, lay in entries:
        flat = np.asarray(arr).astype(np_dt).reshape(-1)
        if flat.size != lay.size:
            raise ReshardError("restore size mismatch: array=%d layout=%d"
                               % (flat.size, lay.size))
        for p in range(lay.n):
            lo, hi = lay.data_extent(lay.owner[p])
            if hi <= lo:
                continue                   # the fragment is padding
            shards[p][lay.offset:lay.offset + (hi - lo)] = flat[lo:hi]
    ctxs = _contexts(dst_devices)
    from ..ndarray.ndarray import host_tensor
    tdt = torch_dtype(np_dt)
    bufs = [host_tensor(s).to(tdt).to(c.torch_device)
            for s, c in zip(shards, ctxs)]
    _transition(ctxs, ("flat", n, int(shard_len), str(np_dt),
                       tuple(ctxs)), label)
    return bufs


def gather_to_host(src_bufs, layouts) -> List[np.ndarray]:
    """The inverse of :func:`place_from_host`: each layout's whole flat
    array from the shard buffers, one bounded read a fragment."""
    from ..ndarray.ndarray import host_numpy
    out = []
    for lay in layouts:
        full = None
        for p in range(lay.n):
            lo, hi = lay.data_extent(lay.owner[p])
            piece = host_numpy(src_bufs[p][lay.offset:lay.offset
                                           + (hi - lo)].detach().cpu())
            if full is None:
                full = np.zeros(lay.size, piece.dtype)
            if hi > lo:
                full[lo:hi] = piece
        out.append(full if full is not None else np.zeros(0, np.float32))
    return out


# ----------------------------------------------------------------------
# the general form (NamedSharding -> NamedSharding)
# ----------------------------------------------------------------------
class Sharded:
    """An array held as per-device shards under a NamedSharding:
    ``shards`` maps each mesh :class:`~.mesh.Device` to its block (a
    torch tensor on the device's context), ``shape`` is the whole
    array's. :meth:`full` assembles it (tests)."""

    def __init__(self, shards: dict, sharding, shape):
        self.shards = dict(shards)
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        first = next(iter(self.shards.values()))
        self.dtype = first.dtype

    @classmethod
    def from_tensor(cls, t: torch.Tensor, sharding) -> "Sharded":
        """``t`` cut into its blocks under ``sharding``, each placed on
        its device."""
        shape = tuple(t.shape)
        boxes = devices_indices_map(sharding, shape)
        return cls({d: t[tuple(slice(lo, hi) for lo, hi in box)].to(
            d.context.torch_device).clone() for d, box in boxes.items()},
            sharding, shape)

    def full(self) -> torch.Tensor:
        out = None
        boxes = devices_indices_map(self.sharding, self.shape)
        for d, box in boxes.items():
            b = self.shards[d].detach().cpu()
            if out is None:
                out = torch.zeros(self.shape, dtype=b.dtype)
            out[tuple(slice(lo, hi) for lo, hi in box)] = b
        return out


def devices_indices_map(sharding, shape) -> dict:
    """``{Device: ((lo, hi), ...)}``: each mesh device's block of an
    array of ``shape`` under ``sharding`` (a dimension split over n
    devices in blocks of ``ceil(size / n)``, the last ones short)."""
    from . import _spmd
    mesh = sharding.mesh
    names = list(mesh.axis_names)
    sizes = list(mesh.devices.shape)
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(
        tuple(sharding.spec)))
    out = {}
    for idx in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[idx]
        box = []
        for dim, ax in enumerate(spec):
            size = int(shape[dim])
            if ax is None:
                box.append((0, size))
                continue
            pos, n = 0, 1
            for a in _spmd.axes_of(ax):
                i = names.index(a)
                pos = pos * sizes[i] + idx[i]
                n *= sizes[i]
            k = -(-size // n)
            lo = min(size, pos * k)
            box.append((lo, min(size, lo + k)))
        out[dev] = tuple(box)
    return out


def redistribute(x, dst_sharding, blk_bytes: Optional[int] = None,
                 label: str = "array"):
    """Move ``x`` (a :class:`Sharded`, or a whole tensor or NDArray taken
    as replicated on its device) to ``dst_sharding``, possibly on other
    contexts, staged: each destination block is allocated once and only
    the intersecting rectangles of the source blocks are copied into it,
    cut along the leading axis into pieces of at most one block (one
    row step for the whole destination block, so uneven sources keep
    their pieces aligned); then the transition check runs on the
    destination mesh. Returns a :class:`Sharded`."""
    from .. import faultinject
    from .. import telemetry
    faultinject.maybe_fail("reshard_fail", ReshardError)
    if not isinstance(x, Sharded):
        t = x.tensor() if hasattr(x, "tensor") else torch.as_tensor(x)
        src_map = {tuple((0, int(s)) for s in t.shape): t}
        shape, dtype = tuple(int(s) for s in t.shape), t.dtype
    else:
        shape, dtype = x.shape, x.dtype
        src_map = {}
        boxes = devices_indices_map(x.sharding, shape)
        for d, box in boxes.items():       # replicated holders: first wins
            src_map.setdefault(box, x.shards[d])
    item = torch.empty((), dtype=dtype).element_size()
    blk = int(blk_bytes if blk_bytes is not None else block_bytes())
    block_elems = max(1, blk // max(1, item))
    dst_map = devices_indices_map(dst_sharding, shape)
    max_shard = 0
    out = {}
    moved = 0
    with torch.no_grad():
        for dev, dbox in dst_map.items():
            dshape = tuple(hi - lo for lo, hi in dbox)
            shard_elems = int(np.prod(dshape or (1,)))
            max_shard = max(max_shard, shard_elems * item)
            tdev = dev.context.torch_device
            buf = torch.zeros(dshape, dtype=dtype, device=tdev)
            if not shape:
                buf.copy_(next(iter(src_map.values())))
                out[dev] = buf
                continue
            if shard_elems == 0:
                out[dev] = buf
                continue
            inters = []
            for sbox in src_map:
                inter = tuple((max(dl, sl), min(dh, sh))
                              for (dl, dh), (sl, sh) in zip(dbox, sbox))
                if not any(hi <= lo for lo, hi in inter):
                    inters.append((sbox, inter))
            if not inters:
                raise ReshardError(
                    "no source pieces intersect a destination shard of "
                    "shape %s — source and destination arrays disagree"
                    % (dshape,))
            max_row = max(int(np.prod([hi - lo for lo, hi in inter[1:]]
                                      or [1])) for _, inter in inters)
            step = max(1, block_elems // max(1, max_row))
            covered = 0
            for sbox, inter in inters:
                sdata = src_map[sbox]
                lo0, hi0 = inter[0]
                r = lo0
                while r < hi0:
                    r2 = min(hi0, r + step)
                    src_idx = tuple(
                        slice(r - sbox[0][0], r2 - sbox[0][0]) if d == 0
                        else slice(lo - sbox[d][0], hi - sbox[d][0])
                        for d, (lo, hi) in enumerate(inter))
                    dst_idx = tuple(
                        slice(r - dbox[0][0], r2 - dbox[0][0]) if d == 0
                        else slice(lo - dbox[d][0], hi - dbox[d][0])
                        for d, (lo, hi) in enumerate(inter))
                    piece = sdata[src_idx]
                    buf[dst_idx].copy_(piece)
                    covered += piece.numel()
                    r = r2
            if covered != shard_elems:
                raise ReshardError(
                    "source pieces cover %d of %d elements of a "
                    "destination shard of shape %s — source and "
                    "destination arrays disagree"
                    % (covered, shard_elems, dshape))
            moved += covered
            out[dev] = buf
    _note_peak(max_shard, blk, label)
    telemetry.counter("mx_reshard_moved_bytes_total", kind=label).inc(
        moved * item)
    ctxs = [d.context for d in dst_sharding.mesh.devices.flat]
    _transition(ctxs, ("gen", shape, str(dtype),
                       tuple(str(s) for s in dst_sharding.spec),
                       tuple(ctxs)), label)
    return Sharded(out, dst_sharding, shape)


def redistribute_tree(tree, dst_shardings, blk_bytes=None,
                      label: str = "tree"):
    """:func:`redistribute` over a tree (dicts, lists, tuples):
    ``dst_shardings`` one NamedSharding for every leaf or a matching
    tree of them."""
    from .collectives import _tree_leaves, _tree_fill
    from .mesh import NamedSharding
    xs = _tree_leaves(tree)
    if isinstance(dst_shardings, NamedSharding):
        shs = [dst_shardings] * len(xs)
    else:
        shs = _tree_leaves(dst_shardings)
    if len(shs) != len(xs):
        raise ReshardError("dst_shardings does not match tree arity")
    outs = [redistribute(x, s, blk_bytes, label) for x, s in zip(xs, shs)]
    if not isinstance(tree, (dict, list, tuple)):
        return outs[0]
    return _tree_fill(tree, iter(outs))


# ----------------------------------------------------------------------
# the checkpoint's sharding section
# ----------------------------------------------------------------------
def sharding_manifest(trainer) -> dict:
    """The logical-sharding section of a checkpoint's manifest entry:
    enough layout to reshard the saved state onto any set without
    unpickling it: device count, contexts, mesh axes and, under ZeRO,
    each parameter's fragment geometry and the dcn ownership
    permutation."""
    sec = {
        "version": 1,
        "n_devices": len(trainer._contexts),
        "contexts": [str(c) for c in trainer._contexts],
        "mesh_axes": ["dp"],
        "layout": "replicated",
        "partition_spec": None,
        "params": {},
    }
    zero = getattr(trainer, "_zero", None)
    if zero is None or zero is False or isinstance(zero, bool):
        return sec
    sec["layout"] = "zero"
    sec["mesh_axes"] = list(zero._axis_names)
    sec["partition_spec"] = list(zero._axis_names) \
        if zero._dcn_axis else ["dp"]
    sec["owner"] = list(zero._owner)
    sec["n_dcn"] = int(zero._n_dcn)
    sec["quantized"] = bool(zero._quant)
    for it in zero._items:
        sec["params"][it.param.name] = {
            "size": int(it.size), "frag": int(it.frag),
            "offset": int(it.offset), "group": int(it.gi),
        }
    return sec
