"""Collectives over mesh axes, and ``shard_map`` (counterpart of
``mxnet_tpu/parallel/collectives.py``).

The reference's collectives are XLA's, inside a ``shard_map``-ped
program. Here :func:`shard_map` runs the function once per local mesh
device (:mod:`._spmd`), on that device's block of each input, and a
collective called there meets the same call of the other devices of its
group: the devices whose mesh coordinates differ only along the named
axis (or tuple of axes, ordered row-major in the order given). Each
collective takes and returns an NDArray (or a torch tensor) on the
calling device; ``ring_permute``, ``all_to_all`` and the ``hierarchical_*``
forms keep the reference's order and padding. ``ring_permute`` and
``all_to_all`` are differentiable (the pipeline's and MoE's gradients
run through them), their backward exchanges keyed as :mod:`._spmd`
says.

Each call is recorded into :mod:`mxnet_tpu_torch.commwatch` once
(:func:`_watch`: op, axis, bytes, participants), as the reference
records each traced call. ``quant=`` (a
:class:`~.quantize.QuantConfig`) puts a hierarchical all-reduce on the
quantized wire of :mod:`.quantize`, its payload recorded at its 1-byte
dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from . import _spmd

# once-per-process warning of a quantized sync without error feedback
_LOSSY_SYNC_WARNED = False

__all__ = ["allreduce_sum", "allreduce_mean", "allgather", "reduce_scatter",
           "ring_permute", "barrier_sum", "all_to_all", "axis_size",
           "hierarchical_allreduce", "hierarchical_grad_sync",
           "hierarchical_reduce_scatter", "hierarchical_allgather",
           "pad_to_multiple", "shard_owner_index", "shard_map"]


def _member(what: str) -> "_spmd.Member":
    m = _spmd.member()
    if m is None:
        raise MXNetError("%s runs inside shard_map or a sharded step, on a "
                         "mesh device" % what)
    return m


def _unwrap(x):
    """``(tensor, rewrap)`` of an NDArray or a tensor."""
    from ..ndarray import NDArray
    if isinstance(x, NDArray):
        ctx = x.context
        return x.tensor(), (lambda t: NDArray(t, ctx))
    if isinstance(x, torch.Tensor):
        return x, (lambda t: t)
    t = torch.as_tensor(np.asarray(x))
    return t, (lambda t: t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _label(t):
    from .. import commwatch
    return commwatch.wire_dtype_label(t.dtype)


def _watch(op: str, t: torch.Tensor, n: int, nbytes: Optional[int] = None,
           count: int = 1):
    """The commwatch record of one collective of ``t`` over ``n``
    devices (``nbytes`` overrides the payload)."""
    return (op, _nbytes(t) if nbytes is None else nbytes, _label(t), count)


def traced(watch, axis_name, n: int):
    """Record ``watch`` (a :func:`_watch` tuple) once for this run, from
    its first local device, without an exchange: the charge of a loop
    whose exchanges run unrecorded (the reference records its scan
    body's collectives once, charged for every tick)."""
    m = _member("traced")
    if m.pos != 0 or n <= 1:
        return
    from .. import commwatch
    op, nbytes, label, count = watch
    axes = _spmd.axes_of(axis_name)
    commwatch.traced_collective(op, axes if len(axes) > 1 else axes[0],
                                None, n, count=count, nbytes=nbytes,
                                dtype=label)


def axis_size(axis_name) -> int:
    """The size of a mesh axis (or the product over a tuple of axes)."""
    return _member("axis_size").axis_size(axis_name)


def _axis_index(axis_name) -> int:
    return _member("axis_index").axis_index(axis_name)


def pvary(x, axis_name):
    """The identity (the reference marks a value as varying over an axis
    for shard_map's replication checker; the port has none)."""
    return x


def allreduce_sum(x, axis_name):
    """The sum over the group (ref: psum)."""
    m = _member("allreduce_sum")
    t, wrap = _unwrap(x)
    n = m.axis_size(axis_name)
    return wrap(m.run.exchange(m, "sum", axis_name, t,
                               _watch("allreduce", t, n)))


def allreduce_mean(x, axis_name):
    """The mean over the group (ref: pmean)."""
    m = _member("allreduce_mean")
    t, wrap = _unwrap(x)
    n = m.axis_size(axis_name)
    total = m.run.exchange(m, "sum", axis_name, t, _watch("allreduce", t, n))
    return wrap(total / n)


def allgather(x, axis_name, axis: int = 0, tiled: bool = True):
    """The group's blocks in group order, concatenated along ``axis``
    (``tiled``) or stacked on a new ``axis``. The recorded payload is the
    whole gathered output (NCCL-tests' message size)."""
    m = _member("allgather")
    t, wrap = _unwrap(x)
    n = m.axis_size(axis_name)
    vals = m.run.exchange(m, "gather", axis_name, t,
                          _watch("allgather", t, n, _nbytes(t) * n))
    return wrap(torch.cat(vals, dim=axis) if tiled
                else torch.stack(vals, dim=axis))


def reduce_scatter(x, axis_name, scatter_axis: int = 0):
    """The group's sum, split along ``scatter_axis`` into one block a
    device, this device's block (ref: psum_scatter, tiled)."""
    m = _member("reduce_scatter")
    t, wrap = _unwrap(x)
    n = m.axis_size(axis_name)
    if t.shape[scatter_axis] % n:
        raise MXNetError("reduce_scatter: dimension %d of %s does not "
                         "divide over %d devices (pad_to_multiple)"
                         % (scatter_axis, tuple(t.shape), n))
    total = m.run.exchange(m, "sum", axis_name, t,
                           _watch("reduce_scatter", t, n))
    k = t.shape[scatter_axis] // n
    i = m.axis_index(axis_name)
    return wrap(total.narrow(scatter_axis, i * k, k).clone())


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _permute(m, t, axis_name, shift, watch=None, key=None):
    n = m.axis_size(axis_name)
    vals = m.run.exchange(m, "gather", axis_name, t.detach(), watch,
                          key=key)
    j = m.axis_index(axis_name)
    return vals[(j - shift) % n].clone()


class _RingPermute(torch.autograd.Function):
    """:func:`ring_permute` on the tape: the backward sends the
    cotangent back by ``-shift``. The member is captured at forward (a
    card's backward runs on autograd's device thread, where no member is
    bound), and the backward exchange is keyed by the forward's sequence
    number (:mod:`._spmd`)."""

    @staticmethod
    def forward(ctx, t, m, axis_name, shift, watch):
        ctx.m, ctx.axis, ctx.shift = m, axis_name, shift
        ctx.seq = m.seq
        return _permute(m, t, axis_name, shift, watch)

    @staticmethod
    def backward(ctx, g):
        m = ctx.m
        return (_permute(m, g.contiguous(), ctx.axis, -ctx.shift,
                         key=("ring_permute", ctx.seq)),
                None, None, None, None)


def ring_permute(x, axis_name, shift: int = 1, *, watch_count: int = 1):
    """Device i's block goes to device (i + shift) mod n (ref: ppermute
    on the ring); differentiable, its backward the permute by
    ``-shift``. ``watch_count`` charges the record that many runs (0
    records nothing: the later ticks of a loop whose first tick charged
    them all, as the reference's scan body is traced once)."""
    m = _member("ring_permute")
    t, wrap = _unwrap(x)
    n = m.axis_size(axis_name)
    watch = _watch("ppermute", t, n, count=watch_count) if watch_count \
        else None
    if _differentiable(t):
        return wrap(_RingPermute.apply(t, m, axis_name, shift, watch))
    return wrap(_permute(m, t, axis_name, shift, watch))


def _a2a(m, t, axis_name, split_axis, concat_axis, tiled, watch=None,
         key=None):
    n = m.axis_size(axis_name)
    if t.shape[split_axis] % n:
        raise MXNetError("all_to_all: dimension %d of %s does not divide "
                         "over %d devices" % (split_axis, tuple(t.shape), n))
    vals = m.run.exchange(m, "gather", axis_name, t.detach(), watch, key=key)
    j = m.axis_index(axis_name)
    k = t.shape[split_axis] // n
    chunks = [v.narrow(split_axis, j * k, k) for v in vals]
    if tiled:
        return torch.cat(chunks, dim=concat_axis).contiguous()
    return torch.stack([c.squeeze(split_axis) for c in chunks],
                       dim=concat_axis).contiguous()


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` on the tape: the backward is the all-to-all
    with the split and concat axes swapped, keyed as
    :class:`_RingPermute`'s."""

    @staticmethod
    def forward(ctx, t, m, axis_name, split_axis, concat_axis, tiled, watch):
        ctx.m, ctx.axis = m, axis_name
        ctx.axes = (split_axis, concat_axis, tiled)
        ctx.seq = m.seq
        return _a2a(m, t, axis_name, split_axis, concat_axis, tiled, watch)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, tiled = ctx.axes
        return (_a2a(ctx.m, g.contiguous(), ctx.axis, concat_axis,
                     split_axis, tiled, key=("all_to_all", ctx.seq)),
                None, None, None, None, None, None)


def all_to_all(x, axis_name, split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = False):
    """Each device splits its block along ``split_axis`` into n chunks
    and sends chunk j to device j; the received chunks, in source order,
    are concatenated along ``concat_axis`` (``tiled``), or, untiled (the
    split axis of size n), stacked on a new ``concat_axis`` with the
    split axis removed (ref: lax.all_to_all). Differentiable: the
    backward swaps the two axes."""
    m = _member("all_to_all")
    t, wrap = _unwrap(x)
    watch = _watch("all_to_all", t, m.axis_size(axis_name))
    if _differentiable(t):
        return wrap(_AllToAll.apply(t, m, axis_name, split_axis,
                                    concat_axis, tiled, watch))
    return wrap(_a2a(m, t, axis_name, split_axis, concat_axis, tiled, watch))


def barrier_sum(axis_name):
    """The number of devices in the group, as a psum of ones (a 0-d
    float32 NDArray)."""
    m = _member("barrier_sum")
    from ..ndarray import NDArray
    one = torch.ones((), dtype=torch.float32, device=m.torch_device)
    n = m.axis_size(axis_name)
    return NDArray(m.run.exchange(m, "sum", axis_name, one,
                                  _watch("allreduce", one, n)),
                   m.device.context)


def pad_to_multiple(x, n: int, axis: int = 0):
    """Zero-pad ``x`` along ``axis`` up to the next multiple of ``n``."""
    t, wrap = _unwrap(x)
    size = t.shape[axis]
    pad = (-size) % n
    if not pad:
        return x
    shape = list(t.shape)
    shape[axis] = pad
    return wrap(torch.cat([t, t.new_zeros(shape)], dim=axis))


def shard_owner_index(ici_axis: str = "dp", dcn_axis: Optional[str] = None):
    """The global shard index this device owns after
    :func:`hierarchical_reduce_scatter`: its ici rank, or
    ``ici * n_dcn + dcn`` with a dcn axis (a permutation of the flat
    device order)."""
    if dcn_axis is None:
        return _axis_index(ici_axis)
    return _axis_index(ici_axis) * axis_size(dcn_axis) + _axis_index(dcn_axis)


def hierarchical_reduce_scatter(x, ici_axis: str = "dp",
                                dcn_axis: Optional[str] = None,
                                scatter_axis: int = 0):
    """Reduce-scatter over the in-process axis, then over ``dcn_axis``:
    the cross-process tier carries 1/n_ici of the payload. The shard's
    global index is :func:`shard_owner_index`."""
    shard = reduce_scatter(x, ici_axis, scatter_axis=scatter_axis)
    if dcn_axis is None:
        return shard
    return reduce_scatter(shard, dcn_axis, scatter_axis=scatter_axis)


def hierarchical_allgather(x, ici_axis: str = "dp",
                           dcn_axis: Optional[str] = None, axis: int = 0):
    """The inverse of :func:`hierarchical_reduce_scatter`'s placement:
    gather over ``dcn_axis`` first, then over the in-process axis."""
    if dcn_axis is not None:
        x = allgather(x, dcn_axis, axis=axis)
    return allgather(x, ici_axis, axis=axis)


def hierarchical_allreduce(x, ici_axis: str = "dp", dcn_axis: str = "dcn",
                           scatter_axis: int = 0, quant=None,
                           residual=None):
    """All-reduce staged for the process hierarchy: reduce-scatter over
    ``ici_axis``, all-reduce the 1/n_ici shard over ``dcn_axis``,
    all-gather over ``ici_axis``. ``x.shape[scatter_axis]`` must divide
    by the ici axis size.

    ``quant`` (a QuantConfig) runs the quantized all-reduce of
    :mod:`.quantize` instead, on a flat 1-D ``x``: the hops
    ``quant.tier`` selects carry the 1-byte payload. With ``residual``
    (f32, shaped like ``x``) the rounding error is carried and
    ``(out, new_residual)`` comes back."""
    if quant is not None:
        t, wrap = _unwrap(x)
        if t.dim() != 1 or scatter_axis != 0:
            raise ValueError("quantized hierarchical_allreduce needs a "
                             "flat 1-D buffer (got shape %r, "
                             "scatter_axis=%d)" % (tuple(t.shape),
                                                   scatter_axis))
        from . import quantize as qz
        res = None if residual is None else _unwrap(residual)[0]
        out, new_res = qz.quantized_allreduce(t, ici_axis, dcn_axis, quant,
                                              residual=res)
        if residual is not None:
            return wrap(out), wrap(new_res)
        return wrap(out)
    shard = reduce_scatter(x, ici_axis, scatter_axis=scatter_axis)
    shard = allreduce_sum(shard, dcn_axis)
    return allgather(shard, ici_axis, axis=scatter_axis)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _tree_leaves(tree[k])
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out += _tree_leaves(v)
        return out
    return [tree]


def _tree_fill(tree, it):
    if isinstance(tree, dict):
        return {k: _tree_fill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_fill(v, it) for v in tree)
    return next(it)


def hierarchical_grad_sync(grads, ici_axis: str = "dp",
                           dcn_axis: str = "dcn", quant=None,
                           residual=None):
    """All-reduce a tree of gradients (dicts, lists, tuples of arrays)
    over dcn x ici with one fused hierarchical exchange per dtype: the
    leaves flattened into one buffer, padded to a multiple of the ici
    axis size, reduce_scatter(ici) -> allreduce(dcn) -> allgather(ici),
    and unpacked. A ``residual`` tree (f32) is flushed into this exact
    sync and comes back as zeros (``(synced, zeros)``).

    ``quant`` (a QuantConfig, or ``"env"`` for the environment's) puts
    the float buffers of at most 32 bits on the quantized wire; with a
    ``residual`` the rounding error is carried (``(synced,
    new_residual)``), without one it is dropped, with one warning a
    process. The default is off whatever the environment says: a caller
    without a residual would lose each call's error."""
    if quant == "env":
        from . import quantize as qz
        quant = qz.from_env()
    if quant is not None and residual is None:
        global _LOSSY_SYNC_WARNED
        if not _LOSSY_SYNC_WARNED:
            _LOSSY_SYNC_WARNED = True
            import logging
            logging.getLogger("mxnet_tpu_torch.parallel").warning(
                "hierarchical_grad_sync: quantized wire WITHOUT an "
                "error-feedback residual; each call's rounding error is "
                "dropped. Fine for a one-shot sync; pass residual= in a "
                "training loop.")
    leaves = _tree_leaves(grads)
    if not leaves:
        return (grads, residual) if residual is not None else grads
    pairs = [_unwrap(g) for g in leaves]
    ts = [p[0] for p in pairs]
    res_ts = None
    if residual is not None:
        res_ts = [_unwrap(r)[0] for r in _tree_leaves(residual)]
        if len(res_ts) != len(ts):
            raise ValueError("residual pytree does not match grads")
    n_ici = axis_size(ici_axis)
    by_dtype = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = [None] * len(ts)
    new_res = [None] * len(ts)
    for dt, idxs in by_dtype.items():
        flat = torch.cat([ts[i].reshape(-1) for i in idxs])
        flat = pad_to_multiple(flat, n_ici)
        quantizable = quant is not None and dt.is_floating_point and \
            torch.finfo(dt).bits <= 32
        rflat = None
        if res_ts is not None and dt.is_floating_point:
            rflat = pad_to_multiple(torch.cat(
                [res_ts[i].reshape(-1).float() for i in idxs]), n_ici)
        rnew = None
        if quantizable:
            synced, rnew = hierarchical_allreduce(
                flat, ici_axis, dcn_axis, quant=quant,
                residual=rflat if rflat is not None
                else torch.zeros(flat.shape, dtype=torch.float32,
                                 device=flat.device))
            flat = synced.to(dt)
        else:
            if rflat is not None:
                # quantize resolved off while the caller carries a
                # residual: flush it into this sync, return zeros
                flat = (flat.float() + rflat).to(dt)
            flat = hierarchical_allreduce(flat, ici_axis, dcn_axis)
        off = 0
        for i in idxs:
            n = ts[i].numel()
            out[i] = pairs[i][1](flat[off:off + n].reshape(ts[i].shape))
            if res_ts is not None:
                new_res[i] = pairs[i][1](
                    rnew[off:off + n].reshape(ts[i].shape)
                    if rnew is not None else torch.zeros(
                        ts[i].shape, dtype=torch.float32,
                        device=ts[i].device))
            off += n
    synced = _tree_fill(grads, iter(out))
    if residual is not None:
        return synced, _tree_fill(residual, iter(new_res))
    return synced


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------
def _is_spec(s) -> bool:
    from .mesh import P
    return s is None or isinstance(s, P)


def _spec_tree(specs, tree):
    """``specs`` broadcast over ``tree`` as a prefix (a single spec
    covers every leaf below it)."""
    if _is_spec(specs):
        return [specs] * len(_tree_leaves(tree))
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _spec_tree(specs[k], tree[k])
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for s, v in zip(specs, tree):
            out += _spec_tree(s, v)
        return out
    raise MXNetError("shard_map: spec %r does not match %r" % (specs, tree))


def _to_tensor(x) -> torch.Tensor:
    from ..ndarray import NDArray
    if isinstance(x, NDArray):
        return x.tensor()
    if isinstance(x, torch.Tensor):
        return x
    from ..ndarray import host_tensor
    return host_tensor(np.asarray(x))


def block_of(t: torch.Tensor, spec, run, coords) -> torch.Tensor:
    """The block of the whole array ``t`` that the device at ``coords``
    holds under ``spec``."""
    if spec is None:
        return t
    for dim, ax in enumerate(tuple(spec)):
        if ax is None:
            continue
        axes = _spmd.axes_of(ax)
        n = run.axis_size(axes)
        if t.shape[dim] % n:
            raise MXNetError("dimension %d of %s does not divide over the "
                             "%d devices of %s" % (dim, tuple(t.shape), n,
                                                   axes))
        k = t.shape[dim] // n
        t = t.narrow(dim, run.group_position(coords, axes) * k, k)
    return t


def assemble(blocks, spec, run) -> torch.Tensor:
    """The whole array from the local devices' ``blocks`` (in local
    order) under ``spec``: each block written at its place, a dimension
    kept whole taken from the first device."""
    first = blocks[0]
    if spec is None or all(a is None for a in tuple(spec)):
        return first
    shape = list(first.shape)
    for dim, ax in enumerate(tuple(spec)):
        if ax is not None:
            shape[dim] *= run.axis_size(_spmd.axes_of(ax))
    out = first.new_empty(shape)
    filled = set()
    for m, b in zip(run.members, blocks):
        idx = []
        view = out
        for dim, ax in enumerate(tuple(spec)):
            if ax is None:
                continue
            axes = _spmd.axes_of(ax)
            i = run.group_position(m.coords, axes)
            k = b.shape[dim]
            view = view.narrow(dim, i * k, k)
            idx.append(i)
        if tuple(idx) in filled:
            continue
        filled.add(tuple(idx))
        view.copy_(b.to(out.device))
    need = 1
    for ax in tuple(spec):
        if ax is not None:
            need *= run.axis_size(_spmd.axes_of(ax))
    if len(filled) != need:
        raise MXNetError("shard_map: %d of %d blocks of an output are in "
                         "this process; assembling blocks of other "
                         "processes is not supported" % (len(filled), need))
    return out


def shard_map(f, mesh=None, in_specs=None, out_specs=None, **kwargs):
    """``f`` run once per local device of ``mesh`` on that device's block
    of each argument (``in_specs``: one spec an argument, or one for all;
    a spec covers every leaf of a dict/list/tuple argument below it), as
    NDArrays on the device's context; the outputs assembled from the
    blocks by ``out_specs`` into NDArrays. The reference's other keywords
    (``check_rep``, ``check_vma``) are accepted and ignored."""
    if mesh is None:
        raise MXNetError("shard_map needs mesh=")

    def wrapped(*args):
        from .. import commwatch
        from ..ndarray import NDArray
        specs = in_specs
        if _is_spec(specs) or (isinstance(specs, (list, tuple))
                               and len(args) != len(specs)):
            specs = tuple([specs] * len(args))
        leaves = _tree_leaves(list(args))
        lspecs = _spec_tree(list(specs), list(args))
        tensors = [_to_tensor(x) for x in leaves]
        run = _spmd.Run(mesh, collector=commwatch.current_collector())
        outs_fmt = []

        def body(m):
            ctx = m.device.context
            dev = m.torch_device
            blocks = [NDArray(block_of(t, s, run, m.coords).to(dev), ctx)
                      for t, s in zip(tensors, lspecs)]
            local = _tree_fill(list(args), iter(blocks))
            with ctx:
                out = f(*local)
            if m.pos == 0:
                outs_fmt.append(out)
            return [_to_tensor(o) for o in _tree_leaves(out)]
        results = run.execute(body)
        fmt = outs_fmt[0]
        ospecs = _spec_tree(out_specs, fmt)
        whole = [assemble([r[i] for r in results], s, run)
                 for i, s in enumerate(ospecs)]
        ctx = run.members[0].device.context
        return _tree_fill(fmt, iter([NDArray(t, ctx) for t in whole]))
    return wrapped
