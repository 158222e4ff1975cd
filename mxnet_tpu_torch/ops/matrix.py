"""Shape, indexing and product operators (counterpart of
``mxnet_tpu/ops/matrix.py``; ref: src/operator/tensor/matrix_op-inl.h,
dot.cc, indexing_op.cc).

``dot`` and ``batch_dot`` are a plain ``torch.matmul``, as the reference
leaves its products to XLA outside any kernel. Index ops keep the
reference's out-of-range rules: ``take`` clips or wraps, ``Embedding``
gives a NaN row for an id past the table and wraps a negative one (what
``jnp.take`` does), ``one_hot`` gives a zero row. Nothing asserts on the
card and nothing syncs with the host.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """Matrix product; inputs past 2-D are flattened to 2-D as MXNet's
    dot does."""
    a, b = lhs, rhs
    if a.dim() > 2:
        a = a.reshape(-1, a.shape[-1]) if not transpose_a \
            else a.reshape(a.shape[0], -1)
    if transpose_a:
        a = a.t()
    if b.dim() > 2:
        b = b.reshape(b.shape[0], -1) if not transpose_b \
            else b.reshape(-1, b.shape[-1])
    if transpose_b:
        b = b.t()
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b).reshape(1)
    return torch.matmul(a, b)


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


def _reshape_target(src, shp, reverse=False):
    """MXNet reshape codes 0 (keep), -1 (infer), -2 (rest), -3 (merge
    two), -4 (split) — ref: matrix_op-inl.h :: InferReshapeShape."""
    src = list(src)
    shp = tuple(int(s) for s in shp)
    if reverse:
        src = src[::-1]
        shp = tuple(reversed(shp))
    out = []
    i = 0
    j = 0
    while j < len(shp):
        s = shp[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shp[j + 1], shp[j + 2]
            cur = src[i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", aliases=["reshape"])
def reshape(data, *, shape=None, reverse=False):
    return data.reshape(_reshape_target(data.shape, shape, reverse))


@register("Flatten", aliases=["flatten"])
def flatten_op(data):
    return data.reshape(data.shape[0], -1)


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("transpose")
def transpose(data, *, axes=None):
    if axes is None or tuple(axes) == ():
        return data.permute(*reversed(range(data.dim())))
    return data.permute(*(int(a) for a in axes))


@register("expand_dims")
def expand_dims(data, *, axis):
    return data.unsqueeze(int(axis))


@register("squeeze")
def squeeze(data, *, axis=None):
    if axis is None:
        return data.squeeze()
    ax = axis if isinstance(axis, (tuple, list)) else (axis,)
    return data.squeeze(tuple(int(a) for a in ax))


@register("swapaxes", aliases=["SwapAxis"])
def swapaxes(data, *, dim1=0, dim2=0):
    return data.transpose(int(dim1), int(dim2))


@register("Concat", aliases=["concat"])
def concat(*data, dim=1):
    return torch.cat(data, dim=int(dim))


@register("split", aliases=["SliceChannel"])
def split(data, *, num_outputs, axis=1, squeeze_axis=False):
    parts = torch.chunk(data, int(num_outputs), dim=int(axis))
    if squeeze_axis:
        parts = [p.squeeze(int(axis)) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("slice", aliases=["crop"])
def slice_op(data, *, begin, end, step=None):
    nd = data.dim()
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step) + (None,) * (nd - len(step)) if step else (None,) * nd
    idx = tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))
    if any(s is not None and s < 0 for s in step):
        # torch has no negative step: flip, then slice the flipped axis
        out = data
        for ax, sl in enumerate(idx):
            if sl.step is not None and sl.step < 0:
                n = out.shape[ax]
                lo, hi, st = sl.indices(n)
                pos = torch.arange(lo, hi, st, device=data.device)
                out = out.index_select(ax, pos)
            elif sl != slice(None):
                out = out[(slice(None),) * ax + (sl,)]
        return out
    return data[idx]


@register("slice_axis")
def slice_axis(data, *, axis, begin, end):
    ax = int(axis) % data.dim()
    idx = [slice(None)] * data.dim()
    idx[ax] = slice(begin, end)
    return data[tuple(idx)]


@register("slice_like")
def slice_like(data, shape_like, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a % data.dim()] = slice(0, shape_like.shape[a % shape_like.dim()])
    return data[tuple(idx)]


@register("tile")
def tile(data, *, reps):
    return torch.tile(data, tuple(int(r) for r in reps))


@register("repeat")
def repeat(data, *, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), int(repeats))
    return torch.repeat_interleave(data, int(repeats), dim=int(axis))


@register("flip", aliases=["reverse"])
def flip(data, *, axis):
    ax = axis if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(data, tuple(int(a) for a in ax))


@register("broadcast_to")
def broadcast_to(data, *, shape):
    tgt = tuple(int(s) if int(s) != 0 else data.shape[i]
                for i, s in enumerate(shape))
    return data.expand(tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return lhs.expand(rhs.shape)


@register("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, *, axis, size):
    ax = axis if isinstance(axis, (tuple, list)) else (axis,)
    sz = size if isinstance(size, (tuple, list)) else (size,)
    tgt = list(data.shape)
    for a, n in zip(ax, sz):
        tgt[int(a)] = int(n)
    return data.expand(tuple(tgt))


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


def _fill_value(dtype):
    """What ``jnp.take`` fills an out-of-range row with: NaN, or the
    least value of an integer dtype."""
    if dtype.is_floating_point:
        return float("nan")
    return torch.iinfo(dtype).min


class _GatherRows(torch.autograd.Function):
    """``weight.index_select(0, idx)`` whose backward adds the rows'
    gradients with ``index_put_(accumulate=True)``, which sorts the ids
    and adds each table row's contributions in one order, the same from
    run to run (``index_select``'s own backward, ``index_add_``, adds
    them with atomics on the card, and ``F.embedding``'s does too past a
    few thousand ids)."""

    @staticmethod
    def forward(ctx, weight, idx):
        ctx.save_for_backward(idx)
        ctx.weight_shape = weight.shape
        return weight.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        dw = torch.zeros(ctx.weight_shape, dtype=grad.dtype,
                         device=grad.device)
        dw.index_put_((idx,), grad, accumulate=True)
        return dw, None


@register("Embedding")
def embedding(data, weight, *, input_dim, output_dim, dtype="float32",
              sparse_grad=False):
    """Row gather (ref: indexing_op.cc :: Embedding); float ids are
    truncated to integers as in the reference, and get no gradient. An
    id in [-input_dim, 0) wraps, one outside [-input_dim, input_dim)
    gives a NaN row whose gradient goes nowhere, as the reference's
    ``jnp.take`` does: the ids are clamped, the rows gathered, then the
    out-of-range rows replaced (no device assert, no host sync). The
    weight's gradient is the scatter-add of the rows' gradients, the
    same from run to run (:class:`_GatherRows`)."""
    idx = data.to(torch.int64)
    n = weight.shape[0]
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    rows = _GatherRows.apply(weight, safe.reshape(-1)).reshape(
        tuple(idx.shape) + (weight.shape[1],))
    fill = torch.full((), _fill_value(weight.dtype), dtype=weight.dtype,
                      device=weight.device)
    return torch.where(valid.unsqueeze(-1), rows, fill)


@register("take")
def take(a, indices, *, axis=0, mode="clip"):
    """``a`` gathered along ``axis``; an index out of range is clipped
    (``mode='clip'``) or wrapped (else), as the reference's take."""
    ax = int(axis) % a.dim()
    n = a.shape[ax]
    idx = indices.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:ax]) + tuple(idx.shape)
                       + tuple(a.shape[ax + 1:]))


@register("one_hot")
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """One-hot rows of ``depth``; an index outside [0, depth) gives a
    row of ``off_value``, as jax.nn.one_hot does."""
    idx = indices.to(torch.int64).unsqueeze(-1)
    oh = (idx == torch.arange(int(depth), device=idx.device)).to(
        torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


@register("gather_nd")
def gather_nd(data, indices):
    idx = indices.to(torch.int64)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    ax = int(axis)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    steps = torch.arange(data.shape[ax], device=data.device).reshape(shape)
    batch_axis = 1 if ax == 0 else 0
    lshape = [1] * data.dim()
    lshape[batch_axis] = data.shape[batch_axis]
    lens = sequence_length.reshape(lshape)
    fill = torch.full((), value, dtype=data.dtype, device=data.device)
    return torch.where(steps < lens, data, fill)


@register("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """data[..., index, ...] along ``axis`` (ref: matrix.py :: pick);
    out-of-range indices are clipped, as in the reference."""
    ax = int(axis) % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)


@register("stack")
def stack(*data, axis=0):
    """Join arrays of one shape along a new axis (ref: matrix.py ::
    stack); the DataLoader's batchify stacks NDArray samples with it."""
    return torch.stack(data, dim=int(axis))
