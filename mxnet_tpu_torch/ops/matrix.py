"""Shape and indexing operators, the subset the serving and training
slices run
(counterpart of ``mxnet_tpu/ops/matrix.py``; ref:
src/operator/tensor/matrix_op-inl.h, indexing_op.cc)."""
from __future__ import annotations

import torch

from . import register


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


@register("Embedding")
def embedding(data, weight, *, input_dim, output_dim, dtype="float32",
              sparse_grad=False):
    """Row gather (ref: indexing_op.cc :: Embedding); float ids are
    truncated to integers as in the reference, and get no gradient. The
    weight's gradient is the scatter-add of the rows' gradients."""
    idx = data.to(torch.int64)
    return weight.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + (weight.shape[1],))


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
