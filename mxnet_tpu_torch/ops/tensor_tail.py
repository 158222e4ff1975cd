"""Core tensor-namespace long-tail operators (counterpart of
``mxnet_tpu/ops/tensor_tail.py``; ref: src/operator/tensor/ —
elemwise_sum.cc, matrix_op.cc, cast_storage.cc,
elemwise_binary_op_extended.cc, elemwise_binary_scalar_op_extended.cc,
nn/moments.cc, nn/softmax.cc (masked_softmax), contrib/index_array.cc,
contrib/index_copy.cc, indexing_op.cc (_scatter_set_nd)).

Each is a torch composition on the input's device; none reads a value
back to the host. The same-shape ``_maximum``-style binaries keep the
reference's strict-shape contract, and a comparison returns its lhs's
dtype. ``SVMOutput`` and ``IdentityAttachKLSparseReg`` are the
identity, gradient included, as in the reference (MXNet 1.x adds a hinge
and a KL term to the gradient: ROADMAP.md queue 3, "gaps kept on
purpose").
"""
from __future__ import annotations

import torch

from . import register, _ALIASES
from .elemwise import (_cbrt, _make_binary, _make_scalar, div_exact,
                       float_in, hypot, mod)


# ---------------------------------------------------------------------------
# add_n / ElementWiseSum
# ---------------------------------------------------------------------------
@register("add_n", aliases=["ElementWiseSum", "_sum_of"])
def add_n(*args, num_args=None):
    """Sum of all inputs, left to right (ref: elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# ---------------------------------------------------------------------------
# same-shape binaries and the scalar tail
# ---------------------------------------------------------------------------
for _n, _f in [("_maximum", torch.maximum), ("_minimum", torch.minimum),
               ("_power", torch.pow), ("_hypot", hypot), ("_mod", mod)]:
    register(_n)(_make_binary(_n, _f, same_shape=True))

for _n, _f in [("_equal", torch.eq), ("_not_equal", torch.ne),
               ("_greater", torch.gt), ("_greater_equal", torch.ge),
               ("_lesser", torch.lt), ("_lesser_equal", torch.le),
               ("_logical_and", torch.logical_and),
               ("_logical_or", torch.logical_or),
               ("_logical_xor", torch.logical_xor)]:
    register(_n)(_make_binary(_n, _f, cmp=True, same_shape=True))

register("_hypot_scalar")(_make_scalar("_hypot_scalar", hypot))
for _n, _f in [("_logical_and_scalar", torch.logical_and),
               ("_logical_or_scalar", torch.logical_or),
               ("_logical_xor_scalar", torch.logical_xor)]:
    register(_n)(_make_scalar(_n, _f, cmp=True))


@register("rcbrt")
def rcbrt(data):
    """1 / cbrt(x) (ref: elemwise_unary_op_pow.cc)."""
    return 1.0 / _cbrt(data)


@register("relu6")
def relu6(data):
    return torch.clamp(data, 0.0, 6.0)


# ---------------------------------------------------------------------------
# reverse / diag / ravel / unravel / split_v2 / cast_storage
# ---------------------------------------------------------------------------
@register("reverse")
def reverse(data, *, axis):
    """Reverse along the given axis or axes (ref: matrix_op.cc ::
    reverse; an op of its own, as in the reference, besides ``flip``'s
    alias)."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, tuple(int(a) for a in axes))


@register("diag")
def diag(data, *, k=0, axis1=0, axis2=1):
    """The k-th diagonal of an array (ndim >= 2), or the matrix with a
    vector on it (ndim 1) (ref: diag_op.cc)."""
    if data.dim() == 1:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=int(axis1),
                          dim2=int(axis2))


@register("_ravel_multi_index", aliases=["ravel_multi_index"])
def ravel_multi_index(data, *, shape):
    """(ndim, N) coordinates -> flat indices in data's dtype (ref:
    ravel.cc)."""
    idx = data.to(torch.int32)
    out = torch.zeros(idx.shape[1:], dtype=torch.int32, device=data.device)
    for d, s in enumerate(int(s) for s in shape):
        out = out * s + idx[d]
    return out.to(data.dtype)


@register("_unravel_index", aliases=["unravel_index"])
def unravel_index(data, *, shape):
    """Flat indices -> (ndim, N) coordinates in data's dtype (ref:
    ravel.cc); floored division, as the reference's int32 ``%`` and
    ``//``."""
    idx = data.to(torch.int32)
    coords = []
    for s in reversed([int(s) for s in shape]):
        coords.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0).to(data.dtype)


@register("_split_v2", aliases=["split_v2"])
def split_v2(data, *, indices=(), axis=0, squeeze_axis=False, sections=0):
    """Split into equal ``sections`` or at explicit ``indices`` (ref:
    matrix_op.cc :: _split_v2)."""
    ax = int(axis)
    if sections and int(sections) > 0:
        n = int(sections)
        if data.shape[ax] % n:
            raise ValueError("split_v2: axis of size %d does not split into "
                             "%d equal sections" % (data.shape[ax], n))
        parts = torch.tensor_split(data, n, dim=ax)
    else:
        parts = torch.tensor_split(data, [int(i) for i in indices], dim=ax)
    if squeeze_axis:
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("cast_storage")
def cast_storage(data, *, stype="default"):
    """The dense path's storage cast is the identity (ref:
    cast_storage.cc; sparse storage is ROADMAP.md queue 1, item 16)."""
    return data


# ---------------------------------------------------------------------------
# scatter-writes
# ---------------------------------------------------------------------------
def scatter_set(base, indices, values):
    """``base`` with ``values`` written at ``base[indices[0], ...,
    indices[m - 1]]``, as jnp's ``.at[...].set``: a negative index wraps
    once, an index still out of range drops its write. The writes go to
    a flat view with one spare row that takes the dropped ones, so no
    index is ever out of range (no device assert, no host read), and
    the result is differentiable in ``base`` (zeros where written) and
    in ``values``."""
    m = len(indices)
    lead, rest = tuple(base.shape[:m]), tuple(base.shape[m:])
    flat = torch.zeros((), dtype=torch.int64, device=base.device)
    ok = torch.ones((), dtype=torch.bool, device=base.device)
    for j, n in zip(indices, lead):
        j = j.to(torch.int64)
        j = torch.where(j < 0, j + n, j)
        ok = ok & (j >= 0) & (j < n)
        flat = flat * n + j.clamp(0, n - 1)
    rows = 1
    for n in lead:
        rows *= n
    flat = torch.where(ok, flat, torch.full_like(flat, rows))
    table = torch.cat([base.reshape((rows,) + rest),
                       base.new_zeros((1,) + rest)])
    vals = values.to(base.dtype).expand(tuple(flat.shape) + rest)
    table = table.index_put((flat,), vals)
    return table[:rows].reshape(base.shape)


@register("_scatter_set_nd")
def scatter_set_nd(lhs, rhs, indices, *, shape=None):
    """``rhs`` written into ``lhs`` at ``indices`` (M, ...) (ref:
    indexing_op.cc :: _scatter_set_nd, the backend of advanced-index
    assignment)."""
    return scatter_set(lhs, tuple(indices.to(torch.int64)), rhs)


@register("_contrib_index_array", aliases=["index_array"])
def index_array(data, *, axes=None):
    """Each element's N-d index, int32, in a trailing axis (ref:
    contrib/index_array.cc; the reference's dtype)."""
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.int32,
                                          device=data.device)
                             for s in data.shape], indexing="ij")
    ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
    return torch.stack([grids[int(a)] for a in ax], dim=-1)


@register("_contrib_index_copy")
def index_copy(old, idx, new):
    """Rows of ``new`` copied into ``old`` at positions ``idx`` (ref:
    contrib/index_copy.cc)."""
    return scatter_set(old, (idx.to(torch.int64),), new)


# ---------------------------------------------------------------------------
# moments / masked softmax
# ---------------------------------------------------------------------------
@register("moments")
def moments(data, *, axes=None, keepdims=False):
    """(mean, variance) over ``axes`` (ref: nn/moments.cc)."""
    ax = tuple(int(a) for a in axes) if axes is not None \
        else tuple(range(data.dim()))
    data = float_in(data)
    mean = data.mean(dim=ax, keepdim=True)
    var = torch.square(data - mean).mean(dim=ax, keepdim=True)
    if not keepdims:
        mean, var = mean.squeeze(ax), var.squeeze(ax)
    return mean, var


def _masked_logits(data, mask, temperature):
    keep = mask.to(torch.bool)
    neg = torch.finfo(data.dtype).min if data.is_floating_point() else -1e9
    return keep, torch.where(keep, div_exact(data, temperature),
                             torch.full((), neg, dtype=data.dtype,
                                        device=data.device))


@register("masked_softmax")
def masked_softmax(data, mask, *, axis=-1, temperature=1.0, normalize=True):
    """softmax(data / T) over the positions where ``mask`` is true;
    masked positions are exactly 0 (ref: nn/softmax.cc ::
    masked_softmax)."""
    keep, logits = _masked_logits(data, mask, temperature)
    out = torch.softmax(logits, dim=int(axis))
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)
                       ).to(data.dtype)


@register("masked_log_softmax")
def masked_log_softmax(data, mask, *, axis=-1, temperature=1.0):
    """log of masked_softmax; masked positions are -inf (ref:
    nn/softmax.cc :: masked_log_softmax)."""
    keep, logits = _masked_logits(data, mask, temperature)
    out = torch.log_softmax(logits, dim=int(axis))
    return torch.where(keep, out, torch.full((), float("-inf"),
                                             dtype=out.dtype,
                                             device=out.device)
                       ).to(data.dtype)


# ---------------------------------------------------------------------------
# legacy layers
# ---------------------------------------------------------------------------
@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    """softmax over the last axis, or over axis 1 with mode='channel'
    (ref: nn/softmax_activation.cc)."""
    return torch.softmax(float_in(data), dim=1 if mode == "channel" else -1)


@register("SVMOutput")
def svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Hinge-loss output layer: the scores, and the head gradient passed
    through, as the reference has it (ref: svm_output.cc)."""
    return data


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, *, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """The identity, gradient included, as the reference has it (ref:
    identity_attach_KL_sparse_reg.cc)."""
    return data


@register("Crop")
def crop(data, *crop_like, offset=(0, 0), h_w=(0, 0), num_args=1,
         center_crop=False):
    """NCHW spatial crop to a second input's size or to ``h_w`` (ref:
    nn/crop.cc)."""
    H, W = data.shape[2], data.shape[3]
    if crop_like:
        th, tw = crop_like[0].shape[2], crop_like[0].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    return data[:, :, y0:y0 + th, x0:x0 + tw]


# legacy aliases onto existing registrations
for _a, _n in (("SwapAxis", "swapaxes"), ("SliceChannel", "split"),
               ("BatchNorm_v1", "BatchNorm"),
               ("Convolution_v1", "Convolution"),
               ("Pooling_v1", "Pooling"), ("MakeLoss", "make_loss")):
    _ALIASES.setdefault(_a, _n)
