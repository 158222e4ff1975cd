"""Shape, indexing and product operators (counterpart of
``mxnet_tpu/ops/matrix.py``; ref: src/operator/tensor/matrix_op-inl.h,
dot.cc, indexing_op.cc).

``dot`` and ``batch_dot`` are a plain ``torch.matmul``, as the reference
leaves its products to XLA outside any kernel. Index ops keep the
reference's out-of-range rules: ``take`` clips or wraps, ``Embedding``
gives a NaN row for an id past the table and wraps a negative one (what
``jnp.take`` does), ``one_hot`` gives a zero row, ``gather_nd`` wraps a
negative index once and clamps (what jnp's gather does), a scatter drops
a write out of range. Nothing asserts on the card and nothing syncs with
the host. The la_op family (``linalg_*``, also as ``_linalg_*``) runs
through ``torch.linalg``: cuSOLVER and cuBLAS on the card.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import register, _ALIASES


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
    gradients in one order, the same from run to run: on the card with
    ``index_put_(accumulate=True)``, which sorts the ids
    (``index_select``'s own backward, ``index_add_``, adds them with
    atomics there, and ``F.embedding``'s does too past a few thousand
    ids); on the CPU with ``index_add_``, which adds them in the ids'
    order (the CPU's ``index_put_`` adds them with atomics over its
    threads)."""

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
        if grad.device.type == "cpu":
            dw.index_add_(0, idx, grad)
        else:
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
    """``data[indices[0], ..., indices[m - 1]]``; an index on axis ``i``
    is taken as jnp's gather takes it: a negative one gets
    ``data.shape[i]`` added, then every one is clamped to ``[0,
    data.shape[i] - 1]`` (on the tensor: no host sync, no device
    assert)."""
    idx = indices.to(torch.int64)
    axes = []
    for i in range(idx.shape[0]):
        n = data.shape[i]
        j = idx[i]
        axes.append(torch.where(j < 0, j + n, j).clamp(0, n - 1))
    return data[tuple(axes)]


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


# ---------------------------------------------------------------------------
# the rest of the reference's matrix.py: layout, sequence and index ops,
# im2col/col2im, khatri_rao and the la_op family
# ---------------------------------------------------------------------------
@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """data / sqrt(sum(data^2) + eps) over every axis but the batch
    (instance), the channel axis (channel) or the spatial axes (spatial)
    (ref: l2_normalization.cc)."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    return data / torch.sqrt(torch.square(data).sum(dim=ax, keepdim=True)
                             + eps)


def _int32_vector(values, device):
    """An int32 vector of Python ints made on ``device`` by fills (a
    host-to-device copy could not be captured)."""
    if not values:
        return torch.zeros(0, dtype=torch.int32, device=device)
    return torch.stack([torch.full((), int(v), dtype=torch.int32,
                                   device=device) for v in values])


@register("shape_array")
def shape_array(data):
    """The shape as an int32 vector (the reference's dtype)."""
    return _int32_vector(tuple(data.shape), data.device)


@register("size_array")
def size_array(data):
    """The element count as an int32 vector of one."""
    return _int32_vector((data.numel(),), data.device)


def _decode_index(enc, shape):
    """The hashable basic index of the reference's ``_encode_index``
    (("i", k), ("s", start, stop, step), ("n",)) as a torch index with
    positive steps only, and the output axes to flip afterwards (a
    negative step takes the same elements in reverse order)."""
    out, flips = [], []
    dim = 0      # input axis
    oax = 0      # output axis
    for e in enc:
        if e[0] == "i":
            out.append(e[1])
            dim += 1
        elif e[0] == "n":
            out.append(None)
            oax += 1
        else:
            sl = slice(e[1], e[2], e[3])
            if sl.step is not None and sl.step < 0:
                pos = range(*sl.indices(shape[dim]))
                sl = slice(pos[-1], pos[0] + 1, -sl.step) if len(pos) \
                    else slice(0, 0)
                flips.append(oax)
            out.append(sl)
            dim += 1
            oax += 1
    return tuple(out), tuple(flips)


@register("_view_index")
def view_index(data, *, index):
    """Recorded basic indexing (ref: the reference NDArray's slice and
    ``at`` under autograd)."""
    idx, flips = _decode_index(index, data.shape)
    out = data[idx]
    return torch.flip(out, flips) if flips else out


@register("_slice_assign")
def slice_assign(data, val, *, index):
    """``data`` with the indexed region replaced by ``val`` (ref:
    _slice_assign); the gradient is zero in the assigned region of
    d(data) and the region's gradient in d(val)."""
    idx, flips = _decode_index(index, data.shape)
    out = data.clone()
    region = out[idx]
    v = val.to(data.dtype).expand(region.shape)
    out[idx] = torch.flip(v, flips) if flips else v
    return out


@register("Pad", aliases=["pad"])
def pad(data, *, mode="constant", pad_width, constant_value=0.0):
    """Pad every axis by (before, after) pairs in ``pad_width`` (ref:
    pad.cc): a constant, the edge value, or the reflection without the
    edge (numpy's modes, as the reference's ``jnp.pad``)."""
    pw = tuple(int(p) for p in pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    pairs += [(0, 0)] * (data.dim() - len(pairs))
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pairs):
            flat += [lo, hi]
        return torch.nn.functional.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(mode)
    out = data
    for ax, (lo, hi) in enumerate(pairs):
        if not lo and not hi:
            continue
        n = data.shape[ax]
        pos = torch.arange(-lo, n + hi, device=data.device)
        if mode == "edge":
            pos = pos.clamp(0, n - 1)
        else:
            pos = torch.where(pos < 0, -pos, pos)
            pos = torch.where(pos > n - 1, 2 * (n - 1) - pos, pos)
        out = out.index_select(ax, pos)
    return out


@register("scatter_nd")
def scatter_nd(data, indices, *, shape):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (M, ...)
    (ref: indexing_op.cc :: scatter_nd)."""
    from .tensor_tail import scatter_set
    base = torch.zeros(tuple(int(s) for s in shape), dtype=data.dtype,
                       device=data.device)
    return scatter_set(base, tuple(indices.to(torch.int64)), data)


@register("SequenceLast")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    """The last step of each sequence along ``axis`` (ref:
    sequence_last.cc); a length of 0 takes the last step, as the
    reference's wrapped index -1 does."""
    ax = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(ax, -1)
    T = data.shape[ax]
    last = sequence_length.to(torch.int64) - 1
    last = torch.where(last < 0, last + T, last).clamp(0, T - 1)
    x = data.movedim(ax, 0)                 # (T, N, ...)
    idx = last.reshape((1, -1) + (1,) * (x.dim() - 2)).expand(
        (1,) + tuple(x.shape[1:]))
    return torch.gather(x, 0, idx).squeeze(0)


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed along axis 0, the
    rest kept (ref: sequence_reverse.cc)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (int(axis),))
    T = data.shape[0]
    steps = torch.arange(T, device=data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    rev = torch.where(steps < lens, lens - 1 - steps, steps)
    rev = torch.where(rev < 0, rev + T, rev).clamp(0, T - 1)
    idx = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)


@register("depth_to_space")
def depth_to_space(data, *, block_size):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, *, block_size):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("batch_take")
def batch_take(a, indices):
    """``a[i, indices[i]]`` for every row i, as jnp's indexing takes it:
    an index wraps once if negative and is clamped, and one that was out
    of range passes no gradient back (its scatter drops it)."""
    n = a.shape[1]
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    out = torch.gather(a, 1, idx.clamp(0, n - 1).reshape(-1, 1)).squeeze(1)
    return torch.where(inside, out, out.detach())


@register("UpSampling")
def upsampling(*data, scale, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=256):
    """Upsampling (ref: nn/upsampling.cc). nearest: each pixel repeated
    ``scale`` times on both axes, several inputs brought to the first's
    size and concatenated; bilinear: the grouped Deconvolution whose
    weight is the second input, kernel 2s - s % 2, stride s, pad
    ceil((s - 1) / 2)."""
    s = int(scale)
    if sample_type == "bilinear":
        from . import get_op
        x, w = data[0], data[1]
        C = x.shape[1]
        k = 2 * s - s % 2
        p = -(-(s - 1) // 2)
        return get_op("Deconvolution").impl(
            x, w, kernel=(k, k), num_filter=C, stride=(s, s), pad=(p, p),
            num_group=C, no_bias=True)
    outs = [d.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            for d in data]
    if len(outs) == 1:
        return outs[0]
    target = outs[0].shape[2:]
    fixed = []
    for o in outs:
        if o.shape[2:] != target:
            o = o.repeat_interleave(target[0] // o.shape[2], dim=2) \
                .repeat_interleave(target[1] // o.shape[3], dim=3)
        fixed.append(o)
    return torch.cat(fixed, dim=1)


@register("khatri_rao")
def khatri_rao(*arrays):
    """Column-wise Kronecker product: (r_i, k) inputs -> (prod r_i, k)
    (ref: contrib/krprod.cc)."""
    if not arrays:
        raise ValueError("khatri_rao needs at least one input")
    out = arrays[0]
    for a in arrays[1:]:
        out = (out[:, None, :] * a[None, :, :]).reshape(
            out.shape[0] * a.shape[0], out.shape[1])
    return out


def _patch_geometry(kernel, stride, dilate, pad):
    k = tuple(int(x) for x in kernel)
    nsp = len(k)

    def tup(v, default):
        t = tuple(int(x) for x in (v or ()))
        if not t:
            return (default,) * nsp
        return t if len(t) == nsp else t + (t[-1],) * (nsp - len(t))
    return k, tup(stride, 1), tup(dilate, 1), tup(pad, 0)


@register("im2col")
def im2col(data, *, kernel, stride=None, dilate=None, pad=None):
    """Conv patches as columns (ref: tensor/im2col.h): (N, C, *spatial)
    -> (N, C * prod(kernel), prod(out_spatial)), the feature axis in (c,
    k_1, ..., k_n) order. One strided window view a spatial axis, any
    number of them."""
    k, s, d, p = _patch_geometry(kernel, stride, dilate, pad)
    nsp = len(k)
    flat = []
    for lo in reversed(p):
        flat += [lo, lo]
    x = torch.nn.functional.pad(data, flat)
    for i in range(nsp):
        x = x.unfold(2 + i, (k[i] - 1) * d[i] + 1, s[i])
        x = x[..., ::d[i]]
    # (N, C, O_1..O_n, K_1..K_n) -> (N, C, K_1..K_n, O_1..O_n)
    perm = (0, 1) + tuple(range(2 + nsp, 2 + 2 * nsp)) + \
        tuple(range(2, 2 + nsp))
    x = x.permute(perm)
    n_out = 1
    for o in x.shape[2 + nsp:]:
        n_out *= o
    return x.reshape(data.shape[0], -1, n_out)


@register("col2im")
def col2im(data, *, output_size, kernel, stride=None, dilate=None,
           pad=None):
    """The adjoint of im2col (ref: tensor/im2col.h col2im): each
    column's values added back into the (N, C, *output_size) image
    where its patch lies, overlaps summed. One strided slice-add a
    kernel offset."""
    k, s, d, p = _patch_geometry(kernel, stride, dilate, pad)
    nsp = len(k)
    size = tuple(int(x) for x in output_size)
    outs = tuple((size[i] + 2 * p[i] - d[i] * (k[i] - 1) - 1) // s[i] + 1
                 for i in range(nsp))
    N = data.shape[0]
    kk = 1
    for v in k:
        kk *= v
    C = data.shape[1] // kk
    cols = data.reshape((N, C) + k + outs)
    img = torch.zeros((N, C) + tuple(size[i] + 2 * p[i]
                                     for i in range(nsp)),
                      dtype=data.dtype, device=data.device)
    for off in _offsets(k):
        win = tuple(slice(off[i] * d[i],
                          off[i] * d[i] + s[i] * (outs[i] - 1) + 1, s[i])
                    for i in range(nsp))
        img[(slice(None), slice(None)) + win] += cols[(slice(None),
                                                       slice(None)) + off]
    crop = tuple(slice(p[i], p[i] + size[i]) for i in range(nsp))
    return img[(slice(None), slice(None)) + crop]


def _offsets(k):
    """Every kernel offset tuple, last axis fastest."""
    out = [()]
    for n in k:
        out = [o + (j,) for o in out for j in range(n)]
    return out


# -- the la_op family (ref: src/operator/tensor/la_op.cc): torch.linalg,
# cuSOLVER and cuBLAS on the card. The ``_ex`` forms are used where
# torch has them, so no factorisation checks its status on the host; a
# Cholesky factor of a matrix that is not positive definite is NaN, as
# the reference's is. -------------------------------------------------------
@register("linalg_gemm")
def linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False,
                alpha=1.0, beta=1.0, axis=-3):
    """alpha op(A) op(B) + beta C."""
    if axis != -3:
        raise NotImplementedError(
            "linalg_gemm: only the default axis=-3 layout is supported")
    a = A.transpose(-1, -2) if transpose_a else A
    b = B.transpose(-1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-3):
    """alpha op(A) op(B)."""
    a = A.transpose(-1, -2) if transpose_a else A
    b = B.transpose(-1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("linalg_potrf")
def linalg_potrf(A):
    """The lower Cholesky factor L, A = L Lᵀ."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")).tril())


def _eye_like(A):
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)


@register("linalg_potri")
def linalg_potri(A):
    """(L Lᵀ)⁻¹ from the Cholesky factor L."""
    linv = torch.linalg.solve_triangular(A, _eye_like(A), upper=False)
    return torch.matmul(linv.transpose(-1, -2), linv)


@register("linalg_trsm")
def linalg_trsm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """X with op(A) X = alpha B, or X op(A) = alpha B with
    ``rightside``, A triangular."""
    a = A.transpose(-1, -2) if transpose else A
    lo = lower != transpose
    if rightside:
        return torch.linalg.solve_triangular(a, alpha * B, upper=not lo,
                                             left=False)
    return torch.linalg.solve_triangular(a, alpha * B, upper=not lo)


@register("linalg_trmm")
def linalg_trmm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """alpha op(A) B, or alpha B op(A) with ``rightside``, A's triangle
    only."""
    tri = torch.tril(A) if lower else torch.triu(A)
    a = tri.transpose(-1, -2) if transpose else tri
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_syrk")
def linalg_syrk(A, *, transpose=False, alpha=1.0):
    """alpha A Aᵀ, or alpha Aᵀ A with ``transpose``."""
    at = A.transpose(-1, -2)
    return alpha * (torch.matmul(at, A) if transpose else torch.matmul(A, at))


@register("linalg_gelqf")
def linalg_gelqf(A):
    """LQ factorisation A = L Q of an (m, n) matrix, m <= n, through the
    QR of Aᵀ. Returns (Q, L), MXNet 1.x's order (``Q, L = gelqf(A)``);
    the reference returns (L, Q) (ROADMAP.md queue 3)."""
    q, r = torch.linalg.qr(A.transpose(-1, -2))
    return q.transpose(-1, -2), r.transpose(-1, -2)


@register("linalg_syevd")
def linalg_syevd(A):
    """Symmetric eigendecomposition: (U, lambda) with A = Uᵀ diag(lambda)
    U, the eigenvalues ascending. Each row of U is unique up to its
    sign."""
    w, v = torch.linalg.eigh(A)
    return v.transpose(-1, -2), w


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(dim=-1)


@register("linalg_extractdiag")
def linalg_extractdiag(A, *, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(A, *, offset=0):
    return torch.diag_embed(A, offset=int(offset))


def _trian_index(n, offset, lower, device):
    if lower:
        return torch.tril_indices(n, n, int(offset), device=device)
    return torch.triu_indices(n, n, int(offset), device=device)


@register("linalg_extracttrian")
def linalg_extracttrian(A, *, offset=0, lower=True):
    """The lower (or upper) triangle band, ``offset`` diagonals off the
    main one, packed row by row into a vector."""
    rows, cols = _trian_index(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


def _trian_len(n, offset, lower):
    """Entries of the band extracttrian packs from an (n, n) matrix."""
    k = int(offset)
    count = 0
    for i in range(n):
        lo, hi = (0, min(n, i + k + 1)) if lower else (max(0, i + k), n)
        count += max(0, hi - lo)
    return count


@register("linalg_maketrian")
def linalg_maketrian(A, *, offset=0, lower=True):
    """The inverse of extracttrian: the packed band written back into an
    otherwise zero square matrix."""
    m = A.shape[-1]
    n = 1
    while _trian_len(n, offset, lower) < m:
        n += 1
    if _trian_len(n, offset, lower) != m:
        raise ValueError("maketrian: %d entries fit no square matrix with "
                         "offset %d" % (m, offset))
    rows, cols = _trian_index(n, offset, lower, A.device)
    lead = tuple(A.shape[:-1])
    flat = torch.zeros(lead + (n * n,), dtype=A.dtype, device=A.device)
    flat = flat.scatter(-1, (rows * n + cols).expand(lead + (m,)), A)
    return flat.reshape(lead + (n, n))


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A)


@register("linalg_slogdet")
def linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv_ex(A).inverse


# the reference registers every la_op as ``_linalg_*`` too
for _n in ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
           "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
           "extracttrian", "maketrian", "det", "slogdet", "inverse"):
    _ALIASES.setdefault("_linalg_" + _n, "linalg_" + _n)
