"""Vision, spatial-transform and detection operators (counterpart of
``mxnet_tpu/ops/vision_ops.py``; ref: src/operator/ bilinear_sampler.cc,
grid_generator.cc, spatial_transformer.cc, roi_pooling.cc,
contrib/roi_align.cc, contrib/psroi_pooling.cc,
contrib/deformable_convolution.cc,
contrib/modulated_deformable_convolution.cc, correlation.cc, nn/lrn.cc,
contrib/bounding_box.cc, contrib/multibox_prior.cc,
contrib/multibox_target.cc, contrib/multibox_detection.cc,
contrib/fft.cc, contrib/ifft.cc, contrib/count_sketch.cc,
contrib/allclose_op.cc, contrib/gradient_multiplier_op.cc,
contrib/quadratic_op.cc, contrib/stes_op.cc, contrib/bilinear_resize.cc,
contrib/adaptive_avg_pooling.cc).

Every op is a torch composition with static shapes on the input's
device: no value is read back to the host, so each can be captured in a
CUDA graph. The values are the reference's; three of its formulations
are recast so that they fit the card at the widths of the detection
models that use them:

* ``ROIPooling`` takes the max of each bin in two separable steps,
  first over the bin's columns (a sparse table of column-window maxima
  over the feature map, two lookups a bin), then over its rows, instead
  of one (R, C, PH, PW, H, W) masked tensor.
* ``ROIAlign``, ``ROIPooling`` and ``PSROIPooling`` read the (N, C, H,
  W) map by (batch index, y, x) instead of copying the map once per ROI;
  ``PSROIPooling`` sums each bin as two masked contractions.
* ``box_nms`` suppresses over the first ``min(N, topk)`` score-sorted
  candidates only (the others are invalid by the reference's own mask),
  a bound fixed by the shapes and ``topk``.

``gradientmultiplier``, ``round_ste`` and ``sign_ste`` keep the
reference's custom backward (``torch.autograd.Function``).
"""
from __future__ import annotations

import math
import struct

import torch

from . import register
from .elemwise import div_exact


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _batch_index(col, n):
    """ROI batch indices as jnp's gather takes them: truncated to
    integers, a negative one wrapped once, then clamped into [0, n)."""
    b = col.to(torch.int64)
    return torch.where(b < 0, b + n, b).clamp(0, n - 1)


# ---------------------------------------------------------------------------
# bilinear sampling (shared)
# ---------------------------------------------------------------------------
def _bilinear_gather(data, xs, ys, batch=None):
    """Sample NCHW ``data`` at pixel coordinates (xs, ys), shape (B,
    ...), with zeros outside; returns (B, C, ...). Row b of the
    coordinates reads image ``batch[b]`` (default: image b). The taps
    are gathered from a channel-last view of the map, so no image is
    copied per row."""
    N, C, H, W = data.shape
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0
    img = data.permute(0, 2, 3, 1)                   # (N, H, W, C) view
    if batch is None:
        batch = torch.arange(N, device=data.device)
    b = batch.reshape((-1,) + (1,) * (xs.dim() - 1))

    def tap(yy, xx):
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        yi = torch.where(valid, yy, 0.0).to(torch.int64)
        xi = torch.where(valid, xx, 0.0).to(torch.int64)
        return img[b, yi, xi] * valid[..., None].to(data.dtype)

    out = (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
           + tap(y0, x0 + 1) * (wx * (1 - wy))[..., None]
           + tap(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
           + tap(y0 + 1, x0 + 1) * (wx * wy)[..., None])
    return out.movedim(-1, 1)


@register("BilinearSampler")
def bilinear_sampler(data, grid, *, cudnn_off=False):
    """Sample data at normalized grid coordinates in [-1, 1], grid (N,
    2, Ho, Wo) holding (x, y) (ref: bilinear_sampler.cc)."""
    _, _, H, W = data.shape
    xs = (grid[:, 0] + 1) * (W - 1) / 2
    ys = (grid[:, 1] + 1) * (H - 1) / 2
    return _bilinear_gather(data, xs, ys)


@register("GridGenerator")
def grid_generator(data, *, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid from affine parameters (N, 6), or from a pixel
    flow field (N, 2, H, W) added to the identity grid (ref:
    grid_generator.cc)."""
    dev = data.device
    if transform_type == "affine":
        Ho, Wo = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3)
        yt, xt = torch.meshgrid(torch.linspace(-1, 1, Ho, device=dev),
                                torch.linspace(-1, 1, Wo, device=dev),
                                indexing="ij")
        base = torch.stack([xt.reshape(-1), yt.reshape(-1),
                            torch.ones(Ho * Wo, device=dev)])
        out = torch.matmul(theta.float(), base)
        return out.reshape(-1, 2, Ho, Wo).to(data.dtype)
    _, _, H, W = data.shape
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    xs = div_exact((xx[None] + data[:, 0]) * 2, max(W - 1, 1)) - 1
    ys = div_exact((yy[None] + data[:, 1]) * 2, max(H - 1, 1)) - 1
    return torch.stack([xs, ys], dim=1).to(data.dtype)


@register("SpatialTransformer")
def spatial_transformer(data, loc, *, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """GridGenerator then BilinearSampler (ref: spatial_transformer.cc)."""
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------
def _quantized_bins(rois, spatial_scale, P, Q, dtype):
    """The integer bin bounds of ROIPooling and PSROIPooling (ref:
    roi_pooling.cc): rows [hs, he) of P bins and columns [ws, we) of Q
    bins, each (R, P) or (R, Q), in ``dtype`` as the reference computes
    them."""
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    roi_h = torch.clamp(y2 - y1 + 1, min=1.0)
    roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
    p = torch.arange(P, dtype=dtype, device=rois.device)
    q = torch.arange(Q, dtype=dtype, device=rois.device)
    hs = torch.floor(y1[:, None] + div_exact(p[None] * roi_h[:, None], P))
    he = torch.ceil(y1[:, None] + div_exact((p[None] + 1) * roi_h[:, None],
                                            P))
    ws = torch.floor(x1[:, None] + div_exact(q[None] * roi_w[:, None], Q))
    we = torch.ceil(x1[:, None] + div_exact((q[None] + 1) * roi_w[:, None],
                                            Q))
    return hs, he, ws, we


def _span(lo, hi, n):
    """[lo, hi) clipped to [0, n), as int64 (start, length)."""
    a = lo.clamp(0, n).to(torch.int64)
    b = hi.clamp(0, n).to(torch.int64)
    return a, b - a


def _window_max_table(x, dim):
    """Sparse table of window maxima along ``dim`` of ``x``: level k
    holds max(x[i : i + 2^k]) at i, for k = 0 .. floor(log2(n)),
    stacked on a new first axis. Entries whose window runs past the end
    keep the level below (no query reads them)."""
    n = x.shape[dim]
    levels = [x]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        h = 1 << (k - 1)
        head = torch.maximum(prev.narrow(dim, 0, n - h),
                             prev.narrow(dim, h, n - h))
        levels.append(torch.cat([head, prev.narrow(dim, n - h, h)], dim))
        k += 1
    return torch.stack(levels)


def _level(length, n_levels):
    """floor(log2(length)) for length >= 1 (0 otherwise), on the
    device: the count of powers 2, 4, ... not above ``length``."""
    k = torch.zeros_like(length)
    for j in range(1, n_levels):
        k = k + (length >= (1 << j)).to(length.dtype)
    return k


@register("ROIPooling")
def roi_pooling(data, rois, *, pooled_size, spatial_scale=1.0):
    """Max-pool each ROI into a (PH, PW) grid of bins (ref:
    roi_pooling.cc); an empty bin gives 0. The max is separable: over
    each bin's columns first, through a sparse table of column-window
    maxima of the map (two lookups a bin, (R, PW, C, H)), then over its
    rows, one pooled row at a time."""
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    R = rois.shape[0]
    b = _batch_index(rois[:, 0], N)
    hs, he, ws, we = _quantized_bins(rois, spatial_scale, PH, PW,
                                     data.dtype)
    # columns: table (K, N, W, C*H); each bin two overlapping windows
    cols = data.permute(0, 3, 1, 2).reshape(N, W, C * H)
    table = _window_max_table(cols, 1)
    a, length = _span(ws, we, W)                    # (R, PW)
    k = _level(length, table.shape[0])
    a2 = (a + length - (1 << k)).clamp(0, W - 1)
    a1 = a.clamp(0, W - 1)
    bb = b[:, None]
    colmax = torch.maximum(table[k, bb, a1], table[k, bb, a2])
    colmax = colmax.reshape(R, PW, C, H)
    # rows: the reference's row masks, one pooled row at a time
    hh = torch.arange(H, dtype=data.dtype, device=data.device)
    neg = torch.full((), float("-inf"), dtype=data.dtype,
                     device=data.device)
    rows = []
    for i in range(PH):
        m = (hh[None] >= hs[:, i, None]) & (hh[None] < he[:, i, None])
        rows.append(torch.where(m[:, None, None, :], colmax, neg).amax(-1))
    out = torch.stack(rows, dim=-1).permute(0, 2, 3, 1)   # (R, C, PH, PW)
    _, hlen = _span(hs, he, H)
    empty = (hlen <= 0)[:, :, None] | (length <= 0)[:, None, :]
    return torch.where(empty[:, None], torch.zeros((), dtype=out.dtype,
                                                   device=out.device),
                       out).to(data.dtype)


@register("_contrib_ROIAlign")
def roi_align(data, rois, *, pooled_size, spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False):
    """The mean of sr x sr bilinear samples a bin (ref:
    contrib/roi_align.cc), sr = sample_ratio, or 2 when it is not
    positive (static shapes). The samples are gathered from the map by
    (batch index, y, x). ``position_sensitive`` (R-FCN) pools bin (ph,
    pw) from its own channel group: C // (PH * PW) channels out."""
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    R = rois.shape[0]
    C = data.shape[1]
    sr = int(sample_ratio) if int(sample_ratio) > 0 else 2
    if position_sensitive and C % (PH * PW) != 0:
        raise ValueError(
            "position_sensitive ROIAlign needs channels %% (PH*PW) == 0, "
            "got C=%d pooled=(%d,%d)" % (C, PH, PW))
    b = _batch_index(rois[:, 0], data.shape[0])
    off = 0.5 if aligned else 0.0
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    roi_h = y2 - y1
    roi_w = x2 - x1
    if not aligned:
        roi_h = torch.clamp(roi_h, min=1.0)
        roi_w = torch.clamp(roi_w, min=1.0)
    bin_h = div_exact(roi_h, PH)
    bin_w = div_exact(roi_w, PW)
    dev = rois.device
    frac = div_exact(torch.arange(sr, device=dev) + 0.5, sr)
    gy = y1[:, None, None] + (torch.arange(PH, device=dev)[None, :, None]
                              + frac[None, None, :]) * bin_h[:, None, None]
    gx = x1[:, None, None] + (torch.arange(PW, device=dev)[None, :, None]
                              + frac[None, None, :]) * bin_w[:, None, None]
    ys = gy[:, :, None, :, None].expand(R, PH, PW, sr, sr)
    xs = gx[:, None, :, None, :].expand(R, PH, PW, sr, sr)
    samples = _bilinear_gather(data, xs.reshape(R, -1, 1),
                               ys.reshape(R, -1, 1), batch=b)
    pooled = samples.reshape(R, C, PH, PW, sr * sr).mean(-1)
    if position_sensitive:
        c_out = C // (PH * PW)
        grp = pooled.reshape(R, c_out, PH * PW, PH, PW)
        idx = (torch.arange(PH, device=dev)[:, None] * PW
               + torch.arange(PW, device=dev)[None, :])
        idx = idx.reshape(1, 1, 1, PH, PW).expand(R, c_out, 1, PH, PW)
        pooled = torch.gather(grp, 2, idx)[:, :, 0]
    return pooled.to(data.dtype)


@register("_contrib_PSROIPooling")
def psroi_pooling(data, rois, *, spatial_scale, output_dim, pooled_size,
                  group_size=0):
    """Position-sensitive ROI average pooling (R-FCN; ref:
    contrib/psroi_pooling.cc): channel (c, i, j) pools bin (i, j). Each
    bin's channel is picked from the map once (not per ROI); its masked
    sum is a contraction over the bin's columns, then one over its rows,
    divided by the bin's pixel count (at least 1)."""
    P = int(pooled_size)
    G = int(group_size) if group_size else P
    OD = int(output_dim)
    N, C, H, W = data.shape
    R = rois.shape[0]
    b = _batch_index(rois[:, 0], N)
    hs, he, ws, we = _quantized_bins(rois, spatial_scale, P, P, data.dtype)
    hh = torch.arange(H, dtype=data.dtype, device=data.device)
    ww = torch.arange(W, dtype=data.dtype, device=data.device)
    hmask = ((hh[None, None] >= hs[..., None])
             & (hh[None, None] < he[..., None])).to(data.dtype)  # (R,P,H)
    wmask = ((ww[None, None] >= ws[..., None])
             & (ww[None, None] < we[..., None])).to(data.dtype)  # (R,P,W)
    cnt = torch.clamp(hmask.sum(-1)[:, :, None] * wmask.sum(-1)[:, None, :],
                      min=1.0)                                   # (R,P,P)
    gi = torch.arange(P, device=data.device) * G // P
    sel = data.reshape(N, OD, G, G, H, W)[:, :, gi[:, None], gi[None, :]]
    rowsum = torch.einsum("noijhw,rjw->nroijh", sel, wmask)
    rowsum = rowsum[b, torch.arange(R, device=data.device)]   # (R,OD,P,P,H)
    pooled = torch.einsum("roijh,rih->roij", rowsum, hmask) / cnt[:, None]
    return pooled.to(data.dtype)


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------
def _deform_im2col(data, offset, kernel, stride, pad, dilate, deform_groups,
                   mask=None):
    """Bilinear-sampled im2col: (N, C, KH*KW, Ho, Wo), Ho and Wo."""
    N, C, H, W = data.shape
    KH, KW = kernel
    SH, SW = stride
    PH, PW = pad
    DH, DW = dilate
    Ho = (H + 2 * PH - DH * (KH - 1) - 1) // SH + 1
    Wo = (W + 2 * PW - DW * (KW - 1) - 1) // SW + 1
    DG = int(deform_groups)
    KK = KH * KW
    dev = data.device
    off = offset.reshape(N, DG, KK, 2, Ho, Wo)
    base_y = (torch.arange(Ho, device=dev) * SH - PH)[None, :, None]
    base_x = (torch.arange(Wo, device=dev) * SW - PW)[None, None, :]
    ky = (torch.arange(KH, device=dev) * DH).repeat_interleave(KW) \
        .reshape(KK, 1, 1)
    kx = (torch.arange(KW, device=dev) * DW).repeat(KH).reshape(KK, 1, 1)
    cols = []
    cg = C // DG
    for g in range(DG):
        ys = base_y + ky + off[:, g, :, 0]          # (N, KK, Ho, Wo)
        xs = base_x + kx + off[:, g, :, 1]
        sampled = _bilinear_gather(data[:, g * cg:(g + 1) * cg],
                                   xs.reshape(N, KK * Ho, Wo),
                                   ys.reshape(N, KK * Ho, Wo))
        sampled = sampled.reshape(N, cg, KK, Ho, Wo)
        if mask is not None:
            sampled = sampled * mask.reshape(N, DG, KK, Ho, Wo)[:, g, None]
        cols.append(sampled)
    return torch.cat(cols, dim=1), Ho, Wo


def _deform_conv(data, offset, weight, bias, mask, kernel, stride, pad,
                 dilate, num_filter, num_group, num_deformable_group):
    col, Ho, Wo = _deform_im2col(data, offset, kernel, stride, pad, dilate,
                                 num_deformable_group, mask=mask)
    N, C = col.shape[0], col.shape[1]
    G = int(num_group)
    O = int(num_filter)
    KK = kernel[0] * kernel[1]
    col = col.reshape(N, G, (C // G) * KK, Ho * Wo)
    w = weight.reshape(G, O // G, (C // G) * KK).to(col.dtype)
    out = torch.matmul(w[None], col).reshape(N, O, Ho, Wo).to(data.dtype)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register("_contrib_DeformableConvolution")
def deformable_convolution(data, offset, weight, bias=None, *, kernel,
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=1, num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1 (ref: contrib/deformable_convolution.cc):
    offsets bend each output's sampling grid; a bilinear-sampled im2col
    then one grouped product."""
    return _deform_conv(data, offset, weight, None if no_bias else bias,
                        None, tuple(kernel), tuple(stride), tuple(pad),
                        tuple(dilate), num_filter, num_group,
                        num_deformable_group)


@register("_contrib_ModulatedDeformableConvolution")
def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     *, kernel, stride=(1, 1), dilate=(1, 1),
                                     pad=(0, 0), num_filter=1, num_group=1,
                                     num_deformable_group=1, no_bias=False,
                                     workspace=1024, layout=None,
                                     im2col_step=64):
    """Deformable convolution v2, each sample scaled by its mask (ref:
    contrib/modulated_deformable_convolution.cc)."""
    return _deform_conv(data, offset, weight, None if no_bias else bias,
                        mask, tuple(kernel), tuple(stride), tuple(pad),
                        tuple(dilate), num_filter, num_group,
                        num_deformable_group)


# ---------------------------------------------------------------------------
# correlation / LRN
# ---------------------------------------------------------------------------
@register("Correlation")
def correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet patch correlation (ref: correlation.cc): one output
    channel a displacement, each the channel mean of the patch products
    (or absolute differences). The patches are strided slices (views)
    of the padded maps; data1's are taken once for all displacements."""
    K = int(kernel_size)
    D = int(max_displacement)
    S1, S2 = int(stride1), int(stride2)
    P = int(pad_size)
    a = torch.nn.functional.pad(data1, (P, P, P, P))
    b = torch.nn.functional.pad(data2, (P, P, P, P))
    N, C, H, W = a.shape
    border = D + (K - 1) // 2
    Ho = len(range(border, H - border, S1))
    Wo = len(range(border, W - border, S1))
    half = (K - 1) // 2

    def patch(x, dy, dx):
        return x[:, :, border + dy:border + dy + S1 * (Ho - 1) + 1:S1,
                 border + dx:border + dx + S1 * (Wo - 1) + 1:S1]

    taps = [(ky, kx) for ky in range(-half, half + 1)
            for kx in range(-half, half + 1)]
    pa = {t: patch(a, *t) for t in taps}
    outs = []
    for dy in range(-D, D + 1, S2):
        for dx in range(-D, D + 1, S2):
            acc = None
            for ky, kx in taps:
                va = pa[(ky, kx)]
                vb = patch(b, dy + ky, dx + kx)
                term = va * vb if is_multiply else torch.abs(va - vb)
                acc = term if acc is None else acc + term
            outs.append(div_exact(acc.sum(dim=1), C * K * K))
    return torch.stack(outs, dim=1).to(data1.dtype)


@register("LRN")
def lrn(data, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels (ref: nn/lrn.cc)."""
    n = int(nsize)
    sq = torch.square(data)
    padded = torch.nn.functional.pad(
        sq, (0, 0, 0, 0, n // 2, n - n // 2 - 1))
    win = padded[:, 0:data.shape[1]]
    for i in range(1, n):
        win = win + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + (alpha / n) * win, beta)


# ---------------------------------------------------------------------------
# bounding boxes
# ---------------------------------------------------------------------------
def _to_corner(b, fmt):
    if fmt == "corner":
        return b
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _iou_matrix(a, b):
    """Pairwise IoU of corner boxes a (..., N, 4) and b (..., M, 4), one
    coordinate at a time (no (..., N, M, 2) temporaries)."""
    def side(lo, hi):
        return torch.clamp(
            torch.minimum(a[..., :, None, hi], b[..., None, :, hi])
            - torch.maximum(a[..., :, None, lo], b[..., None, :, lo]),
            min=0.0)
    inter = side(0, 2) * side(1, 3)
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


@register("_contrib_box_iou")
def box_iou(lhs, rhs, *, format="corner"):
    """Pairwise IoU (ref: contrib/bounding_box.cc :: box_iou)."""
    return _iou_matrix(_to_corner(lhs, format),
                       _to_corner(rhs, format)).to(lhs.dtype)


def nms_bound(n, topk):
    """The candidates ``box_nms`` suppresses over: the first min(n,
    topk) by score, all n when topk <= 0."""
    return min(n, int(topk)) if int(topk) > 0 else n


@register("_contrib_box_nms",
          aliases=["_contrib_box_non_maximum_suppression"])
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS (ref: bounding_box.cc :: box_nms): a suppressed or
    invalid box keeps its coordinates and gets score -1. The candidates
    are sorted by score (stable, as the reference's argsort); only the
    first T = min(N, topk) can be valid, so the IoU is (B, T, T) and the
    suppression loop T steps, T fixed by the shapes and ``topk``."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))       # (B, N, K)
    B, N, _ = flat.shape
    cs, si, ii = int(coord_start), int(score_index), int(id_index)
    T = nms_bound(N, topk)
    boxes = _to_corner(flat[..., cs:cs + 4], in_format)
    scores = flat[..., si]
    valid = scores > valid_thresh
    if int(background_id) >= 0 and ii >= 0:
        valid = valid & (flat[..., ii] != background_id)
    ninf = torch.full((), float("-inf"), dtype=scores.dtype,
                      device=scores.device)
    order = torch.argsort(-torch.where(valid, scores, ninf), dim=-1,
                          stable=True)[:, :T]
    sboxes = torch.gather(boxes, 1, order[..., None].expand(B, T, 4))
    svalid = torch.gather(valid, 1, order)
    pos = torch.arange(T, device=data.device)
    later = pos[None, :] > pos[:, None]                  # (T, T): j > i
    sup = (_iou_matrix(sboxes, sboxes) > overlap_thresh) & later
    if ii >= 0 and not force_suppress:
        ids = torch.gather(flat[..., ii], 1, order)
        sup = sup & (ids[..., :, None] == ids[..., None, :])
    keep = svalid
    for i in range(T):
        keep = keep & ~(sup[:, i] & keep[:, i, None])
    kept = torch.zeros((B, N), dtype=torch.bool, device=data.device)
    kept = kept.scatter(1, order, keep)
    out_scores = torch.where(kept, scores,
                             torch.full((), -1.0, dtype=scores.dtype,
                                        device=scores.device))
    coords = flat[..., cs:cs + 4]
    if out_format != in_format:
        cb = _to_corner(coords, in_format)
        if out_format == "center":
            x1, y1, x2, y2 = cb[..., 0], cb[..., 1], cb[..., 2], cb[..., 3]
            cb = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                              y2 - y1], dim=-1)
        coords = cb.to(flat.dtype)
    cols = [flat[..., j:j + 1] for j in range(flat.shape[-1])]
    cols[si] = out_scores[..., None]
    cols[cs:cs + 4] = [coords[..., j:j + 1] for j in range(4)]
    return torch.cat(cols, dim=-1).reshape(shape).to(data.dtype)


def _column_affine(t, mu, sd):
    """(t - mu) / sd per last-axis column, mu and sd tensors or tuples of
    Python floats (no host-to-device copy)."""
    if isinstance(mu, torch.Tensor) or isinstance(sd, torch.Tensor):
        return (t - mu) / sd
    return torch.stack([div_exact(t[..., j] - mu[j], sd[j]) for j in range(4)],
                       dim=-1)


@register("_contrib_box_encode")
def box_encode(samples, matches, anchors, refs, means=None, stds=None):
    """Matched boxes encoded against their anchors as normalized (dx,
    dy, dw, dh), and the mask of positive samples (ref: bounding_box.cc
    :: box_encode)."""
    mu = means if means is not None else (0.0, 0.0, 0.0, 0.0)
    sd = stds if stds is not None else (0.1, 0.1, 0.2, 0.2)
    M = refs.shape[1]
    m = matches.to(torch.int64)
    m = torch.where(m < 0, m + M, m).clamp(0, M - 1)
    g = torch.gather(refs, 1, m[..., None].expand(tuple(m.shape) + (4,)))
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    gx, gy = (g[..., 0] + g[..., 2]) / 2, (g[..., 1] + g[..., 3]) / 2
    gw, gh = g[..., 2] - g[..., 0], g[..., 3] - g[..., 1]
    t = torch.stack([(gx - ax) / torch.clamp(aw, min=1e-12),
                     (gy - ay) / torch.clamp(ah, min=1e-12),
                     torch.log(torch.clamp(gw, min=1e-12)
                               / torch.clamp(aw, min=1e-12)),
                     torch.log(torch.clamp(gh, min=1e-12)
                               / torch.clamp(ah, min=1e-12))], dim=-1)
    t = _column_affine(t, mu, sd)
    mask = (samples > 0.5)[..., None]
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return (torch.where(mask, t, zero).to(anchors.dtype),
            mask.expand(t.shape).to(anchors.dtype))


@register("_contrib_box_decode")
def box_decode(data, anchors, *, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="corner"):
    """(dx, dy, dw, dh) predictions decoded against anchors into corner
    boxes (ref: bounding_box.cc :: box_decode)."""
    a = _to_corner(anchors, format)
    ax, ay = (a[..., 0] + a[..., 2]) / 2, (a[..., 1] + a[..., 3]) / 2
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    dx = data[..., 0] * std0 * aw + ax
    dy = data[..., 1] * std1 * ah + ay
    dw = torch.exp(data[..., 2] * std2)
    dh = torch.exp(data[..., 3] * std3)
    if clip is not None and clip > 0:
        cap = torch.exp(torch.full((), float(clip), dtype=dw.dtype,
                                   device=dw.device))
        dw = torch.minimum(dw, cap)
        dh = torch.minimum(dh, cap)
    w, h = dw * aw / 2, dh * ah / 2
    return torch.stack([dx - w, dy - h, dx + w, dy + h],
                       dim=-1).to(data.dtype)


@register("_contrib_bipartite_matching")
def bipartite_matching(data, *, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching of a (B, N, M) score matrix (ref:
    bounding_box.cc :: bipartite_matching): min(N, M) (or topk) rounds,
    each taking the best remaining pair of every batch row, the first
    in row-major order on a tie. Returns (row -> column, column -> row),
    -1 where unmatched, in data's dtype."""
    B, N, M = data.shape
    big = float("inf") if is_ascend else float("-inf")
    k = min(N, M) if topk <= 0 else min(int(topk), min(N, M))
    dev = data.device
    mat = data
    row = torch.full((B, N), -1.0, dtype=data.dtype, device=dev)
    col = torch.full((B, M), -1.0, dtype=data.dtype, device=dev)
    rn = torch.arange(N, device=dev)
    cm = torch.arange(M, device=dev)
    for _ in range(k):
        flat = mat.reshape(B, N * M)
        best = flat.argmin(1) if is_ascend else flat.argmax(1)
        r, c = best // M, best % M
        v = torch.gather(flat, 1, best[:, None])[:, 0]
        ok = (v <= threshold) if is_ascend else (v >= threshold)
        hit_r = ok[:, None] & (rn[None] == r[:, None])
        hit_c = ok[:, None] & (cm[None] == c[:, None])
        row = torch.where(hit_r, c[:, None].to(row.dtype), row)
        col = torch.where(hit_c, r[:, None].to(col.dtype), col)
        mat = torch.where(hit_r[:, :, None] | hit_c[:, None, :],
                          torch.full((), big, dtype=mat.dtype, device=dev),
                          mat)
    return row, col


@register("_contrib_MultiBoxPrior")
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors (ref: contrib/multibox_prior.cc): at each pixel,
    sizes[0] with every ratio, then sizes[1:] with ratios[0]; (1, H * W
    * A, 4) corner boxes. The widths and heights are f32 constants
    rounded as the reference's f32 arithmetic rounds them."""
    H, W = data.shape[2], data.shape[3]
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    step_y = float(steps[0]) if steps[0] > 0 else 1.0 / H
    step_x = float(steps[1]) if steps[1] > 0 else 1.0 / W
    dev = data.device
    cy = (torch.arange(H, dtype=torch.float32, device=dev)
          + _f32(offsets[0])) * _f32(step_y)
    cx = (torch.arange(W, dtype=torch.float32, device=dev)
          + _f32(offsets[1])) * _f32(step_x)

    def wh(s, r):
        q = _f32(math.sqrt(_f32(r)))
        return _f32(_f32(s) * q), _f32(_f32(s) / q)
    whs = [wh(sizes[0], r) for r in ratios] + \
        [wh(s, ratios[0]) for s in sizes[1:]]
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    anchors = [torch.stack([cxg - w / 2, cyg - h / 2, cxg + w / 2,
                            cyg + h / 2], dim=-1) for w, h in whs]
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(data.dtype)


@register("_contrib_MultiBoxDetection")
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """SSD detection head (ref: contrib/multibox_detection.cc): each
    anchor's best non-background class and its decoded box, then NMS
    over the first ``nms_topk`` by score. (B, N, 6) rows [class id,
    score, x1, y1, x2, y2], -1 where invalid or suppressed."""
    B, Ncls, N = cls_prob.shape
    bg = (torch.arange(Ncls, device=cls_prob.device)
          == background_id)[None, :, None]
    masked = torch.where(bg, torch.full((), float("-inf"),
                                        dtype=cls_prob.dtype,
                                        device=cls_prob.device), cls_prob)
    scores = masked.amax(dim=1)
    cls_id = masked.argmax(dim=1).to(cls_prob.dtype)
    minus1 = torch.full((), -1.0, dtype=cls_prob.dtype,
                        device=cls_prob.device)
    live = scores > threshold
    cls_out = torch.where(live, cls_id - (1 if background_id == 0 else 0),
                          minus1)
    loc = loc_pred.reshape(B, N, 4)
    a = anchor.reshape(1, N, 4)
    v = variances
    ax, ay = (a[..., 0] + a[..., 2]) / 2, (a[..., 1] + a[..., 3]) / 2
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    dx = loc[..., 0] * v[0] * aw + ax
    dy = loc[..., 1] * v[1] * ah + ay
    dw = torch.exp(loc[..., 2] * v[2]) * aw / 2
    dh = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([dx - dw, dy - dh, dx + dw, dy + dh], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    det = torch.cat([cls_out[..., None],
                     torch.where(live, scores, minus1)[..., None], boxes],
                    dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   background_id=-1, force_suppress=force_suppress)


@register("_contrib_MultiBoxTarget")
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (ref: contrib/multibox_target.cc): each
    anchor matched to its best-overlap ground truth above the threshold,
    and each ground truth's best anchor forced; (loc_target, loc_mask,
    cls_target). The negative-mining arguments are taken and ignored,
    as in the reference."""
    N = anchor.shape[1]
    a = anchor.reshape(N, 4)
    B, M, _ = label.shape
    v = variances
    dev = anchor.device
    gt = label[..., 1:5]                                 # (B, M, 4)
    gt_id = label[..., 0]
    valid_gt = gt_id >= 0
    iou = _iou_matrix(a[None], gt)                       # (B, N, M)
    iou = torch.where(valid_gt[:, None, :], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=dev))
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)
    matched = best_iou >= overlap_threshold
    best_anchor = iou.argmax(dim=1)                      # (B, M)
    fm = (best_anchor[..., None] == torch.arange(N, device=dev)) \
        & valid_gt[..., None]                            # (B, M, N)
    forced = fm.any(dim=1)
    gt_forced = fm.to(torch.int32).argmax(dim=1)
    matched = matched | forced
    gt_for = torch.where(forced, gt_forced.to(torch.int64), best_gt)
    g = torch.gather(gt, 1, gt_for[..., None].expand(B, N, 4))
    ax, ay = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
    aw = torch.clamp(a[:, 2] - a[:, 0], min=1e-12)
    ah = torch.clamp(a[:, 3] - a[:, 1], min=1e-12)
    gx, gy = (g[..., 0] + g[..., 2]) / 2, (g[..., 1] + g[..., 3]) / 2
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-12)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-12)
    t = torch.stack([div_exact((gx - ax) / aw, v[0]),
                     div_exact((gy - ay) / ah, v[1]),
                     div_exact(torch.log(gw / aw), v[2]),
                     div_exact(torch.log(gh / ah), v[3])],
                    dim=-1)
    zero = torch.zeros((), dtype=t.dtype, device=dev)
    loc_t = torch.where(matched[..., None], t, zero)
    loc_m = matched[..., None].expand(B, N, 4).to(t.dtype)
    cls_t = torch.where(matched, torch.gather(gt_id, 1, gt_for) + 1.0, zero)
    return (loc_t.reshape(B, -1).to(anchor.dtype),
            loc_m.reshape(B, -1).to(anchor.dtype), cls_t.to(anchor.dtype))


# ---------------------------------------------------------------------------
# spectral / sketch / misc contrib
# ---------------------------------------------------------------------------
@register("_contrib_fft")
def contrib_fft(data, *, compute_size=128):
    """FFT of the last axis as interleaved (real, imag) pairs: last axis
    2 d (ref: contrib/fft.cc)."""
    f = torch.fft.fft(data.to(torch.complex64), dim=-1)
    return torch.view_as_real(f).reshape(
        tuple(data.shape[:-1]) + (2 * data.shape[-1],)).to(data.dtype)


@register("_contrib_ifft")
def contrib_ifft(data, *, compute_size=128):
    """The inverse of _contrib_fft, scaled by 1/d: interleaved (real,
    imag) in, the real part out (ref: contrib/ifft.cc)."""
    d = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (d, 2)).float()
    c = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(c, dim=-1).real.to(data.dtype)


@register("_contrib_count_sketch")
def count_sketch(data, h, s, *, out_dim, processing_batch_size=32):
    """out[..., h[j]] += s[j] * data[..., j] (ref:
    contrib/count_sketch.cc)."""
    idx = h.reshape(-1).to(torch.int64)
    sign = s.reshape(-1).to(data.dtype)
    out = torch.zeros(tuple(data.shape[:-1]) + (int(out_dim),),
                      dtype=data.dtype, device=data.device)
    return out.index_add(-1, idx, data * sign)


@register("_contrib_allclose")
def allclose(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1 (all close) or 0, a float32 vector of one, computed on the
    device (ref: contrib/allclose_op.cc)."""
    ok = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return ok.all().to(torch.float32).reshape(1)


class _ScaleGrad(torch.autograd.Function):
    """The identity whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


class _StraightThrough(torch.autograd.Function):
    """``fn(x)`` forward, the gradient passed through unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@register("_contrib_gradientmultiplier")
def gradientmultiplier(data, *, scalar=1.0):
    """The identity forward, the gradient times ``scalar`` (ref:
    contrib/gradient_multiplier_op.cc; gradient-reversal layers)."""
    return _ScaleGrad.apply(data, float(scalar))


@register("_contrib_quadratic", aliases=["_npx_quadratic"])
def quadratic(data, *, a=0.0, b=0.0, c=0.0):
    """a x^2 + b x + c (ref: contrib/quadratic_op.cc)."""
    return a * torch.square(data) + b * data + c


@register("_contrib_round_ste")
def round_ste(data):
    """round, with the gradient passed straight through (ref:
    contrib/stes_op.cc)."""
    return _StraightThrough.apply(data, torch.round)


@register("_contrib_sign_ste")
def sign_ste(data):
    """sign, with the gradient passed straight through (ref:
    contrib/stes_op.cc)."""
    return _StraightThrough.apply(data, torch.sign)


# ---------------------------------------------------------------------------
# resize / adaptive pooling
# ---------------------------------------------------------------------------
@register("_contrib_BilinearResize2D")
def bilinear_resize_2d(data, like=None, *, height=0, width=0,
                       scale_height=None, scale_width=None, mode="size",
                       align_corners=True):
    """NCHW bilinear resize (ref: contrib/bilinear_resize.cc), with the
    reference's sampling: rows clamped into the image, columns not (a
    column outside reads zeros)."""
    N, _, H, W = data.shape
    if like is not None:
        Ho, Wo = like.shape[2], like.shape[3]
    elif scale_height is not None:
        Ho = int(H * scale_height)
        Wo = int(W * (scale_width or scale_height))
    else:
        Ho, Wo = int(height), int(width)
    dev = data.device
    if align_corners and Ho > 1 and Wo > 1:
        ys = torch.linspace(0.0, H - 1, Ho, device=dev)
        xs = torch.linspace(0.0, W - 1, Wo, device=dev)
    else:
        ys = div_exact((torch.arange(Ho, device=dev) + 0.5) * H, Ho) - 0.5
        xs = div_exact((torch.arange(Wo, device=dev) + 0.5) * W, Wo) - 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    out = _bilinear_gather(data, xg.expand(N, Ho, Wo),
                           torch.clamp(yg, 0, H - 1).expand(N, Ho, Wo))
    return out.to(data.dtype)


def _avg_matrix(n_out, n_in, device):
    """(n_out, n_in): row i averages [floor(i n_in / n_out),
    ceil((i + 1) n_in / n_out)), built on the device."""
    i = torch.arange(n_out, device=device)
    s = (i * n_in) // n_out
    e = -((-(i + 1) * n_in) // n_out)
    j = torch.arange(n_in, device=device)
    inside = (j[None] >= s[:, None]) & (j[None] < e[:, None])
    return inside.to(torch.float32) / (e - s)[:, None].to(torch.float32)


@register("_contrib_AdaptiveAvgPooling2D")
def adaptive_avg_pooling_2d(data, *, output_size=(1, 1)):
    """Adaptive average pooling as two averaging matrices (ref:
    contrib/adaptive_avg_pooling.cc)."""
    if isinstance(output_size, (int, float)):
        size = (int(output_size),) * 2
    else:
        size = tuple(int(s) for s in output_size)
    Ho, Wo = size if len(size) == 2 else (size[0], size[0])
    H, W = data.shape[2], data.shape[3]
    mh = _avg_matrix(Ho, H, data.device)
    mw = _avg_matrix(Wo, W, data.device)
    out = torch.einsum("oh,nchw,pw->ncop", mh, data.float(), mw)
    return out.to(data.dtype)
