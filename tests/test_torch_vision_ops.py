"""The first half of the port's ``ops/vision_ops.py`` against the
reference's on the CPU: the samplers (``BilinearSampler``,
``GridGenerator``, ``SpatialTransformer``), the three ROI poolings, the
two deformable convolutions, mirroring the reference's
``tests/test_vision_ops.py``; ``Correlation``, ``LRN``, the box,
MultiBox and misc contrib ops are in ``test_torch_box_ops.py``.

The same numpy inputs go through ``mx.nd`` and ``pt.nd``; outputs by
dtype, shape and value, gradients through each package's autograd. f32
within 1e-5 relative and 1e-6 absolute where the math is the same. The
recast formulations give the same values in another f32 order:
``PSROIPooling`` sums a bin over columns then rows (the reference sums
both at once) and the bilinear samplers gather their four taps from a
channel-last view; they are held within 1e-5 relative and 1e-5
absolute, the largest f32 reordering error over these sizes with a 4x
margin. ``ROIPooling``'s separable max is exact.
"""
import numpy as np
import pytest

from mxnet_tpu_torch.ops import vision_ops

from test_torch_tensor_tail import _r, parity, run_op

SAMPLER_RTOL, SAMPLER_ATOL = 1e-5, 1e-5


def _rois(rs, n, R, H, W, scale=1.0):
    """R boxes (batch, x1, y1, x2, y2) in image coordinates: most inside
    the map, some past its edge, some one pixel wide."""
    b = rs.randint(0, n, R).astype(np.float32)
    x1 = rs.uniform(-2, W / scale, R)
    y1 = rs.uniform(-2, H / scale, R)
    w = rs.uniform(0, W / scale, R)
    h = rs.uniform(0, H / scale, R)
    w[::4] = 0.3
    return np.stack([b, x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
def test_bilinear_sampler():
    data = _r(2, 3, 5, 6, seed=1)
    grid = _r(2, 2, 4, 4, lo=-1.1, hi=1.1, seed=2)
    parity("BilinearSampler", [data, grid], grad=(0, 1),
           rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


def test_grid_generator():
    theta = _r(2, 6, seed=3)
    parity("GridGenerator", [theta], {"transform_type": "affine",
                           "target_shape": (3, 4)}, grad=(0,))
    flow = _r(2, 2, 3, 4, seed=4)
    parity("GridGenerator", [flow], {"transform_type": "warp"}, grad=(0,))


def test_spatial_transformer():
    data = _r(2, 3, 5, 6, seed=5)
    loc = (np.array([[1, 0, 0, 0, 1, 0]] * 2, np.float32)
           + 0.2 * _r(2, 6, seed=6))
    parity("SpatialTransformer", [data, loc], {"target_shape": (4, 5)},
           grad=(0, 1), rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pooled,scale", [((2, 2), 1.0), ((3, 2), 0.5),
                                          ((4, 5), 0.25)])
def test_roi_pooling(pooled, scale):
    rs = np.random.RandomState(7)
    data = _r(2, 3, 8, 9, seed=8)
    rois = _rois(rs, 2, 7, 8, 9, scale)
    parity("ROIPooling", [data, rois], {"pooled_size": pooled,
                                        "spatial_scale": scale}, grad=(0,))


def test_roi_pooling_ramp():
    """The reference's own case: corner maxima of a monotone ramp."""
    data = np.arange(2 * 6 * 6, dtype=np.float32).reshape(2, 1, 6, 6)
    rois = np.array([[0, 0, 0, 5, 5], [1, 2, 2, 5, 5], [0, 7, 7, 9, 9]],
                    np.float32)
    out = parity("ROIPooling", [data, rois], {"pooled_size": (2, 2)})
    assert out[0][0, 0, 1, 1] == data[0, 0].max()
    assert (out[0][2] == 0).all()            # outside the map: empty bins


def test_window_max_table_queries():
    """Every window [a, b) of the sparse table's two lookups is the
    window's max."""
    import torch
    x = torch.tensor(_r(3, 13, seed=9))
    table = vision_ops._window_max_table(x, 1)
    for a in range(13):
        for b in range(a + 1, 14):
            k = int(vision_ops._level(torch.tensor(b - a),
                                      table.shape[0]))
            got = torch.maximum(table[k][:, a], table[k][:, b - (1 << k)])
            assert torch.equal(got, x[:, a:b].amax(1))


@pytest.mark.parametrize("attrs", [
    {"pooled_size": (2, 3), "sample_ratio": 2},
    {"pooled_size": (3, 3), "sample_ratio": -1, "spatial_scale": 0.5},
    {"pooled_size": (2, 2), "sample_ratio": 3, "aligned": True},
    {"pooled_size": (2, 2), "position_sensitive": True}])
def test_roi_align(attrs):
    rs = np.random.RandomState(10)
    C = 8 if attrs.get("position_sensitive") else 4
    data = _r(2, C, 8, 9, seed=11)
    rois = _rois(rs, 2, 6, 8, 9, attrs.get("spatial_scale", 1.0))
    parity("_contrib_ROIAlign", [data, rois], attrs, grad=(0, 1),
           rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


def test_roi_align_position_sensitive_channels():
    """A non-divisible channel count is an error in both packages."""
    rois = np.array([[0, 1, 1, 6, 6]], np.float32)
    for which in ("ref", "port"):
        with pytest.raises(ValueError):
            run_op(which, "_contrib_ROIAlign",
                   [np.zeros((1, 5, 8, 8), np.float32), rois],
                   {"pooled_size": (2, 2), "position_sensitive": True})


@pytest.mark.parametrize("P,G,OD", [(2, 0, 2), (3, 0, 1), (3, 3, 2),
                                    (4, 2, 1)])
def test_psroi_pooling(P, G, OD):
    rs = np.random.RandomState(12)
    groups = G or P
    data = _r(2, OD * groups * groups, 8, 9, seed=13)
    rois = _rois(rs, 2, 5, 8, 9, 0.5)
    attrs = {"spatial_scale": 0.5, "output_dim": OD, "pooled_size": P}
    if G:
        attrs["group_size"] = G
    parity("_contrib_PSROIPooling", [data, rois], attrs, grad=(0,),
           rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


# ---------------------------------------------------------------------------
# deformable convolutions
# ---------------------------------------------------------------------------
DEFORM = [dict(kernel=(3, 3), pad=(1, 1), num_filter=4,
               num_deformable_group=2, num_group=1),
          dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), stride=(2, 1),
               num_filter=4, num_deformable_group=1, num_group=2),
          dict(kernel=(2, 3), num_filter=2, no_bias=True)]


def _deform_inputs(attrs, seed, modulated):
    kh, kw = attrs["kernel"]
    sh, sw = attrs.get("stride", (1, 1))
    ph, pw = attrs.get("pad", (0, 0))
    dh, dw = attrs.get("dilate", (1, 1))
    N, C, H, W = 2, 4, 6, 7
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = attrs.get("num_deformable_group", 1)
    g = attrs.get("num_group", 1)
    ins = [_r(N, C, H, W, seed=seed),
           _r(N, dg * 2 * kh * kw, Ho, Wo, lo=-1.5, hi=1.5, seed=seed + 1)]
    if modulated:
        ins.append(_r(N, dg * kh * kw, Ho, Wo, lo=0, hi=1, seed=seed + 2))
    ins.append(_r(attrs["num_filter"], C // g, kh, kw, seed=seed + 3))
    if not attrs.get("no_bias"):
        ins.append(_r(attrs["num_filter"], seed=seed + 4))
    return ins


@pytest.mark.parametrize("name", ["_contrib_DeformableConvolution",
                                  "_contrib_ModulatedDeformableConvolution"])
@pytest.mark.parametrize("case", range(len(DEFORM)))
def test_deformable_convolution(name, case):
    attrs = DEFORM[case]
    ins = _deform_inputs(attrs, 20 + case, "Modulated" in name)
    parity(name, ins, attrs, grad=tuple(range(len(ins))),
           rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)


def test_deformable_zero_offset_is_the_convolution():
    data = _r(2, 3, 6, 6, seed=30)
    weight = _r(4, 3, 3, 3, seed=31)
    offset = np.zeros((2, 18, 4, 4), np.float32)
    out, _ = run_op("port", "_contrib_DeformableConvolution",
                    [data, offset, weight],
                    {"kernel": (3, 3), "num_filter": 4, "no_bias": True})
    conv, _ = run_op("port", "Convolution", [data, weight],
                     {"kernel": (3, 3), "num_filter": 4, "no_bias": True})
    np.testing.assert_allclose(out[0], conv[0], rtol=1e-5, atol=1e-5)
