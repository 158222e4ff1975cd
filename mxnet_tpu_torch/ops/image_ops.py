"""Image operators, the ``nd.image`` namespace (counterpart of
``mxnet_tpu/ops/image_ops.py``; ref: src/operator/image/ —
image_random.cc, crop.cc, resize.cc).

They take HWC (or NHWC batched) uint8 or float images;
``_image_to_tensor`` turns them into CHW float32 in [0, 1]. An integer
image comes back rounded, clipped to [0, 255] and in its own dtype. The
random ones draw their factors on the data's device from the context's
generator (``mxnet_tpu_torch.random``), where the reference splits its
PRNG key: a seeded run repeats itself, and parity with the reference is
by distribution, or exact at pinned factors. ``_image_resize`` is
``torch.nn.functional.interpolate`` with the reference's
``jax.image.resize`` conventions: half-pixel centres, and for bilinear
the antialiasing triangle filter that widens with the downscale factor.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..context import context_of
from . import register


def _batched(data):
    return data.dim() == 4


def _draw(data, shape=(), low=0.0, high=1.0, normal=False):
    """Uniform in [low, high) (or standard normal) of ``shape`` on the
    data's device, from its context's generator."""
    g = _random.generator(context_of(data.device))
    if normal:
        return torch.randn(shape, generator=g, device=data.device)
    u = torch.rand(shape, generator=g, device=data.device)
    return low + (high - low) * u


@register("_image_to_tensor")
def image_to_tensor(data):
    """HWC in [0, 255] to CHW float32 in [0, 1] (ref: ToTensor)."""
    x = data.to(torch.float32) / 255.0
    if _batched(data):
        return x.permute(0, 3, 1, 2)
    return x.permute(2, 0, 1)


@register("_image_normalize")
def image_normalize(data, *, mean=(0.0,), std=(1.0,)):
    """(x - mean) / std per channel of a CHW (or NCHW) tensor (ref:
    Normalize, after to_tensor)."""
    shape = (-1, 1, 1) if not _batched(data) else (1, -1, 1, 1)
    mean = torch.as_tensor(mean, dtype=data.dtype,
                           device=data.device).reshape(shape)
    std = torch.as_tensor(std, dtype=data.dtype,
                          device=data.device).reshape(shape)
    return (data - mean) / std


def _flip(data, axis_hwc):
    return torch.flip(data, dims=(axis_hwc + (1 if _batched(data) else 0),))


@register("_image_flip_left_right")
def image_flip_left_right(data):
    return _flip(data, 1)


@register("_image_flip_top_bottom")
def image_flip_top_bottom(data):
    return _flip(data, 0)


@register("_image_random_flip_left_right", needs_rng=True)
def image_random_flip_left_right(data, *, p=0.5):
    return torch.where(_draw(data) < p, _flip(data, 1), data)


@register("_image_random_flip_top_bottom", needs_rng=True)
def image_random_flip_top_bottom(data, *, p=0.5):
    return torch.where(_draw(data) < p, _flip(data, 0), data)


@register("_image_crop")
def image_crop(data, *, x, y, width, height):
    """The fixed HWC window at (x, y) (ref: crop.cc)."""
    x, y, width, height = int(x), int(y), int(width), int(height)
    if _batched(data):
        return data[:, y:y + height, x:x + width, :]
    return data[y:y + height, x:x + width, :]


@register("_image_resize")
def image_resize(data, *, size=(0, 0), keep_ratio=False, interp=1):
    """HWC resize to ``size`` = (w, h) or an int (ref: resize.cc)."""
    if isinstance(size, (int, float)):
        w = h = int(size)
    else:
        w, h = int(size[0]), int(size[1] if len(size) > 1 else size[0])
    x = data.to(torch.float32)
    x = x.permute(0, 3, 1, 2) if _batched(data) else x.permute(2, 0, 1)[None]
    if int(interp) != 0:
        out = F.interpolate(x, size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)
    else:
        out = F.interpolate(x, size=(h, w), mode="nearest-exact")
    out = out.permute(0, 2, 3, 1)
    if not _batched(data):
        out = out[0]
    if not data.is_floating_point():
        out = torch.round(out)
    return out.to(data.dtype)


def _finish(data, out):
    if not data.is_floating_point():
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(data.dtype)


def _blend(a, b, alpha):
    return a.to(torch.float32) * alpha + b * (1.0 - alpha)


_GRAY = (0.299, 0.587, 0.114)


def _gray(data):
    w = torch.tensor(_GRAY, dtype=torch.float32, device=data.device)
    return (data.to(torch.float32) * w).sum(dim=-1, keepdim=True)


@register("_image_random_brightness", needs_rng=True)
def image_random_brightness(data, *, min_factor, max_factor):
    alpha = _draw(data, low=min_factor, high=max_factor)
    return _finish(data, data.to(torch.float32) * alpha)


@register("_image_random_contrast", needs_rng=True)
def image_random_contrast(data, *, min_factor, max_factor):
    alpha = _draw(data, low=min_factor, high=max_factor)
    return _finish(data, _blend(data, _gray(data).mean(), alpha))


@register("_image_random_saturation", needs_rng=True)
def image_random_saturation(data, *, min_factor, max_factor):
    alpha = _draw(data, low=min_factor, high=max_factor)
    return _finish(data, _blend(data, _gray(data), alpha))


_T_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.321),
          (0.211, -0.523, 0.311))
_T_RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.107, 1.705))


@register("_image_random_hue", needs_rng=True)
def image_random_hue(data, *, min_factor, max_factor):
    """Hue rotation through the YIQ linear approximation (ref:
    image_random.cc :: RandomHue)."""
    alpha = _draw(data, low=min_factor, high=max_factor)
    u, w = torch.cos(alpha * math.pi), torch.sin(alpha * math.pi)
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, u, -w]),
                       torch.stack([zero, w, u])])
    dev = data.device
    m = torch.tensor(_T_RGB, device=dev) @ rot @ torch.tensor(_T_YIQ,
                                                                device=dev)
    return _finish(data, data.to(torch.float32) @ m.t())


@register("_image_random_color_jitter", needs_rng=True)
def image_random_color_jitter(data, *, brightness=0.0, contrast=0.0,
                              saturation=0.0, hue=0.0):
    out = data
    if brightness > 0:
        out = image_random_brightness(out, min_factor=1 - brightness,
                                      max_factor=1 + brightness)
    if contrast > 0:
        out = image_random_contrast(out, min_factor=1 - contrast,
                                    max_factor=1 + contrast)
    if saturation > 0:
        out = image_random_saturation(out, min_factor=1 - saturation,
                                      max_factor=1 + saturation)
    if hue > 0:
        out = image_random_hue(out, min_factor=-hue, max_factor=hue)
    return out


_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009), (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))


def _lighting(data, alpha):
    dev = data.device
    delta = (torch.tensor(_EIGVEC, device=dev) * alpha
             * torch.tensor(_EIGVAL, device=dev)).sum(dim=1)
    return _finish(data, data.to(torch.float32) + delta)


@register("_image_adjust_lighting")
def image_adjust_lighting(data, *, alpha):
    """AlexNet's PCA lighting on a fixed eigenbasis (ref:
    image_random.cc :: AdjustLighting)."""
    return _lighting(data, torch.as_tensor(alpha, dtype=torch.float32,
                                           device=data.device))


@register("_image_random_lighting", needs_rng=True)
def image_random_lighting(data, *, alpha_std=0.05):
    return _lighting(data, _draw(data, (3,), normal=True) * alpha_std)
