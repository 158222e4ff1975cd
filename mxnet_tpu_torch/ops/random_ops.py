"""Random sampling operators and the distributions' densities
(counterpart of ``mxnet_tpu/ops/random_ops.py``; ref:
src/operator/random/sample_op.cc, multisample_op.cc, shuffle_op.cc,
unique_sample_op.cc and pdf_op.cc).

Every draw takes ``generator=`` the generator of the context it runs on
(:func:`mxnet_tpu_torch.random.generator`); nothing draws from torch's
global generator, so ``mx.random.seed`` repeats every draw. The
``_random_*`` samplers and ``_sample_unique_zipfian`` take no input
array and get their device from the call's ``ctx`` (``_device``); the
``_sample_*`` samplers draw on their parameters' device, one draw of
``shape`` for each parameter element (output shape: the parameters'
shape followed by ``shape``). Gamma draws are torch's
``_standard_gamma`` and Poisson draws ``torch.poisson``; the negative
binomials are their Gamma-Poisson mixtures, as in the reference. The
two packages draw from different generators, so the values differ and
the distributions agree. A draw inside a captured CUDA graph advances
the generator on each replay (``cached_op._capture`` registers it).

The densities (``_random_pdf_*``) are compositions of torch ops,
differentiable in the sample and in every parameter; ``is_log`` gives
the log density.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import torch_dtype
from ..context import context_of
from . import register


def _tuple(shape):
    if shape is None:
        return ()
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _gen(device) -> torch.Generator:
    return _random.generator(context_of(torch.device(device)))


def _float(dtype):
    """The dtype gamma and Poisson draws are made in (float64 for a
    float64 result, else float32)."""
    return torch.float64 if torch_dtype(dtype) == torch.float64 \
        else torch.float32


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws, one for each element of ``alpha``."""
    return torch._standard_gamma(alpha.contiguous(), generator=generator)


# ---------------------------------------------------------------------------
# scalar-parameter samplers
# ---------------------------------------------------------------------------
@register("_random_uniform", aliases=["uniform", "random_uniform"],
          needs_rng=True, needs_device=True)
def random_uniform(*, low=0.0, high=1.0, shape=(1,), dtype="float32",
                   _device=None):
    u = torch.rand(_tuple(shape), generator=_gen(_device),
                   dtype=torch_dtype(dtype), device=_device)
    return low + (high - low) * u


@register("_random_normal", aliases=["normal", "random_normal"],
          needs_rng=True, needs_device=True)
def random_normal(*, loc=0.0, scale=1.0, shape=(1,), dtype="float32",
                  _device=None):
    z = torch.randn(_tuple(shape), generator=_gen(_device),
                    dtype=torch_dtype(dtype), device=_device)
    return loc + scale * z


@register("_random_gamma", aliases=["random_gamma"], needs_rng=True,
          needs_device=True)
def random_gamma(*, alpha=1.0, beta=1.0, shape=(1,), dtype="float32",
                 _device=None):
    """Gamma of shape ``alpha`` and scale ``beta``."""
    a = torch.full(_tuple(shape), float(alpha), dtype=_float(dtype),
                   device=_device)
    return (beta * _gamma(a, _gen(_device))).to(torch_dtype(dtype))


@register("_random_exponential", aliases=["random_exponential"],
          needs_rng=True, needs_device=True)
def random_exponential(*, lam=1.0, shape=(1,), dtype="float32",
                       _device=None):
    e = torch.empty(_tuple(shape), dtype=torch_dtype(dtype), device=_device)
    return e.exponential_(1.0, generator=_gen(_device)) / lam


@register("_random_poisson", aliases=["random_poisson"], needs_rng=True,
          needs_device=True)
def random_poisson(*, lam=1.0, shape=(1,), dtype="float32", _device=None):
    rate = torch.full(_tuple(shape), float(lam), dtype=_float(dtype),
                      device=_device)
    return torch.poisson(rate, generator=_gen(_device)).to(
        torch_dtype(dtype))


@register("_random_randint", aliases=["random_randint"], needs_rng=True,
          needs_device=True)
def random_randint(*, low, high, shape=(1,), dtype="int32", _device=None):
    return torch.randint(int(low), int(high), _tuple(shape),
                         generator=_gen(_device), dtype=torch_dtype(dtype),
                         device=_device)


def _poisson_of_gamma(shape_par, scale, generator, dtype):
    """Poisson draws whose rates are Gamma(shape_par) * scale draws (the
    negative binomials' mixture)."""
    lam = _gamma(shape_par, generator) * scale
    return torch.poisson(lam, generator=generator).to(torch_dtype(dtype))


@register("_random_negative_binomial", aliases=["random_negative_binomial"],
          needs_rng=True, needs_device=True)
def random_negative_binomial(*, k=1, p=1.0, shape=(1,), dtype="float32",
                             _device=None):
    """NB(k, p): failures before the k-th success of probability p."""
    a = torch.full(_tuple(shape), float(k), dtype=_float(dtype),
                   device=_device)
    return _poisson_of_gamma(a, (1.0 - p) / p, _gen(_device), dtype)


@register("_random_generalized_negative_binomial",
          aliases=["random_generalized_negative_binomial"], needs_rng=True,
          needs_device=True)
def random_generalized_negative_binomial(*, mu=1.0, alpha=1.0, shape=(1,),
                                         dtype="float32", _device=None):
    """GNB(mu, alpha): Poisson with a Gamma(1/alpha, alpha*mu) rate."""
    a = torch.full(_tuple(shape), 1.0 / alpha, dtype=_float(dtype),
                   device=_device)
    return _poisson_of_gamma(a, alpha * mu, _gen(_device), dtype)


# ---------------------------------------------------------------------------
# array-parameter samplers
# ---------------------------------------------------------------------------
def _param_shape(par, shape):
    """(output shape, the parameter's broadcast shape)."""
    shape = _tuple(shape)
    return tuple(par.shape) + shape, tuple(par.shape) + (1,) * len(shape)


@register("_sample_uniform", aliases=["sample_uniform"], needs_rng=True)
def sample_uniform(low, high, *, shape=(), dtype="float32"):
    shp, b = _param_shape(low, shape)
    u = torch.rand(shp, generator=_gen(low.device), dtype=torch_dtype(dtype),
                   device=low.device)
    return low.reshape(b) + u * (high - low).reshape(b)


@register("_sample_normal", aliases=["sample_normal"], needs_rng=True)
def sample_normal(mu, sigma, *, shape=(), dtype="float32"):
    shp, b = _param_shape(mu, shape)
    z = torch.randn(shp, generator=_gen(mu.device), dtype=torch_dtype(dtype),
                    device=mu.device)
    return mu.reshape(b) + z * sigma.reshape(b)


@register("_sample_exponential", aliases=["sample_exponential"],
          needs_rng=True)
def sample_exponential(lam, *, shape=(), dtype="float32"):
    shp, b = _param_shape(lam, shape)
    e = torch.empty(shp, dtype=torch_dtype(dtype), device=lam.device)
    e = e.exponential_(1.0, generator=_gen(lam.device))
    return e / lam.reshape(b)


@register("_sample_gamma", aliases=["sample_gamma"], needs_rng=True)
def sample_gamma(alpha, beta, *, shape=(), dtype="float32"):
    """Gamma draws of shape ``alpha`` and scale ``beta``, differentiable
    in both (torch's implicit gradient of ``_standard_gamma``)."""
    shp, b = _param_shape(alpha, shape)
    a = alpha.reshape(b).expand(shp).to(_float(dtype))
    g = _gamma(a, _gen(alpha.device)).to(torch_dtype(dtype))
    return g * beta.reshape(b)


@register("_sample_poisson", aliases=["sample_poisson"], needs_rng=True)
def sample_poisson(lam, *, shape=(), dtype="float32"):
    shp, b = _param_shape(lam, shape)
    rate = lam.detach().reshape(b).expand(shp).to(_float(dtype))
    return torch.poisson(rate.contiguous(), generator=_gen(lam.device)).to(
        torch_dtype(dtype))


@register("_sample_negative_binomial", aliases=["sample_negative_binomial"],
          needs_rng=True)
def sample_negative_binomial(k, p, *, shape=(), dtype="float32"):
    shp, b = _param_shape(k, shape)
    k = k.detach().reshape(b).expand(shp).to(_float(dtype))
    p = p.detach().reshape(b).to(_float(dtype))
    return _poisson_of_gamma(k, (1.0 - p) / p, _gen(k.device), dtype)


@register("_sample_generalized_negative_binomial",
          aliases=["sample_generalized_negative_binomial"], needs_rng=True)
def sample_generalized_negative_binomial(mu, alpha, *, shape=(),
                                         dtype="float32"):
    shp, b = _param_shape(mu, shape)
    mu = mu.detach().reshape(b).to(_float(dtype))
    alpha = alpha.detach().reshape(b).to(_float(dtype))
    r = (1.0 / alpha).expand(shp)
    return _poisson_of_gamma(r, alpha * mu, _gen(mu.device), dtype)


@register("_sample_multinomial", aliases=["sample_multinomial"],
          needs_rng=True)
def sample_multinomial(data, *, shape=(), get_prob=False, dtype="int32"):
    """``shape`` category draws (one when ``shape`` is empty) from each
    distribution on ``data``'s last axis (probabilities, normalized
    here); with ``get_prob`` also each draw's log probability,
    differentiable in ``data``."""
    shape = _tuple(shape)
    n = max(math.prod(shape), 1)
    k = data.shape[-1]
    probs = data.detach().reshape(-1, k).float()
    idx = torch.multinomial(probs, n, replacement=True,
                            generator=_gen(data.device))
    out_shape = tuple(data.shape[:-1]) + shape
    out = idx.reshape(out_shape).to(torch_dtype(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(torch.clamp_min(data, 1e-30)), dim=-1)
    lp = torch.gather(logp.reshape(-1, k), 1, idx)
    return out, lp.reshape(out_shape)


@register("_shuffle", aliases=["shuffle"], needs_rng=True)
def shuffle(data):
    """The rows of ``data`` (axis 0) in a random order."""
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", needs_rng=True, needs_device=True)
def sample_unique_zipfian(*, range_max, shape=(1,), _device=None):
    """Zipfian class draws in [0, range_max) (ref: unique_sample_op.cc,
    the negatives of sampled softmax): floor(exp(u log(range_max + 1)))
    - 1 for uniform u, and the counts (ones, as the reference returns
    them)."""
    shape = _tuple(shape)
    u = torch.rand(max(math.prod(shape), 1), generator=_gen(_device),
                   device=_device)
    log_range = torch.tensor(float(range_max) + 1.0, device=_device).log()
    cls = torch.exp(u * log_range).to(torch.int32) - 1
    cls = torch.clamp(cls, 0, int(range_max) - 1)
    return cls.reshape(shape), torch.ones(shape, dtype=torch.int32,
                                          device=_device)


# ---------------------------------------------------------------------------
# densities
# ---------------------------------------------------------------------------
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _bcast_param(sample, par):
    """A (batch,)-shaped parameter against a (batch, n) sample, as
    pdf_op.cc broadcasts it."""
    return par.reshape(tuple(par.shape) + (1,) * (sample.dim() - par.dim()))


def _make_pdf(name, logpdf):
    def impl(sample, *params, is_log=False):
        lp = logpdf(sample, *[_bcast_param(sample, p) for p in params])
        return (lp if is_log else torch.exp(lp)).to(sample.dtype)
    impl.__name__ = name
    impl.__doc__ = "Density of %s at the sample points (ref: pdf_op.cc)." \
        % name.replace("_random_pdf_", "")
    register(name)(impl)


def _uniform_logpdf(x, lo, hi):
    inside = (x >= lo) & (x <= hi)
    return torch.where(inside, -torch.log(hi - lo),
                       torch.full((), -math.inf, dtype=x.dtype,
                                  device=x.device))


_make_pdf("_random_pdf_uniform", _uniform_logpdf)
_make_pdf("_random_pdf_normal", lambda x, mu, sig: (
    -0.5 * torch.square((x - mu) / sig) - torch.log(sig) - _HALF_LOG_2PI))
_make_pdf("_random_pdf_exponential", lambda x, lam: torch.log(lam) - lam * x)
# b is the rate here, as in the reference's pdf
_make_pdf("_random_pdf_gamma", lambda x, a, b: (
    a * torch.log(b) + (a - 1) * torch.log(x) - b * x - torch.lgamma(a)))
_make_pdf("_random_pdf_poisson", lambda x, lam: (
    x * torch.log(lam) - lam - torch.lgamma(x + 1)))
_make_pdf("_random_pdf_negative_binomial", lambda x, k, p: (
    torch.lgamma(x + k) - torch.lgamma(x + 1) - torch.lgamma(k)
    + k * torch.log(p) + x * torch.log1p(-p)))
_make_pdf("_random_pdf_generalized_negative_binomial", lambda x, mu, alpha: (
    torch.lgamma(x + 1.0 / alpha) - torch.lgamma(x + 1)
    - torch.lgamma(1.0 / alpha)
    + (1.0 / alpha) * torch.log(1.0 / (1.0 + alpha * mu))
    + x * torch.log(alpha * mu / (1.0 + alpha * mu))))


@register("_random_pdf_dirichlet")
def random_pdf_dirichlet(sample, alpha, *, is_log=False):
    """Dirichlet density over the last axis (ref: pdf_op.cc)."""
    if alpha.dim() == sample.dim():
        a = alpha
    else:
        a = alpha.reshape(tuple(alpha.shape[:-1])
                          + (1,) * (sample.dim() - alpha.dim())
                          + tuple(alpha.shape[-1:]))
    lp = (torch.sum((a - 1) * torch.log(sample), dim=-1)
          + torch.lgamma(torch.sum(a, dim=-1))
          - torch.sum(torch.lgamma(a), dim=-1))
    return (lp if is_log else torch.exp(lp)).to(sample.dtype)
