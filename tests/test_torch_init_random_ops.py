"""The creation ops (``ops/init_ops.py``), the samplers and densities
(``ops/random_ops.py``) and ``mx.random`` of the port against the
reference on the CPU.

Creation ops by value and dtype, within one f32 ulp. The two packages
draw from different generators, so each sampler is held, in both
packages at a fixed seed, by shape, dtype and one distribution
statistic against scipy's distribution: the Kolmogorov-Smirnov
statistic of 20000 continuous draws under ``KS_BOUND`` (the 0.1%
critical value, 1.95 / sqrt(n)), a chi-square over the discrete
outcomes with at least 5 expected draws at p above ``CHI2_P``. The
densities by value and by gradient in the sample and in every parameter
within 1e-5 relative (f32 lgamma and log chains), the parameter
gradients within 1e-4 (differences of two f32 digammas, each a few ulps
apart between torch and XLA, cancel to a tenth of their size). Then ``seed``, MXNet
1.x's positional scalars (the reference refuses them), random ops in a
hybridized block (new draws each call, repeated after ``seed``, the
hybridized run equal to the eager one bit for bit), the op names against
the reference's three modules, and a scan of the port's source showing
that every draw passes ``generator=``.
"""
import ast
import math
import pathlib

import numpy as np
import pytest
import scipy.stats as st

import mxnet_tpu as mx
import mxnet_tpu.ops as ref_ops
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.ops as port_ops

N_DRAWS = 20000
KS_BOUND = 1.95 / math.sqrt(N_DRAWS)
CHI2_P = 1e-3
RTOL, ATOL = 1e-5, 1e-6
# the densities' parameter gradients are differences of digammas (torch's
# and XLA's f32 digamma differ by a few ulps), which cancel to a tenth
PDF_GRAD_RTOL = 1e-4


def _ctx(lib):
    return lib.cpu()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("module", ["init_ops", "random_ops", "nn",
                                    "tensor_tail", "matrix", "contrib_ops",
                                    "vision_ops"])
def test_op_names_match_reference(module):
    """Every name the reference's module registers, and its aliases,
    resolve in the port to the op the reference resolves them to (an
    alias that is also an op's own name, as ``reverse``, resolves to
    that op in both)."""
    names = [n for n, op in ref_ops._OPS.items()
             if op.impl.__module__ == "mxnet_tpu.ops." + module]
    assert names
    missing = [n for n in names if n not in port_ops._OPS]
    assert not missing, missing
    aliases = [a for a, n in ref_ops._ALIASES.items() if n in names]
    unresolved = [a for a in aliases
                  if port_ops.get_op(a).name != ref_ops.get_op(a).name]
    assert not unresolved, unresolved


# ---------------------------------------------------------------------------
# creation ops
# ---------------------------------------------------------------------------
CREATION = [
    ("arange", (5,), {}),
    ("arange", (2, 11, 3), {}),
    ("arange", (1.5, 4.0, 0.5), {"repeat": 3}),
    ("arange", (0, 10), {"dtype": "int32"}),
    ("arange", (), {"start": 7}),
    ("linspace", (0, 1, 7), {}),
    ("linspace", (-2.0, 3.0, 6), {"endpoint": False}),
    ("eye", (4,), {}),
    ("eye", (3, 5, 1), {}),
    ("eye", (5,), {"M": 3, "k": -2, "dtype": "int32"}),
    ("full", ((2, 3), 2.5), {}),
    ("full", ((4,), 7), {"dtype": "int32"}),
    ("zeros", ((3, 2),), {"dtype": "float16"}),
    ("ones", (4,), {"dtype": "int32"}),
]


@pytest.mark.parametrize("name,args,kw", CREATION)
def test_creation_ops_match_reference(name, args, kw):
    outs = [getattr(lib.nd, name)(*args, ctx=_ctx(lib), **kw)
            for lib in (mx, pt)]
    r, p = outs
    assert p.dtype == r.dtype and p.shape == r.shape
    assert p.context == pt.cpu()
    np.testing.assert_allclose(p.asnumpy(), r.asnumpy(), rtol=2 ** -23,
                               atol=0)


@pytest.mark.parametrize("name,attrs", [
    ("_arange", {"start": 3, "stop": 9, "step": 2}),
    ("_linspace", {"start": 0, "stop": 2, "num": 5}),
    ("_eye", {"N": 3, "k": 1}),
    ("_full", {"shape": (2, 2), "value": -1.0}),
    ("_zeros", {"shape": (2,)}),
    ("ones", {"shape": (1, 3), "dtype": "int32"}),
])
def test_creation_ops_through_F(name, attrs):
    """The op names (what hybrid_forward's F reaches) with ctx by keyword
    and under ``with ctx``."""
    r = getattr(mx.nd, name)(ctx=mx.cpu(), **attrs)
    p = getattr(pt.ops.F, name)(ctx=pt.cpu(), **attrs)
    with pt.cpu():
        q = getattr(pt.ops.F, name)(**attrs)
    for got in (p, q):
        assert got.dtype == r.dtype
        np.testing.assert_array_equal(got.asnumpy(), r.asnumpy())


def test_creation_default_context_is_the_card():
    """Without ctx a zero-input op runs in the current context, gpu(0)
    by default: on a machine without a card it raises, and nothing
    falls back to the CPU."""
    if pt.num_gpus():
        pytest.skip("a CUDA device is present")
    for call in (lambda: pt.nd.arange(3), lambda: pt.nd.zeros((2,)),
                 lambda: pt.random.uniform(shape=(2,)),
                 lambda: pt.ops.F.random_normal(shape=(2,))):
        with pytest.raises(pt.MXNetError, match="no CUDA device"):
            call()


def test_zeros_ones_keep_their_signatures():
    """``nd.zeros``/``nd.ones`` take (shape, ctx, dtype) by position and
    an int shape, as before the ops were registered."""
    z = pt.nd.zeros(3, pt.cpu(), "int32")
    o = pt.nd.ones((2, 2), pt.cpu())
    assert z.shape == (3,) and z.dtype == np.int32
    assert o.dtype == np.float32 and o.asnumpy().sum() == 4
    assert pt.nd.zeros((1,), ctx=pt.cpu_pinned()).context == pt.cpu_pinned()


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
def _ks(draws, dist):
    return st.kstest(np.asarray(draws, np.float64).ravel(), dist.cdf).statistic


def _chi2_p(draws, pmf, support):
    """p-value of a chi-square of the draws against ``pmf`` over the
    outcomes in ``support`` with at least 5 expected draws, the rest
    pooled."""
    draws = np.asarray(draws).ravel()
    n = draws.size
    probs = np.array([pmf(k) for k in support])
    keep = probs * n >= 5
    obs = [int((draws == k).sum()) for k, kp in zip(support, keep) if kp]
    exp = list(probs[keep] * n)
    rest_obs = n - sum(obs)
    rest_exp = n - sum(exp)
    if rest_exp >= 5:
        obs.append(rest_obs)
        exp.append(rest_exp)
    exp = np.array(exp) * (np.sum(obs) / np.sum(exp))
    return st.chisquare(obs, exp).pvalue


CONTINUOUS = [
    ("random_uniform", {"low": -1.0, "high": 3.0}, st.uniform(-1.0, 4.0)),
    ("random_normal", {"loc": 2.0, "scale": 0.5}, st.norm(2.0, 0.5)),
    ("random_gamma", {"alpha": 2.5, "beta": 1.5}, st.gamma(2.5, scale=1.5)),
    ("random_exponential", {"lam": 2.0}, st.expon(scale=0.5)),
]
DISCRETE = [
    ("random_poisson", {"lam": 4.0}, st.poisson(4.0), np.float32),
    ("random_randint", {"low": -3, "high": 7}, st.randint(-3, 7), np.int32),
    ("random_negative_binomial", {"k": 3, "p": 0.4}, st.nbinom(3, 0.4),
     np.float32),
    ("random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     st.nbinom(2.0, 1 / (1 + 0.5 * 2.0)), np.float32),
]


def _draw(lib, name, seed=3, **attrs):
    lib.random.seed(seed)
    return getattr(lib.nd, name)(shape=(N_DRAWS,), ctx=_ctx(lib), **attrs)


@pytest.mark.parametrize("name,attrs,dist", CONTINUOUS)
def test_continuous_samplers(name, attrs, dist):
    for lib in (mx, pt):
        out = _draw(lib, name, **attrs)
        assert out.shape == (N_DRAWS,) and out.dtype == np.float32
        assert _ks(out.asnumpy(), dist) < KS_BOUND, lib.__name__


@pytest.mark.parametrize("name,attrs,dist,dtype", DISCRETE)
def test_discrete_samplers(name, attrs, dist, dtype):
    for lib in (mx, pt):
        out = _draw(lib, name, **attrs)
        assert out.shape == (N_DRAWS,) and out.dtype == dtype
        a = out.asnumpy()
        assert np.all(a == np.round(a))
        assert _chi2_p(a, dist.pmf, range(-3, 60)) > CHI2_P, lib.__name__


SAMPLE = [
    ("_sample_uniform", ([0.0, -2.0], [1.0, 2.0]),
     lambda i, a, b: st.uniform(a[i], b[i] - a[i])),
    ("_sample_normal", ([0.0, 5.0], [1.0, 0.25]),
     lambda i, m, s: st.norm(m[i], s[i])),
    ("_sample_exponential", ([1.0, 4.0],),
     lambda i, lam: st.expon(scale=1 / lam[i])),
    ("_sample_gamma", ([2.0, 8.0], [1.0, 0.5]),
     lambda i, a, b: st.gamma(a[i], scale=b[i])),
]
SAMPLE_DISCRETE = [
    ("_sample_poisson", ([3.0, 0.5],), lambda i, lam: st.poisson(lam[i])),
    ("_sample_negative_binomial", ([4.0, 2.0], [0.4, 0.7]),
     lambda i, k, p: st.nbinom(k[i], p[i])),
    ("_sample_generalized_negative_binomial", ([2.0, 1.0], [0.5, 0.25]),
     lambda i, mu, al: st.nbinom(1 / al[i], 1 / (1 + al[i] * mu[i]))),
]


def _sample(lib, name, params, n):
    lib.random.seed(5)
    arrays = [lib.nd.array(np.array(p, np.float32), ctx=_ctx(lib))
              for p in params]
    return getattr(lib.nd, name)(*arrays, shape=(n,))


@pytest.mark.parametrize("name,params,dist", SAMPLE)
def test_sample_family_continuous(name, params, dist):
    """One row of ``N_DRAWS`` draws for each parameter element."""
    for lib in (mx, pt):
        out = _sample(lib, name, params, N_DRAWS)
        assert out.shape == (2, N_DRAWS) and out.dtype == np.float32
        a = out.asnumpy()
        for i in range(2):
            assert _ks(a[i], dist(i, *params)) < KS_BOUND, (lib.__name__, i)


@pytest.mark.parametrize("name,params,dist", SAMPLE_DISCRETE)
def test_sample_family_discrete(name, params, dist):
    for lib in (mx, pt):
        out = _sample(lib, name, params, N_DRAWS)
        assert out.shape == (2, N_DRAWS) and out.dtype == np.float32
        a = out.asnumpy()
        for i in range(2):
            p = _chi2_p(a[i], dist(i, *params).pmf, range(0, 60))
            assert p > CHI2_P, (lib.__name__, i)


def test_sample_shape_is_params_then_shape():
    """(2, 3) parameters and shape (4, 5) give (2, 3, 4, 5), in both."""
    for lib in (mx, pt):
        mu = lib.nd.array(np.zeros((2, 3), np.float32), ctx=_ctx(lib))
        s = lib.nd._sample_normal(mu, mu + 1, shape=(4, 5))
        assert s.shape == (2, 3, 4, 5)


def test_sample_normal_gradient_is_the_reparameterisation():
    """d(sum mu + z sigma)/dmu = n, /dsigma = sum z (the port's draws)."""
    pt.random.seed(1)
    mu = pt.nd.array([0.5, -1.0], ctx=pt.cpu())
    sig = pt.nd.array([2.0, 0.5], ctx=pt.cpu())
    mu.attach_grad()
    sig.attach_grad()
    with pt.autograd.record():
        s = pt.nd._sample_normal(mu, sig, shape=(50,))
        loss = s.sum()
    loss.backward()
    z = (s.asnumpy() - mu.asnumpy()[:, None]) / sig.asnumpy()[:, None]
    np.testing.assert_allclose(mu.grad.asnumpy(), [50.0, 50.0])
    np.testing.assert_allclose(sig.grad.asnumpy(), z.sum(1), rtol=1e-5)


@pytest.mark.parametrize("probs", [[0.1, 0.2, 0.7],
                                   [[0.5, 0.5, 0.0], [0.05, 0.15, 0.8]]])
def test_multinomial(probs):
    """int32 draws with the pmf's chi-square, ``get_prob`` the log of
    the drawn probability, its gradient the reference's."""
    probs = np.array(probs, np.float32)
    outs = {}
    for lib in (mx, pt):
        lib.random.seed(2)
        data = lib.nd.array(probs, ctx=_ctx(lib))
        data.attach_grad()
        with lib.autograd.record():
            s, lp = lib.random.multinomial(data, shape=(N_DRAWS // 4,),
                                           get_prob=True)
            loss = lp.sum()
        loss.backward()
        assert s.dtype == np.int32
        assert s.shape == probs.shape[:-1] + (N_DRAWS // 4,)
        sn = s.asnumpy().reshape(-1, N_DRAWS // 4)
        rows = probs.reshape(-1, probs.shape[-1])
        for r, row in zip(sn, rows):
            assert _chi2_p(r, lambda k: row[k], range(len(row))) > CHI2_P
        want = np.log(np.take_along_axis(rows, sn.astype(np.int64), 1))
        np.testing.assert_allclose(lp.asnumpy().reshape(want.shape), want,
                                   rtol=RTOL, atol=ATOL)
        counts = np.stack([np.bincount(r, minlength=rows.shape[1])
                           for r in sn]).astype(np.float32)
        # d sum log(p_k / sum p) / dp = counts / p - n / sum p
        # (0 where p_k is 0: the clamp at 1e-30 takes the gradient)
        dwant = np.where(rows > 0, counts / np.maximum(rows, 1e-30)
                         - sn.shape[1] / rows.sum(1, keepdims=True), 0)
        np.testing.assert_allclose(data.grad.asnumpy().reshape(dwant.shape),
                                   dwant, rtol=1e-4)
        outs[lib.__name__] = s.shape
    assert outs["mxnet_tpu"] == outs["mxnet_tpu_torch"]


def test_multinomial_one_draw_is_a_scalar():
    for lib in (mx, pt):
        s = lib.random.multinomial(lib.nd.array([0.3, 0.7], ctx=_ctx(lib)))
        assert s.shape == ()


def test_shuffle_permutes_rows():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    for lib in (mx, pt):
        lib.random.seed(4)
        s = lib.random.shuffle(lib.nd.array(x, ctx=_ctx(lib))).asnumpy()
        assert s.shape == x.shape
        assert sorted(map(tuple, s)) == sorted(map(tuple, x))
        assert not np.array_equal(s, x)


def test_unique_zipfian():
    """Classes in [0, range_max) with P(class < k) = log(k + 1) /
    log(range_max + 1) (within 4 sigma at k = 100), counts of ones."""
    p = math.log(101) / math.log(1001)
    sigma = math.sqrt(p * (1 - p) / N_DRAWS)
    for lib in (mx, pt):
        lib.random.seed(9)
        s, cnt = lib.nd._sample_unique_zipfian(range_max=1000,
                                               shape=(N_DRAWS,),
                                               ctx=_ctx(lib))
        sn = s.asnumpy()
        assert s.dtype == np.int32 and cnt.dtype == np.int32
        assert sn.min() >= 0 and sn.max() < 1000
        assert np.all(cnt.asnumpy() == 1)
        assert abs((sn < 100).mean() - p) < 4 * sigma, lib.__name__


# ---------------------------------------------------------------------------
# densities
# ---------------------------------------------------------------------------
_S = np.array([[0.3, 1.2, 2.5], [0.7, 1.9, 4.0]], np.float32)
_K = np.array([[0.0, 2.0, 5.0], [1.0, 3.0, 7.0]], np.float32)
PDFS = [
    ("_random_pdf_uniform", _S, ([0.0, 0.5], [3.0, 5.0])),
    ("_random_pdf_normal", _S, ([0.5, 1.0], [1.5, 0.7])),
    ("_random_pdf_exponential", _S, ([2.0, 0.5],)),
    ("_random_pdf_gamma", _S, ([2.0, 3.5], [1.5, 0.8])),
    ("_random_pdf_poisson", _K, ([2.0, 4.5],)),
    ("_random_pdf_negative_binomial", _K, ([4.0, 2.5], [0.4, 0.6])),
    ("_random_pdf_generalized_negative_binomial", _K,
     ([2.0, 3.0], [0.5, 0.3])),
    ("_random_pdf_dirichlet",
     np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]], np.float32),
     ([[1.0, 2.0, 3.0], [0.5, 1.5, 2.0]],)),
]


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("name,sample,params", PDFS)
def test_pdf_ops_value_and_gradient(name, sample, params, is_log):
    """The density and its gradient in the sample and in each
    parameter (the pmfs' count samples only in the parameters)."""
    discrete = sample is _K
    res = []
    for lib in (mx, pt):
        arrays = [lib.nd.array(sample, ctx=_ctx(lib))] + \
            [lib.nd.array(np.array(p, np.float32), ctx=_ctx(lib))
             for p in params]
        wrt = arrays[1:] if discrete else arrays
        for a in wrt:
            a.attach_grad()
        out_shape = sample.shape[:-1] if name.endswith("dirichlet") \
            else sample.shape
        weights = lib.nd.array(np.linspace(0.5, 1.5, np.prod(out_shape))
                               .astype(np.float32).reshape(out_shape),
                               ctx=_ctx(lib))
        with lib.autograd.record():
            out = getattr(lib.nd, name)(*arrays, is_log=is_log)
            loss = (out * weights).sum()
        loss.backward()
        res.append([out.asnumpy()] + [a.grad.asnumpy() for a in wrt])
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=RTOL, atol=ATOL)
    for p, r in zip(res[1][1:], res[0][1:]):
        np.testing.assert_allclose(p, r, rtol=PDF_GRAD_RTOL, atol=ATOL)


def test_pdf_uniform_outside_support():
    x = np.array([[-0.5, 0.5, 2.5]], np.float32)
    outs = [lib.nd._random_pdf_uniform(
        lib.nd.array(x, ctx=_ctx(lib)), lib.nd.array([0.0], ctx=_ctx(lib)),
        lib.nd.array([2.0], ctx=_ctx(lib))).asnumpy() for lib in (mx, pt)]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], [[0.0, 0.5, 0.0]])


# ---------------------------------------------------------------------------
# mx.random
# ---------------------------------------------------------------------------
DRAWS = [
    lambda: pt.random.uniform(-1, 1, shape=(3, 4), ctx=pt.cpu()),
    lambda: pt.random.normal(0, 2, shape=(5,), ctx=pt.cpu()),
    lambda: pt.random.randint(0, 100, shape=(6,), ctx=pt.cpu()),
    lambda: pt.random.randn(2, 3, ctx=pt.cpu()),
    lambda: pt.random.exponential(2.0, shape=(4,), ctx=pt.cpu()),
    lambda: pt.random.poisson(3.0, shape=(4,), ctx=pt.cpu()),
    lambda: pt.random.gamma(2.0, 0.5, shape=(4,), ctx=pt.cpu()),
    lambda: pt.random.shuffle(pt.nd.arange(16, ctx=pt.cpu())),
    lambda: pt.random.multinomial(pt.nd.array([0.2, 0.8], ctx=pt.cpu()),
                                  shape=64),
]


@pytest.mark.parametrize("i", range(len(DRAWS)))
def test_seed_repeats_every_sampler(i):
    pt.random.seed(11)
    a = DRAWS[i]().asnumpy()
    b = DRAWS[i]().asnumpy()
    pt.random.seed(11)
    c = DRAWS[i]().asnumpy()
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, b)


def test_seed_one_context_and_generator_identity():
    """``seed(s, ctx)`` resets that context's stream only; a generator
    is reseeded in place (a captured graph holds it)."""
    g = pt.random.generator(pt.cpu(0))
    pt.random.seed(3)
    a = pt.random.normal(shape=(4,), ctx=pt.cpu(0)).asnumpy()
    pt.random.seed(5, pt.gpu(0))
    b = pt.random.normal(shape=(4,), ctx=pt.cpu(0)).asnumpy()
    assert not np.array_equal(a, b)
    pt.random.seed(3, pt.cpu(0))
    assert pt.random.generator(pt.cpu(0)) is g
    np.testing.assert_array_equal(
        pt.random.normal(shape=(4,), ctx=pt.cpu(0)).asnumpy(), a)


def test_positional_scalars_gap():
    """MXNet 1.x takes the distribution's scalars by position; the
    reference refuses them (a gap kept, ROADMAP.md queue 3), the port
    takes both forms. Keyword forms agree in shape and dtype."""
    with pytest.raises(TypeError, match="positional arguments must be"):
        mx.random.uniform(0, 1, shape=(2, 3))
    p = pt.random.uniform(0, 1, shape=(2, 3), ctx=pt.cpu())
    r = mx.random.uniform(low=0, high=1, shape=(2, 3))
    q = pt.random.uniform(low=0, high=1, shape=(2, 3), ctx=pt.cpu())
    assert p.shape == q.shape == r.shape and p.dtype == r.dtype
    assert pt.random.randint(2, 5, shape=(3,), ctx=pt.cpu()).dtype == \
        mx.random.randint(low=2, high=5, shape=(3,)).dtype == np.int32
    out = pt.nd.zeros((4,), ctx=pt.cpu())
    assert pt.random.uniform(5, 6, shape=(4,), ctx=pt.cpu(), out=out) is out
    assert out.asnumpy().min() >= 5


def test_randn_and_exponential_forms():
    """``randn(*shape)``; ``exponential(scale)`` (MXNet 1.x) and
    ``exponential(lam=)`` (the reference's keyword) agree."""
    assert pt.random.randn(2, 3, ctx=pt.cpu()).shape == \
        mx.random.randn(2, 3).shape == (2, 3)
    pt.random.seed(7)
    a = pt.random.exponential(4.0, shape=(N_DRAWS,), ctx=pt.cpu())
    pt.random.seed(7)
    b = pt.random.exponential(lam=0.25, shape=(N_DRAWS,), ctx=pt.cpu())
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert _ks(a.asnumpy(), st.expon(scale=4.0)) < KS_BOUND


# ---------------------------------------------------------------------------
# random ops in a hybridized block
# ---------------------------------------------------------------------------
class _Noisy(pt.gluon.HybridBlock):
    """x + N(0, 1) noise + U(0, 1) draws, as the reparameterisation
    trick or input noise draws them."""

    def hybrid_forward(self, F, x):
        z = F.random_normal(shape=x.shape, ctx=x.context)
        u = F.random_uniform(shape=x.shape, ctx=x.context)
        return x + z + u


def test_hybridized_random_block_draws_anew_and_repeats_after_seed():
    x = pt.nd.array(np.zeros((3, 4), np.float32), ctx=pt.cpu())
    eager, hyb = _Noisy(), _Noisy()
    hyb.hybridize()
    runs = []
    for net in (eager, hyb):
        pt.random.seed(21)
        runs.append([net(x).asnumpy() for _ in range(3)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[1][0], runs[1][1])
    assert not np.array_equal(runs[1][1], runs[1][2])


# ---------------------------------------------------------------------------
# every draw takes an explicit generator
# ---------------------------------------------------------------------------
_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
             "poisson", "_standard_gamma", "bernoulli", "normal",
             "_sample_dirichlet", "binomial", "rand_like", "randn_like",
             "randint_like", "normal_", "uniform_", "exponential_",
             "random_", "bernoulli_", "geometric_", "cauchy_",
             "log_normal_", "dropout", "dropout1d", "dropout2d",
             "dropout3d", "alpha_dropout", "feature_alpha_dropout",
             "rrelu"}


def test_no_draw_from_the_global_generator():
    """Every torch sampler called in the port passes ``generator=``
    (the dropout kernels' seeds come from the on-card counter, which
    calls none), and nothing imports ``torch.distributions``, which
    samples without one."""
    root = pathlib.Path(pt.__file__).parent
    bad = []
    for path in sorted(root.rglob("*.py")):
        if "_build" in path.parts:
            continue
        source = path.read_text()
        # F is torch.nn.functional there (else the op namespace F)
        torch_f = "import torch.nn.functional as F" in source
        tree = ast.parse(source)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                if not isinstance(f, ast.Attribute) or \
                        f.attr not in _SAMPLERS:
                    continue
                base = f.value
                while isinstance(base, ast.Attribute):
                    base = base.value
                root_name = getattr(base, "id", None)
                torch_call = root_name == "torch" or f.attr.endswith("_") \
                    or (root_name == "F" and torch_f)
                if torch_call and not any(k.arg == "generator"
                                          for k in node.keywords):
                    bad.append("%s:%d %s" % (path.relative_to(root),
                                             node.lineno, f.attr))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = getattr(node, "module", None) or ""
                names = [a.name for a in node.names]
                if "distributions" in mod or any(
                        "distributions" in n for n in names):
                    bad.append("%s:%d import" % (path.relative_to(root),
                                                 node.lineno))
    assert not bad, bad
