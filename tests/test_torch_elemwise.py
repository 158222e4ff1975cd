"""The port's elementwise families against the reference, on the CPU:
every unary op of the reference's table with relu and sigmoid, the
binary and scalar maximum/minimum, ``nd.ones``, basic indexing and
``wait_to_read``. Same numpy inputs, f32, within 1e-5 relative (1e-4 for
the special functions, which the two libraries approximate apart)."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

# op -> input map from u in [0.1, 0.9) onto the op's domain
UNARY = {
    "abs": lambda u: u - 0.5, "sign": lambda u: u - 0.5,
    "rint": lambda u: 8 * u - 4, "ceil": lambda u: 8 * u - 4,
    "floor": lambda u: 8 * u - 4, "trunc": lambda u: 8 * u - 4,
    "fix": lambda u: 8 * u - 4, "round": lambda u: 8 * u - 4,
    "square": lambda u: u - 0.5, "sqrt": lambda u: u, "cbrt": lambda u: u - 0.5,
    "exp": lambda u: u, "log": lambda u: u, "log10": lambda u: u,
    "log2": lambda u: u, "log1p": lambda u: u, "expm1": lambda u: u,
    "sin": lambda u: 4 * u, "cos": lambda u: 4 * u, "tan": lambda u: u,
    "arcsin": lambda u: u - 0.5, "arccos": lambda u: u - 0.5,
    "arctan": lambda u: 4 * u, "sinh": lambda u: u, "cosh": lambda u: u,
    "tanh": lambda u: u - 0.5, "arcsinh": lambda u: u, "arccosh": lambda u: u + 1,
    "arctanh": lambda u: u - 0.5, "degrees": lambda u: u,
    "radians": lambda u: 100 * u, "negative": lambda u: u - 0.5,
    "reciprocal": lambda u: u, "erf": lambda u: u - 0.5,
    "erfinv": lambda u: u - 0.5, "gamma": lambda u: 4 * u,
    "gammaln": lambda u: 4 * u, "logical_not": lambda u: np.round(u),
    "rsqrt": lambda u: u, "relu": lambda u: u - 0.5,
    "sigmoid": lambda u: 8 * u - 4,
}
SPECIAL = {"erf", "erfinv", "gamma", "gammaln", "cbrt"}


def _u(shape=(4, 7), seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 0.8 + 0.1).astype(
        np.float32)


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op_matches_reference(op):
    x = UNARY[op](_u()).astype(np.float32)
    ref = getattr(mx.nd, op)(mx.nd.array(x)).asnumpy()
    got = getattr(pt.nd, op)(pt.nd.array(x, ctx=pt.cpu())).asnumpy()
    assert got.dtype == ref.dtype == np.float32
    rtol = 1e-4 if op in SPECIAL else 1e-5
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("op", ["broadcast_maximum", "broadcast_minimum"])
def test_binary_maximum_minimum_match_reference(op):
    a, b = _u((3, 4), 1) - 0.5, _u((1, 4), 2) - 0.5
    ref = getattr(mx.nd, op)(mx.nd.array(a), mx.nd.array(b)).asnumpy()
    got = getattr(pt.nd, op)(pt.nd.array(a, ctx=pt.cpu()),
                             pt.nd.array(b, ctx=pt.cpu())).asnumpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op", ["_maximum_scalar", "_minimum_scalar"])
def test_scalar_maximum_minimum_match_reference(op):
    a = _u((3, 4), 3) - 0.5
    ref = getattr(mx.nd, op)(mx.nd.array(a), scalar=0.1).asnumpy()
    got = getattr(pt.nd, op)(pt.nd.array(a, ctx=pt.cpu()),
                             scalar=0.1).asnumpy()
    np.testing.assert_array_equal(got, ref)


def test_ones_indexing_len_and_wait_to_read():
    for lib, ctx in ((mx, mx.cpu()), (pt, pt.cpu())):
        o = lib.nd.ones((2, 3), ctx=ctx, dtype="float32")
        np.testing.assert_array_equal(o.asnumpy(), np.ones((2, 3)))
        o.wait_to_read()
        assert len(o) == 2
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = pt.nd.array(x, ctx=pt.cpu())
    np.testing.assert_array_equal(a[1].asnumpy(), x[1])
    np.testing.assert_array_equal(a[1:, 2].asnumpy(), x[1:, 2])
    # advanced indexing gathers, as the reference's does
    np.testing.assert_array_equal(
        a[np.array([0, 2])].asnumpy(),
        mx.nd.array(x, ctx=mx.cpu())[np.array([0, 2])].asnumpy())
    with pytest.raises(TypeError):
        len(pt.nd.zeros((), ctx=pt.cpu()))
    a.attach_grad()
    with pt.autograd.record():
        y = (a[1] * 2.0).sum()
    y.backward()
    np.testing.assert_array_equal(a.grad.asnumpy(),
                                  np.outer([0, 2, 0], np.ones(4)))
