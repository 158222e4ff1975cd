"""The port's ``mx.operator`` custom ops, ``autograd.Function`` and
``autograd.grad`` against the reference, on the CPU.

The cases are the reference's own (``tests/test_custom_op.py`` and
``tests/test_autograd.py``'s ``grad``, ``Function`` and ``create_graph``
tests), each run through both packages on the same numpy inputs; the
same op classes are registered in both (under names of their own, as
every worker imports every test file). f32 throughout, within 1e-5 (abs
+ rel) or the reference test's own tolerance.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

import chip_smoke

TOL = dict(rtol=1e-5, atol=1e-5)
LIBS = [(mx, mx.cpu()), (pt, pt.cpu())]


def _ops(lib):
    """The reference tests' custom ops, built on ``lib``'s classes."""
    nd = lib.nd

    class Sigmoid(lib.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], 1.0 / (1.0 + nd.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1.0 - y))

    class SigmoidProp(lib.operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class Split2(lib.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x * 2.0)
            self.assign(out_data[1], req[1], x * 3.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * 2.0 + out_grad[1] * 3.0)

    class Split2Prop(lib.operator.CustomOpProp):
        def list_outputs(self):
            return ["a", "b"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Split2()

    class ScaleAux(lib.operator.CustomOp):
        """out = x * scale + aux (aux split off the trailing input); the
        forward counts its calls in the aux state."""

        def __init__(self, scale):
            self._scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * self._scale + aux[0])
            self.assign(aux[0], "add", 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self._scale)

    class ScaleAuxProp(lib.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self._scale = float(scale)

        def list_auxiliary_states(self):
            return ["count"]

        def create_operator(self, ctx, shapes, dtypes):
            return ScaleAux(self._scale)

    for name, prop in (("tt_sigmoid", SigmoidProp), ("tt_split2", Split2Prop),
                       ("tt_scale_aux", ScaleAuxProp)):
        lib.operator.register(name)(prop)

    class Square(lib.autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    return Square


SQUARE = {lib: _ops(lib) for lib, _ in LIBS}


def _both(fn):
    """fn(lib, ctx) run with each package; returns (reference, port)."""
    return [fn(lib, ctx) for lib, ctx in LIBS]


def _arr(lib, ctx, a):
    return lib.nd.array(np.asarray(a, np.float32), ctx=ctx)


# ---------------------------------------------------------------------------
# tests/test_custom_op.py
# ---------------------------------------------------------------------------
def test_custom_forward():
    x = np.array([-1.0, 0.0, 2.0], np.float32)

    def run(lib, ctx):
        return lib.nd.Custom(_arr(lib, ctx, x), op_type="tt_sigmoid").asnumpy()

    ref, got = _both(run)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_custom_backward():
    x0 = np.array([0.5, -0.3], np.float32)

    def run(lib, ctx):
        x = _arr(lib, ctx, x0)
        x.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Custom(x, op_type="tt_sigmoid")
            loss = y.sum()
        loss.backward()
        return x.grad.asnumpy()

    ref, got = _both(run)
    s = 1 / (1 + np.exp(-x0))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, s * (1 - s), rtol=1e-5)


def test_custom_unknown_raises():
    for lib, ctx in LIBS:
        with pytest.raises(lib.MXNetError, match="unknown custom op"):
            lib.nd.Custom(lib.nd.ones((2,), ctx=ctx),
                          op_type="nope_not_registered")


def test_custom_multi_output():
    def run(lib, ctx):
        x = _arr(lib, ctx, [1.0, 2.0])
        x.attach_grad()
        with lib.autograd.record():
            a, b = lib.nd.Custom(x, op_type="tt_split2")
            loss = (a + b).sum()
        loss.backward()
        return a.asnumpy(), b.asnumpy(), x.grad.asnumpy()

    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_allclose(got[2], [5.0, 5.0])


def test_custom_aux_states_and_kwargs_to_the_prop():
    """Aux states are split off the trailing inputs and passed to the
    callbacks; every kwarg goes to the prop's constructor."""
    def run(lib, ctx):
        x = _arr(lib, ctx, [1.0, -2.0, 3.0])
        aux = _arr(lib, ctx, [0.5, 0.5, 0.5])
        x.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Custom(x, aux, op_type="tt_scale_aux", scale="3.0")
            loss = (y * y).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()

    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_allclose(got[0], [3.5, -5.5, 9.5])


@pytest.mark.parametrize("req,want", [
    ("write", [3.0]), ("inplace", [3.0]), ("add", [4.0]), ("null", [1.0])])
def test_assign_reqs(req, want):
    for lib, ctx in LIBS:
        dst = _arr(lib, ctx, [1.0])
        lib.operator.CustomOp.assign(dst, req, _arr(lib, ctx, [3.0]))
        np.testing.assert_array_equal(dst.asnumpy(), want)
    with pytest.raises(pt.MXNetError, match="unknown req"):
        pt.operator.CustomOp.assign(_arr(pt, pt.cpu(), [1.0]), "bogus", 1.0)


def test_custom_op_records_only_with_an_input_in_the_graph():
    with pt.cpu():
        x = _arr(pt, pt.cpu(), [0.5, -1.0])
        y = pt.nd.Custom(x, op_type="tt_sigmoid")
        assert not y.tensor().requires_grad
        with pt.autograd.record():
            y = pt.nd.Custom(x, op_type="tt_sigmoid")   # x not a variable
        assert not y.tensor().requires_grad
        x.attach_grad()
        with pt.autograd.record():
            y = pt.nd.Custom(x, op_type="tt_sigmoid")
        assert y.tensor().requires_grad
        assert pt.operator.get_prop("tt_sigmoid") is not None


def test_f_custom_inside_a_hybrid_block():
    class Act(pt.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Custom(x, op_type="tt_sigmoid")

    x = _arr(pt, pt.cpu(), [[0.25, -4.0]])
    np.testing.assert_allclose(Act()(x).asnumpy(),
                               1 / (1 + np.exp(-x.asnumpy())), rtol=1e-6)
    with pytest.raises(pt.MXNetError, match="already registered"):
        pt.ops.register_ndarray_fn("Custom", lambda *a: None)


# ---------------------------------------------------------------------------
# tests/test_autograd.py: grad, Function, create_graph
# ---------------------------------------------------------------------------
def test_autograd_grad_function():
    def run(lib, ctx):
        x = _arr(lib, ctx, [3.0])
        x.attach_grad()
        with lib.autograd.record():
            y = x * x
        (gx,) = lib.autograd.grad(y, x)
        return gx.asnumpy(), x.grad.asnumpy()

    ref, got = _both(run)
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[0], [6.0])
    # .grad is left as it was
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[1], [0.0])


def test_grad_head_grads_and_unreached_variables():
    rng = np.random.RandomState(3)
    a, b, hg = (rng.randn(2, 3).astype(np.float32) for _ in range(3))

    def run(lib, ctx):
        x, y = _arr(lib, ctx, a), _arr(lib, ctx, b)
        x.attach_grad()
        y.attach_grad()
        with lib.autograd.record():
            z = x * x * 3.0
        gx, gy = lib.autograd.grad([z], [x, y], [_arr(lib, ctx, hg)])
        return gx.asnumpy(), gy.asnumpy()

    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_allclose(got[0], 6 * a * hg, **TOL)
    np.testing.assert_array_equal(got[1], np.zeros_like(b))


def test_custom_function():
    def run(lib, ctx):
        x = _arr(lib, ctx, [1.0, 2.0, 3.0])
        x.attach_grad()
        sq = SQUARE[lib]()
        with lib.autograd.record():
            y = sq(x)
            z = y.sum()
        z.backward()
        return y.asnumpy(), x.grad.asnumpy()

    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_allclose(got[1], [2.0, 4.0, 6.0])


def test_function_with_two_outputs_and_a_missing_gradient():
    class Split(pt.autograd.Function):
        def forward(self, x):
            return x * 2.0, x * 3.0

        def backward(self, da, db):
            return da * 2.0 + db * 3.0

    x = _arr(pt, pt.cpu(), [1.0, -1.0])
    x.attach_grad()
    with pt.autograd.record():
        a, b = Split()(x)
        loss = a.sum()              # b unused: its gradient is zeros
    loss.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 2.0])
    y = Split()(x)                  # outside record: no node
    assert not y[0].tensor().requires_grad


def test_create_graph_second_derivative():
    x0 = np.array([1.0, 2.0, -3.0], np.float32)

    def run(lib, ctx):
        x = _arr(lib, ctx, x0)
        x.attach_grad()
        with lib.autograd.record():
            y = x * x * x
            gx, = lib.autograd.grad(y, x, create_graph=True)
            gx.backward()
        return gx.asnumpy(), x.grad.asnumpy()

    ref, got = _both(run)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_allclose(got[0], 3 * x0 ** 2, rtol=1e-5)
    np.testing.assert_allclose(got[1], 6 * x0, rtol=1e-5)


def test_create_graph_matches_finite_differences():
    rng = np.random.RandomState(0)
    x0 = rng.rand(4).astype(np.float32) + 0.5

    def run(lib, ctx):
        x = _arr(lib, ctx, x0)
        x.attach_grad()
        with lib.autograd.record():
            y = (lib.nd.exp(x) * lib.nd.sin(x)).sum()
            gx, = lib.autograd.grad(y, x, create_graph=True)
            gg = (gx * gx).sum()
            gg.backward()
        return x.grad.asnumpy()

    ref, got = _both(run)
    np.testing.assert_allclose(got, ref, **TOL)
    # d/dx |f'(x)|^2 = 2 f'(x) f''(x), f = exp * sin
    x = x0.astype(np.float64)
    f1 = np.exp(x) * (np.sin(x) + np.cos(x))
    f2 = 2 * np.exp(x) * np.cos(x)
    np.testing.assert_allclose(got, 2 * f1 * f2, rtol=1e-4)


def test_create_graph_function_node_rejected():
    def run(lib, ctx):
        x = _arr(lib, ctx, [2.0])
        x.attach_grad()
        sq = SQUARE[lib]()
        with lib.autograd.record():
            y = sq(x)
            with pytest.raises(lib.MXNetError):
                lib.autograd.grad(y, x, create_graph=True)
        return True

    assert _both(run) == [True, True]


# ---------------------------------------------------------------------------
# a custom op whose body is an rtc kernel
# ---------------------------------------------------------------------------
def test_rtc_custom_op_matches_reference_pallas_custom_op():
    """The MLP's ``rtc_relu`` (its plain functions on the CPU) against a
    reference custom op over the same bodies as Pallas kernels."""
    import jax.numpy as jnp

    def relu_fwd(x_ref, y_ref):
        y_ref[...] = jnp.maximum(x_ref[...], 0)

    def relu_bwd(dy_ref, y_ref, dx_ref):
        dx_ref[...] = jnp.where(y_ref[...] > 0, dy_ref[...], 0)

    ref_mod = mx.rtc.PallasModule(relu_fwd, relu_bwd)

    class RefRelu(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], ref_mod.get_kernel(
                "relu_fwd").launch([in_data[0]]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], ref_mod.get_kernel(
                "relu_bwd").launch([out_grad[0], out_data[0]]))

    if mx.operator.get_prop("tt_ref_relu") is None:
        @mx.operator.register("tt_ref_relu")
        class RefReluProp(mx.operator.CustomOpProp):
            def create_operator(self, ctx, shapes, dtypes):
                return RefRelu()

    chip_smoke.register_rtc_relu(pt, pt.rtc.CudaModule(
        chip_smoke.RTC_SOURCE, plain=chip_smoke.rtc_plain()))
    rng = np.random.RandomState(2)
    x0 = rng.randn(16, 32).astype(np.float32)
    x0.reshape(-1)[::5] = 0.0
    w = rng.randn(16, 32).astype(np.float32)

    def run(lib, ctx, op_type):
        x = _arr(lib, ctx, x0)
        x.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Custom(x, op_type=op_type)
            loss = (y * _arr(lib, ctx, w)).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()

    ref = run(mx, mx.cpu(), "tt_ref_relu")
    got = run(pt, pt.cpu(), "rtc_relu")
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(got[1], np.where(x0 > 0, w, 0))
