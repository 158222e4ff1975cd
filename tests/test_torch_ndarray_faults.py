"""The six NDArray and op faults of the port, each held to the reference
on the CPU with the same numpy inputs: in-place operators, elementwise
comparisons, ``NDArray.dtype`` as a numpy dtype, the ``Activation``
modes sigmoid/softrelu/softsign, ``softmax`` with ``length``, and
``Embedding`` with out-of-range ids. Values and gradients within 1e-6
relative (f32; the two libraries' sigmoid and softplus round apart in
the last bit), exact where the result is exact (comparisons, gathers,
in-place sums of small integers)."""
import ml_dtypes
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

LIBS = ((mx, mx.cpu()), (pt, pt.cpu()))
RTOL, ATOL = 1e-6, 1e-7


def _x(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# -- 1. in-place operators ---------------------------------------------------
INPLACE = {"+=": lambda a, o: a.__iadd__(o), "-=": lambda a, o: a.__isub__(o),
           "*=": lambda a, o: a.__imul__(o),
           "/=": lambda a, o: a.__itruediv__(o)}


@pytest.mark.parametrize("op", sorted(INPLACE))
@pytest.mark.parametrize("operand", ["scalar", "array"])
def test_inplace_operator_writes_into_the_array(op, operand):
    """After ``b = a; a op= o``, ``b`` and every view of ``a`` read what
    the reference reads, and the operator returns ``a`` itself."""
    x, y = _x(), _x(seed=1) + 3.0
    outs = []
    for lib, ctx in LIBS:
        a = lib.nd.array(x, ctx=ctx)
        b = a
        row = a[1]
        o = 2.5 if operand == "scalar" else lib.nd.array(y, ctx=ctx)
        res = INPLACE[op](a, o)
        assert res is a
        outs.append((b.asnumpy(), row.asnumpy()))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])


def test_inplace_update_reaches_a_parameter_alias():
    """``w = p.data(); w += 1`` changes the parameter itself, as the
    reference's write does; a recorded in-place op stays on the tape, and
    an in-place write to a variable while recording is refused."""
    x = _x((2, 3))
    got = []
    for lib, ctx in LIBS:
        net = lib.gluon.nn.Dense(2, in_units=3, prefix="d_")
        net.initialize(ctx=ctx)
        net.weight.set_data(lib.nd.array(x, ctx=ctx))
        w = net.weight.data()
        w += 1.0
        w *= 2.0
        vals = [net.weight.data().asnumpy()]
        v = lib.nd.array(x, ctx=ctx)
        v.attach_grad()
        with lib.autograd.record():
            y = v * 3.0
            y += v
            y -= 1.0
            loss = (y * y).sum()
        loss.backward()
        vals.append(v.grad.asnumpy())
        with lib.autograd.record():
            with pytest.raises(lib.base.MXNetError, match="attach_grad"):
                v += 1.0
        got.append(vals)
    for g, r in zip(got[1], got[0]):
        _close(g, r)


# -- 2. comparisons ----------------------------------------------------------
CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
       ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
       "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}


@pytest.mark.parametrize("op", sorted(CMP))
@pytest.mark.parametrize("operand", ["scalar", "array", "broadcast"])
def test_comparison_is_elementwise(op, operand):
    """0/1 arrays in the input's dtype, as the reference's ``_cmp``."""
    x = np.round(_x() * 2) / 2
    y = {"scalar": 0.5, "array": np.round(_x(seed=1) * 2) / 2,
         "broadcast": np.round(_x((1, 4), seed=2) * 2) / 2}[operand]
    outs = []
    for lib, ctx in LIBS:
        a = lib.nd.array(x, ctx=ctx)
        b = y if operand == "scalar" else lib.nd.array(y, ctx=ctx)
        r = CMP[op](a, b)
        outs.append((r.asnumpy(), r.dtype))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1] == np.float32


def test_comparison_keeps_the_identity_hash():
    """An NDArray is still a dict key and a set member by identity, and
    ``== None`` is False, as in the reference."""
    for lib, ctx in LIBS:
        a, b = lib.nd.array(_x(), ctx=ctx), lib.nd.array(_x(), ctx=ctx)
        d = {a: "a", b: "b"}
        assert d[a] == "a" and d[b] == "b"
        assert hash(a) == object.__hash__(a)
        assert (a == None) is False  # noqa: E711
        assert len({a, b, a}) == 2


# -- 3. dtype ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int32"])
def test_dtype_is_a_numpy_dtype(dtype):
    want = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    for lib, ctx in LIBS:
        a = lib.nd.array(_x(), ctx=ctx).astype(dtype)
        assert isinstance(a.dtype, np.dtype)
        assert a.dtype == want
        assert a.astype_like(a).dtype == want
    if dtype == "int32":
        return
    p = pt.gluon.nn.Dense(2, in_units=3, dtype=dtype, prefix="q_")
    p.initialize(ctx=pt.cpu())
    r = mx.gluon.nn.Dense(2, in_units=3, dtype=dtype, prefix="q_")
    r.initialize(ctx=mx.cpu())
    assert p.weight.data().dtype == r.weight.data().dtype == want


# -- 4. Activation ------------------------------------------------------------
@pytest.mark.parametrize("act", ["sigmoid", "softrelu", "softsign"])
def test_activation_mode_matches_reference(act):
    """The op, its gradient, and ``Dense(activation=...)``."""
    x = _x((4, 5)) * 3
    outs = []
    for lib, ctx in LIBS:
        a = lib.nd.array(x, ctx=ctx)
        a.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Activation(a, act_type=act)
            loss = (y * y).sum()
        loss.backward()
        net = lib.gluon.nn.Dense(3, in_units=5, activation=act, prefix="a_")
        net.initialize(ctx=ctx)
        net.weight.set_data(lib.nd.array(x[:3], ctx=ctx))
        outs.append((y.asnumpy(), a.grad.asnumpy(),
                     net(lib.nd.array(x, ctx=ctx)).asnumpy()))
    for g, r in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-6)


# -- 5. softmax with length ------------------------------------------------------
@pytest.mark.parametrize("temperature", [None, 2.0])
def test_softmax_masks_past_each_length(temperature):
    """Steps at or past each row's length come back 0, the rest sum to
    1; the gradient flows only into the kept steps."""
    x = _x((3, 6))
    length = np.array([2, 6, 1], np.float32)
    g = _x((3, 6), seed=3)
    outs = []
    for lib, ctx in LIBS:
        a = lib.nd.array(x, ctx=ctx)
        a.attach_grad()
        with lib.autograd.record():
            y = lib.nd.softmax(a, lib.nd.array(length, ctx=ctx), axis=-1,
                               use_length=True, temperature=temperature)
            loss = (y * lib.nd.array(g, ctx=ctx)).sum()
        loss.backward()
        outs.append((y.asnumpy(), a.grad.asnumpy()))
    for got, ref in zip(outs[1], outs[0]):
        _close(got, ref)
    assert np.all(outs[1][0][0, 2:] == 0)


# -- 6. Embedding with out-of-range ids ------------------------------------------
def test_embedding_out_of_range_ids_match_jnp_take():
    """An id past the table gives a NaN row, a negative one in range
    wraps, one below it gives NaN, and no gradient reaches a row for an
    out-of-range id."""
    w = _x((4, 3))
    ids = np.array([[0, 4, -1], [7, 2, -5]], np.float32)
    g = _x((2, 3, 3), seed=4)
    outs = []
    for lib, ctx in LIBS:
        W = lib.nd.array(w, ctx=ctx)
        W.attach_grad()
        with lib.autograd.record():
            out = lib.nd.Embedding(lib.nd.array(ids, ctx=ctx), W,
                                   input_dim=4, output_dim=3)
            loss = (out * lib.nd.array(g, ctx=ctx)).sum()
        loss.backward()
        outs.append((out.asnumpy(), W.grad.asnumpy()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])
    assert np.isnan(outs[1][0][0, 1]).all() and \
        np.isnan(outs[1][0][1, 2]).all()
