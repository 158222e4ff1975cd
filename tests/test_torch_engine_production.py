"""``nd.Custom`` on the port's dependency engine (``mxnet_tpu_torch/
operator.py`` over ``engine.py``) against the reference's
``tests/test_engine_production.py`` custom-op cases, each run in both
packages with the same ops (registered under the same names in each)
and the same numpy inputs: the call returns before the callback ends,
an error raises at ``wait_to_read``, chains order by their read
dependencies, the tape node still differentiates, inputs are
snapshotted, an op may read its own output, ``waitall`` drains the
engine, and an in-place write to a gated input waits for its reader.
Then the port's own: the engine path equals the inline path (inside a
hybridized call) bit for bit, and aux states are gated with the outputs.

Values: f32 products of small integers, exact in both packages
(compared with ``assert_array_equal``). Timings are bounds with wide
margins: a 0.4 s callback must leave the call in under 0.2 s.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.operator as ref_op

import mxnet_tpu_torch as pt
import mxnet_tpu_torch.operator as port_op

LIBS = ((mx, ref_op, mx.cpu()), (pt, port_op, pt.cpu()))
SIDE = []     # what the "side_effect" ops saw, in order
# "held_square" waits for this event: the test sets it once it has seen
# the call return with the op still pending
HOLD = threading.Event()


def _register(op_mod):
    """The test ops, in ``op_mod``'s registry."""
    class SlowSquare(op_mod.CustomOp):
        def __init__(self, delay):
            self._delay = delay

        def forward(self, is_train, req, in_data, out_data, aux):
            time.sleep(self._delay)
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2 * in_data[0])

    class HeldSquare(SlowSquare):
        def forward(self, is_train, req, in_data, out_data, aux):
            assert HOLD.wait(30.0), "the test never released the op"
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

    @op_mod.register("eng_held_square")
    class HeldSquareProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return HeldSquare(0.0)

    @op_mod.register("eng_slow_square")
    class SlowSquareProp(op_mod.CustomOpProp):
        def __init__(self, delay="0.3"):
            super().__init__(need_top_grad=True)
            self._delay = float(delay)

        def create_operator(self, ctx, shapes, dtypes):
            return SlowSquare(self._delay)

    class Exploding(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            raise RuntimeError("boom in custom forward")

        def backward(self, *a, **kw):
            pass

    @op_mod.register("eng_exploding_op")
    class ExplodingProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Exploding()

    class ReadOut(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            base = out_data[0].asnumpy()          # its own gated output
            self.assign(out_data[0], req[0],
                        in_data[0] + float(base.sum()))

        def backward(self, *a, **kw):
            pass

    @op_mod.register("eng_readout_op")
    class ReadOutProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return ReadOut()

    class Side(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            time.sleep(0.2)
            SIDE.append(float(in_data[0].asnumpy().sum()))
            self.assign(out_data[0], req[0], in_data[0])

        def backward(self, *a, **kw):
            pass

    @op_mod.register("eng_side_effect")
    class SideProp(op_mod.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Side()

    class Counting(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            time.sleep(0.1)
            self.assign(out_data[0], req[0], in_data[0] + aux[0])
            self.assign(aux[0], "write", aux[0] + 1)

        def backward(self, *a, **kw):
            pass

    @op_mod.register("eng_counting_op")
    class CountingProp(op_mod.CustomOpProp):
        def list_auxiliary_states(self):
            return ["count"]

        def create_operator(self, ctx, shapes, dtypes):
            return Counting()


for _lib, _mod, _ctx in LIBS:
    _register(_mod)


def _a(lib, ctx, values):
    return lib.nd.array(np.asarray(values, np.float32), ctx=ctx)


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    yield


def test_custom_op_overlaps_main_thread():
    """nd.Custom returns before its 0.4 s callback ends; the value is
    there at wait_to_read (ref :53)."""
    for lib, _, ctx in LIBS:
        x = _a(lib, ctx, [1.0, 2.0, 3.0])
        lib.nd.Custom(x, op_type="eng_slow_square", delay="0.0") \
            .wait_to_read()
        t0 = time.perf_counter()
        y = lib.nd.Custom(x, op_type="eng_slow_square", delay="0.4")
        dispatch = time.perf_counter() - t0
        assert dispatch < 0.2, (lib.__name__, dispatch)
        t1 = time.perf_counter()
        got = y.asnumpy()
        waited = time.perf_counter() - t1
        np.testing.assert_array_equal(got, [1.0, 4.0, 9.0])
        assert dispatch + waited >= 0.3


def test_custom_op_error_at_wait():
    """The callback's exception raises at wait_to_read, not at the call,
    with its message, in both (ref :74)."""
    msgs = []
    for lib, _, ctx in LIBS:
        y = lib.nd.Custom(lib.nd.ones((3,), ctx=ctx),
                          op_type="eng_exploding_op")
        with pytest.raises(RuntimeError, match="boom in custom forward") \
                as ei:
            y.wait_to_read()
        msgs.append(str(ei.value))
    assert all("custom_op:eng_exploding_op" in m for m in msgs)


def test_custom_op_chain_dependencies():
    """A custom op over another's gated output reads it after it is
    written (ref :83)."""
    for lib, _, ctx in LIBS:
        y = lib.nd.Custom(_a(lib, ctx, [2.0]), op_type="eng_slow_square",
                          delay="0.2")
        z = lib.nd.Custom(y, op_type="eng_slow_square", delay="0.0")
        np.testing.assert_array_equal(z.asnumpy(), [16.0])


def test_custom_op_still_differentiates():
    """The tape node of a gated call (ref :92)."""
    grads = []
    for lib, _, ctx in LIBS:
        x = _a(lib, ctx, [1.0, 2.0])
        x.attach_grad()
        with lib.autograd.record():
            y = lib.nd.Custom(x, op_type="eng_slow_square", delay="0.1")
            loss = y.sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1], [2.0, 4.0])


def test_custom_op_input_snapshot():
    """A write to the input after the call does not reach the deferred
    callback (ref :170)."""
    for lib, _, ctx in LIBS:
        x = _a(lib, ctx, [2.0])
        y = lib.nd.Custom(x, op_type="eng_slow_square", delay="0.25")
        x[:] = 100.0
        np.testing.assert_array_equal(y.asnumpy(), [4.0])


def test_custom_op_may_read_own_output():
    """The callback reads its own gated output (zeros) without waiting
    on itself (ref :179)."""
    for lib, _, ctx in LIBS:
        y = lib.nd.Custom(_a(lib, ctx, [5.0]), op_type="eng_readout_op")
        np.testing.assert_array_equal(y.asnumpy(), [5.0])


def test_waitall_covers_native_engine():
    """nd.waitall waits for the engine's ops (ref :201, there over an
    asynchronous checkpoint write; here over a custom op's side
    effect)."""
    for lib, _, ctx in LIBS:
        del SIDE[:]
        lib.nd.Custom(_a(lib, ctx, [1.0, 2.0]), op_type="eng_side_effect")
        assert SIDE == []
        lib.nd.waitall()
        assert SIDE == [3.0]


def test_custom_op_gated_input_mutation_ordering():
    """An in-place write to a gated input right after the call waits for
    the op that reads it (write after read; ref :210)."""
    for lib, _, ctx in LIBS:
        y = lib.nd.Custom(_a(lib, ctx, [3.0]), op_type="eng_slow_square",
                          delay="0.4")
        z = lib.nd.Custom(y, op_type="eng_slow_square", delay="0.0")
        y += 100.0
        np.testing.assert_array_equal(z.asnumpy(), [81.0])
        np.testing.assert_array_equal(y.asnumpy(), [109.0])


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------
class _Hybrid(pt.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Custom(x, op_type="eng_held_square")


def test_engine_path_equals_inline_path():
    """The gated call (returned at once) and the inline one (inside a
    hybridized call) give the same values and gradients bit for bit.
    The op waits for ``HOLD``: the gated call is seen pending before the
    op may run, and the inline one runs with ``HOLD`` already set."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5).astype(np.float32)
    runs = []
    for hybrid in (False, True):
        blk = _Hybrid()
        if hybrid:
            blk.hybridize()
            HOLD.set()
        else:
            HOLD.clear()
        xa = pt.nd.array(x, ctx=pt.cpu())
        xa.attach_grad()
        with pt.autograd.record():
            y = blk(xa)
            gated = y._pending is not None
            HOLD.set()
            loss = (y * y).sum()
        loss.backward()
        assert gated != hybrid
        runs.append((y.asnumpy(), xa.grad.asnumpy()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_aux_states_are_gated_with_the_outputs():
    """The callback's aux write is seen only once the op ran; a second
    call orders after the first through the aux var."""
    count = pt.nd.array(np.zeros(1, np.float32), ctx=pt.cpu())
    x = pt.nd.array(np.ones(2, np.float32), ctx=pt.cpu())
    y1 = pt.nd.Custom(x, count, op_type="eng_counting_op")
    assert count._pending is not None
    y2 = pt.nd.Custom(x, count, op_type="eng_counting_op")
    np.testing.assert_array_equal(y1.asnumpy(), [1.0, 1.0])
    np.testing.assert_array_equal(y2.asnumpy(), [2.0, 2.0])
    np.testing.assert_array_equal(count.asnumpy(), [2.0])


def test_error_surfaces_at_waitall_once():
    """An error nobody read raises at the next waitall, once; the
    engine runs the next op."""
    pt.nd.Custom(pt.nd.ones((2,), ctx=pt.cpu()), op_type="eng_exploding_op")
    with pytest.raises(RuntimeError, match="boom in custom forward"):
        pt.nd.waitall()
    pt.nd.waitall()
    y = pt.nd.Custom(_a(pt, pt.cpu(), [3.0]), op_type="eng_slow_square",
                     delay="0.0")
    np.testing.assert_array_equal(y.asnumpy(), [9.0])
