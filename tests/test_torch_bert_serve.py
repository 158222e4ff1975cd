"""The port's serving slice as a whole against the reference: the same
small BERT in both packages, the weights carried by
``params_from_numpy``, served through both ``InferenceSession``s.

f32 runs the unfused attention on both sides (the fused kernels take
bf16/f16 only) and agrees within 1e-4. bf16 runs the Pallas kernels
(interpret mode) on the reference side and the plain versions of the
CUDA kernels on the port, within 5e-2 (the bf16 bound of
tests/test_amp.py).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT
from mxnet_tpu.gluon import nn as ref_nn

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as PortBERT
from mxnet_tpu_torch.gluon import nn as port_nn

KW = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
          max_length=32, vocab_size=100, prefix="bert_")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _tokens(rng, b, s):
    return (rng.randint(0, 100, (b, s)).astype(np.float32),
            rng.randint(0, 2, (b, s)).astype(np.float32))


def _pair(dropout=0.0, dtype="float32"):
    """The reference BERT and the port's, with the same weights."""
    rng = np.random.RandomState(0)
    ids, tok = _tokens(rng, 2, 8)
    ref = RefBERT(dropout=dropout, **KW)
    ref.initialize()
    ref(mx.nd.array(ids), mx.nd.array(tok))
    arrays = {n: p.data().asnumpy() for n, p in ref.collect_params().items()}
    port = PortBERT(dropout=dropout, **KW)
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    if dtype != "float32":
        ref.cast(dtype)
        port.cast(dtype)
    return ref, port, (ids, tok)


def _sessions(ref, port, example):
    ids, tok = example
    rs = ref.serve_session(mx.nd.array(ids), mx.nd.array(tok), seq_axis=1,
                           max_batch=4, max_seq=16)
    ps = port.serve_session(pt.nd.array(ids, ctx=pt.cpu()),
                            pt.nd.array(tok, ctx=pt.cpu()), seq_axis=1,
                            max_batch=4, max_seq=16)
    return rs, ps


def _assert_outputs_close(ref_outs, port_outs, tol):
    assert len(ref_outs) == len(port_outs)
    for r, p in zip(ref_outs, port_outs):
        r = np.asarray(r, dtype=np.float32)
        assert p.shape == r.shape
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p, r, rtol=tol, atol=tol)


def test_parameter_names_match_reference():
    ref = RefBERT(**KW)
    port = PortBERT(**KW)
    names = list(ref.collect_params().keys())
    assert list(port.collect_params().keys()) == names
    assert "bert_encoder_transformer1_positionwise_ffn0_ffn_1_weight" in names


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_bert_matches_reference(pallas_interpret, dtype):
    ref, port, example = _pair(dtype=dtype)
    rs, ps = _sessions(ref, port, example)
    rng = np.random.RandomState(1)
    for b, s in ((4, 16), (3, 5)):      # at bucket size, then padded
        ids, tok = _tokens(rng, b, s)
        ro, po = rs.infer(ids, tok), ps.infer(ids, tok)
        _assert_outputs_close(ro, po, TOL[dtype])
        # (seq, batch, vocab) decoder output: the reference's unpad
        # heuristic leaves it at the bucket — so does the port
        (bb, sb), _ = ps.ladder.bucket_for(b, s)
        assert po[0].shape == (b, s, 64)
        assert po[3].shape == (sb, bb, 100)
    assert ps.bucket_table() == rs.bucket_table()


def test_dropout_is_identity_in_eval(pallas_interpret):
    """dropout=0.1 in eval mode: Dropout is the identity and ffn_2 runs
    without the residual epilogue (the residual add stays outside)."""
    ref, port, example = _pair(dropout=0.1)
    rs, ps = _sessions(ref, port, example)
    ids, tok = _tokens(np.random.RandomState(2), 3, 7)
    _assert_outputs_close(rs.infer(ids, tok), ps.infer(ids, tok), 1e-4)


def test_training_mode_dropout_drops_and_repeats_under_a_seed():
    """In train mode dropout=0.1 drops (the outputs leave the eval
    ones), and the same seed of the context's generator draws the same
    masks."""
    _, port, (ids, tok) = _pair(dropout=0.1)
    args = [pt.nd.array(a, ctx=pt.cpu()) for a in (ids, tok)]
    evals = [o.asnumpy() for o in port(*args)]

    def train():
        pt.random.seed(11)
        with pt.autograd.train_mode():
            return [o.asnumpy() for o in port(*args)]
    a, b = train(), train()
    for x, y, e in zip(a, b, evals):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x, y)
        assert not np.allclose(x, e)


@pytest.mark.parametrize("make,call", [
    (lambda nn: nn.Dense(4, epilogue="relu"), None),
    (lambda nn: nn.Dense(4, epilogue="gelu", use_bias=False), None),
    (lambda nn: nn.Dense(4, epilogue="residual", activation="tanh"), None),
    (lambda nn: nn.Dense(4, epilogue="gelu", in_units=3), "residual"),
    (lambda nn: nn.Dense(4, in_units=3), "residual"),
], ids=["unknown", "no_bias", "activation", "gelu_residual",
        "plain_residual"])
def test_dense_epilogue_errors_match_reference(make, call):
    def error(nn, nd, ctx):
        try:
            net = make(nn)
            net.initialize(ctx=ctx)
            if call == "residual":
                x = nd.array(np.ones((2, 3), np.float32), ctx=ctx)
                net(x, x)
        except ValueError as e:
            return str(e)
        return None

    want = error(ref_nn, mx.nd, mx.cpu())
    assert want is not None
    assert error(port_nn, pt.nd, pt.cpu()) == want


def test_residual_epilogue_parity(pallas_interpret):
    """Dense(epilogue='residual') with and without a residual input."""
    rng = np.random.RandomState(3)
    x = rng.randn(6, 5).astype(np.float32)
    r = rng.randn(6, 7).astype(np.float32)
    ref = ref_nn.Dense(7, flatten=False, epilogue="residual", prefix="d_")
    ref.initialize()
    ref(mx.nd.array(x))
    port = port_nn.Dense(7, flatten=False, epilogue="residual", prefix="d_")
    pt.params_from_numpy(
        port, {n: p.data().asnumpy() for n, p in ref.collect_params().items()},
        ctx=pt.cpu())
    for args in ((x,), (x, r)):
        want = ref(*(mx.nd.array(a) for a in args)).asnumpy()
        got = port(*(pt.nd.array(a, ctx=pt.cpu()) for a in args))
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-5)


def test_probe_unpad_for_models_without_random_ops():
    """With no op that draws random numbers, both sessions learn which
    outputs scale from two probe shapes and unpad both axes."""
    rng = np.random.RandomState(4)
    ref = ref_nn.HybridSequential(prefix="m_")
    with ref.name_scope():
        ref.add(ref_nn.Dense(8, flatten=False), ref_nn.LayerNorm())
    ref.initialize()
    x = rng.randn(2, 6, 4).astype(np.float32)
    ref(mx.nd.array(x))
    port = port_nn.HybridSequential(prefix="m_")
    with port.name_scope():
        port.add(port_nn.Dense(8, flatten=False), port_nn.LayerNorm())
    pt.params_from_numpy(
        port, {n: p.data().asnumpy() for n, p in ref.collect_params().items()},
        ctx=pt.cpu())
    rs = ref.serve_session(mx.nd.array(x), seq_axis=1, max_batch=4,
                           max_seq=8)
    ps = port.serve_session(pt.nd.array(x, ctx=pt.cpu()), seq_axis=1,
                            max_batch=4, max_seq=8)
    assert ps._out_scales == rs._out_scales == [(True, True)]
    req = rng.randn(3, 5, 4).astype(np.float32)
    want, got = rs.infer(req), ps.infer(req)
    assert got.shape == want.shape == (3, 5, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_weights_are_read_live():
    """The session reads the Parameters on every request: set_data after
    the session's first forward completed the deferred shapes is served
    at once."""
    port = PortBERT(**KW)
    port.initialize(ctx=pt.cpu())
    ids, tok = _tokens(np.random.RandomState(6), 2, 8)
    ps = port.serve_session(pt.nd.array(ids, ctx=pt.cpu()),
                            pt.nd.array(tok, ctx=pt.cpu()), seq_axis=1)
    assert np.abs(ps.infer(ids, tok)[2]).max() > 0
    # the weight's shape was deferred: the session's forward created it
    params = port.collect_params()
    params["bert_classifier_weight"].set_data(np.zeros((2, 64), np.float32))
    params["bert_classifier_bias"].set_data(np.array([1.0, -1.0],
                                                     np.float32))
    np.testing.assert_array_equal(ps.infer(ids, tok)[2],
                                  np.tile([1.0, -1.0], (2, 1)))


def test_validate_request_matches_reference():
    ref, port, example = _pair()
    rs, ps = _sessions(ref, port, example)
    bad = [np.zeros((2, 8), np.float32)]                    # arity
    ragged = [np.zeros((2, 8), np.float32), np.zeros((2, 7), np.float32)]
    for req in (bad, ragged):
        with pytest.raises(mx.MXNetError) as want:
            rs.validate_request(req)
        with pytest.raises(pt.MXNetError) as got:
            ps.validate_request(req)
        assert str(got.value) == str(want.value)


def test_warmup_and_bucket_table():
    ref, port, example = _pair()
    rs, ps = _sessions(ref, port, example)
    rs.warmup([(1, 4), (4, 16)])
    ps.warmup([(1, 4), (4, 16)])
    ids, tok = _tokens(np.random.RandomState(5), 1, 3)
    rs.infer(ids, tok)
    ps.infer(ids, tok)
    assert ps.bucket_table() == rs.bucket_table()
    assert ps.bucket_misses() == rs.bucket_misses() == 0
