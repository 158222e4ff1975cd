"""The port's LM-head cross entropies against the reference's
(``_lm_head_ce`` and ``_make_chunked_ce``, mxnet_tpu/ops/contrib_ops.py),
and ``BERTMLMLoss`` in each mode against the reference's with the same
weights.

The same numpy inputs go through both packages, at the tolerances of
tests/test_chunked_ce.py: in f32 the loss within rtol 1e-6 and the
gradients within rtol 5e-5 and atol 1e-5; in bf16 (and bf16 hidden
states against f32 weights, as under AMP) the loss within 1e-5 and each
gradient's max abs error below 1e-2 of its largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMLoss as RefMLM
from mxnet_tpu.ops.contrib_ops import _lm_head_ce, _make_chunked_ce

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss as PortMLM
from mxnet_tpu_torch.ops import contrib_ops

T, U, V = 24, 16, 50


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _problem(seed=0, labels=None):
    rng = np.random.RandomState(seed)
    h = rng.randn(T, U).astype(np.float32)
    w = (rng.randn(V, U) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    lab = rng.randint(0, V, (T,)).astype(np.int32) if labels is None \
        else np.asarray(labels, np.int32)
    dy = rng.rand(T).astype(np.float32)
    return h, w, b, lab, dy


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ref(fn, h, w, b, lab, dy, hdt, wdt):
    """Loss and (dh, dw, db) of the reference op for cotangent dy."""
    args = (jnp.asarray(h).astype(_JDT[hdt]), jnp.asarray(w).astype(_JDT[wdt]),
            jnp.asarray(b))
    labj = jnp.asarray(lab)
    loss, vjp = jax.vjp(lambda h, w, b: fn(h, w, b, labj), *args)
    grads = vjp(jnp.asarray(dy))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))   # noqa: E731
    return f32(loss), [f32(g) for g in grads]


def _port(op, h, w, b, lab, dy, hdt, wdt, **kw):
    ts = [torch.tensor(h).to(_TDT[hdt]), torch.tensor(w).to(_TDT[wdt]),
          torch.tensor(b)]
    for t in ts:
        t.requires_grad_()
    loss = op(*ts, torch.tensor(lab, dtype=torch.int64), **kw)
    grads = torch.autograd.grad(loss, ts, torch.tensor(dy))
    return loss.detach().float().numpy(), [g.float().numpy() for g in grads]


def _check(got, ref, dtype):
    (gl, gg), (rl, rg) = got, ref
    if dtype == "float32":
        np.testing.assert_allclose(gl, rl, rtol=1e-6, atol=1e-6)
        for a, r, nm in zip(gg, rg, "hwb"):
            np.testing.assert_allclose(a, r, rtol=5e-5, atol=1e-5,
                                       err_msg=nm)
        return
    np.testing.assert_allclose(gl, rl, rtol=1e-5, atol=1e-5)
    for a, r, nm in zip(gg, rg, "hwb"):
        assert np.max(np.abs(a - r)) / (np.max(np.abs(r)) + 1e-9) < 1e-2, nm


_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
           ("bfloat16", "float32")]


@pytest.mark.parametrize("chunk", [50, 16, 7, 1])
@pytest.mark.parametrize("hdt,wdt", _DTYPES)
def test_chunked_matches_reference(chunk, hdt, wdt):
    h, w, b, lab, dy = _problem()
    ref = _ref(_make_chunked_ce(chunk), h, w, b, lab, dy, hdt, wdt)
    got = _port(contrib_ops.chunked_lm_head_ce, h, w, b, lab, dy, hdt, wdt,
                chunk_size=chunk)
    _check(got, ref, hdt)


@pytest.mark.parametrize("hdt,wdt", _DTYPES)
def test_fused_matches_reference(hdt, wdt):
    h, w, b, lab, dy = _problem(1)
    ref = _ref(_lm_head_ce, h, w, b, lab, dy, hdt, wdt)
    got = _port(contrib_ops.fused_lm_head_ce, h, w, b, lab, dy, hdt, wdt)
    _check(got, ref, hdt)


def test_out_of_range_labels_match_reference():
    """The chunked head clamps ids into the vocab; the fused head reads
    them as take_along_axis does (-1 the last class, V and beyond NaN)
    and leaves them out of its one-hot, as the reference does."""
    lab = np.arange(T) % V
    lab[:4] = [-1, V, V + 7, -3]
    h, w, b, lab, dy = _problem(2, labels=lab)
    for fn, op in ((_make_chunked_ce(16), contrib_ops.chunked_lm_head_ce),
                   (_lm_head_ce, contrib_ops.fused_lm_head_ce)):
        kw = {"chunk_size": 16} if op is contrib_ops.chunked_lm_head_ce \
            else {}
        ref = _ref(fn, h, w, b, lab, dy, "float32", "float32")
        got = _port(op, h, w, b, lab, dy, "float32", "float32", **kw)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
        for a, r in zip(got[1], ref[1]):
            np.testing.assert_allclose(a, r, rtol=5e-5, atol=1e-5)
    assert np.isnan(got[0][1:3]).all() and np.isfinite(got[0][0])


@pytest.mark.parametrize("op", ["_contrib_chunked_lm_head_ce",
                                "_contrib_fused_lm_head_ce"])
def test_labels_shape_refused_and_nd_call(op):
    rng = np.random.RandomState(2)
    h = rng.randn(4, 6, 8).astype(np.float32)
    w = (rng.randn(30, 8) * 0.3).astype(np.float32)
    b = np.zeros(30, np.float32)
    lab = rng.randint(0, 30, (4, 6)).astype(np.float32)
    ctx = pt.cpu()
    args = [pt.nd.array(a, ctx=ctx) for a in (h, w, b)]
    out = getattr(pt.nd, op)(*args, pt.nd.array(lab, ctx=ctx))
    ref = getattr(mx.nd, op)(*[mx.nd.array(a) for a in (h, w, b, lab)])
    assert out.shape == (4, 6) and out.dtype == np.float32
    np.testing.assert_allclose(out.asnumpy(), ref.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    bad = pt.nd.array(lab.reshape(6, 4), ctx=ctx)
    with pytest.raises(ValueError, match="labels shape"):
        getattr(pt.nd, op)(*args, bad)


def test_chunk_size_from_config(monkeypatch):
    assert contrib_ops.ce_chunk_size(0, 30522) == 4096
    assert contrib_ops.ce_chunk_size(0, 100) == 100
    assert contrib_ops.ce_chunk_size(7, 50) == 7
    monkeypatch.setenv("MXNET_CHUNKED_CE_CHUNK", "1000")
    assert contrib_ops.ce_chunk_size(0, 30522) == 1000
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    assert contrib_ops.ce_chunk_size(16, 50) == 16
    # cost mode: the op asks the tuner for its chunk, the same chunk the
    # reference's _tuned_ce_chunk picks on the same grid and peaks from
    # the same analytic figures (the port has no XLA cost analysis, so the
    # reference's probe compiles give way to its analytic FLOPs and bytes;
    # the bytes dominate at these peaks, so no tie decides), and the loss
    # and gradients stay the reference's at the f32 tolerances
    from mxnet_tpu import autotune as rat
    from mxnet_tpu_torch import autotune as pat
    peaks = (1e15, 1e9)
    monkeypatch.setattr(rat, "_peaks", lambda *a: peaks)
    monkeypatch.setattr(pat, "_peaks", lambda *a: peaks)
    monkeypatch.setattr(rat, "_aot_probe", lambda fn, args: (None,) * 3)
    rat.clear()
    pat.clear()
    try:
        rng = np.random.RandomState(3)
        Vb = 5000
        h = rng.randn(T, U).astype(np.float32)
        w = (rng.randn(Vb, U) * 0.3).astype(np.float32)
        b = (rng.randn(Vb) * 0.1).astype(np.float32)
        lab = rng.randint(0, Vb, (T,)).astype(np.int32)
        dy = rng.rand(T).astype(np.float32)
        got = _port(lambda *a: contrib_ops.chunked_lm_head_ce(*a), h, w, b,
                    lab, dy, "float32", "float32")
        from mxnet_tpu.ops.contrib_ops import chunked_lm_head_ce as rce
        ref = _ref(lambda *a: rce(*a), h, w, b, lab, dy, "float32",
                   "float32")
        (pk, pv), = [(k, v) for k, v in pat.table().items()
                     if "chunked_lm_head_ce" in k]
        (rk, rv), = [(k, v) for k, v in rat.table().items()
                     if "chunked_lm_head_ce" in k]
        assert pk == rk == "cpu|chunked_lm_head_ce|T=%d,U=%d,V=%d,esize=4" \
            % (T, U, Vb)
        assert pv["params"] == rv["params"] == {"chunk": 4096}
        assert pv["mode"] == "cost"
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
        for a, r in zip(got[1], ref[1]):
            np.testing.assert_allclose(a, r, rtol=5e-5, atol=1e-5)
    finally:
        rat.clear()
        pat.clear()


def _mlm_pair(mode, chunk_size, seed=4):
    """The reference's and the port's head with the same weights."""
    rng = np.random.RandomState(seed)
    kw = dict(vocab_size=40, units=16, mode=mode, chunk_size=chunk_size,
              prefix="mlm_")
    ref, port = RefMLM(**kw), PortMLM(**kw)
    ref.initialize()
    arrays = {}
    for name, p in ref.collect_params().items():
        a = (rng.randn(*p.shape) * 0.3).astype(np.float32)
        arrays[name] = a + 1.0 if name.endswith("gamma") else a
        p.set_data(mx.nd.array(arrays[name]))
    pt.params_from_numpy(port, arrays, ctx=pt.cpu())
    x = rng.randn(3, 5, 16).astype(np.float32)
    lab = rng.randint(0, 40, (3, 5)).astype(np.float32)
    return ref, port, x, lab


def _mlm_run(lib, blk, x, lab, ctx):
    x = lib.nd.array(x, ctx=ctx)
    x.attach_grad()
    with lib.autograd.record():
        loss = blk(x, lib.nd.array(lab, ctx=ctx))
        total = loss.mean()
    total.backward()
    grads = {n: p.grad().asnumpy() for n, p in blk.collect_params().items()}
    grads["x"] = x.grad.asnumpy()
    return loss.asnumpy(), grads


@pytest.mark.parametrize("mode,chunk,env", [
    ("auto", 0, None), ("auto", 16, None), ("auto", 0, "0"),
    ("chunked", 7, None), ("fused", 0, None), ("dense", 0, None)])
def test_mlm_loss_modes_match_reference(monkeypatch, mode, chunk, env):
    """Each mode, and MXNET_CHUNKED_CE=0, against the reference's head:
    per-position loss and every gradient, the input's included."""
    if env is not None:
        monkeypatch.setenv("MXNET_CHUNKED_CE", env)
    ref, port, x, lab = _mlm_pair(mode, chunk)
    rl, rg = _mlm_run(mx, ref, x, lab, mx.cpu())
    pl, pg = _mlm_run(pt, port, x, lab, pt.cpu())
    np.testing.assert_allclose(pl, rl, rtol=1e-5, atol=1e-6)
    assert rg.keys() == pg.keys()
    for n in rg:
        np.testing.assert_allclose(pg[n], rg[n], rtol=2e-4, atol=2e-5,
                                   err_msg=n)


def test_mlm_loss_auto_reads_the_flag_at_forward_time(monkeypatch):
    _, port, x, lab = _mlm_pair("auto", 0)
    seen = []
    with pt.ops.recording() as ops:
        port(pt.nd.array(x, ctx=pt.cpu()), pt.nd.array(lab, ctx=pt.cpu()))
    seen.append({o.name for o in ops})
    monkeypatch.setenv("MXNET_CHUNKED_CE", "0")
    with pt.ops.recording() as ops:
        port(pt.nd.array(x, ctx=pt.cpu()), pt.nd.array(lab, ctx=pt.cpu()))
    seen.append({o.name for o in ops})
    assert "_contrib_chunked_lm_head_ce" in seen[0]
    assert "log_softmax" not in seen[0]
    assert "_contrib_chunked_lm_head_ce" not in seen[1]
    assert {"FullyConnected", "log_softmax", "pick"} <= seen[1]
