"""The slice as a whole: BERT pretrained as the reference's flagship
configuration runs it, at a small size, in the port against the
reference. A 2-layer, 32-unit, 4-head BERT with vocab 50 and the default
``BERTMLMLoss`` (auto: the chunked head) at ``chunk_size=16``, so the
vocab's padding path runs, trains three steps under
``amp.init("bfloat16")`` with f32 parameters and LAMB driven by a
``PolyScheduler`` with warmup, through ``autograd.record()``,
``backward()`` and ``Trainer.step``. The float16 path follows:
``cast("float16")``, ``multi_precision=True`` LAMB, ``amp.init
("float16")``, ``init_trainer`` and ``scale_loss``.

Batch 2 x seq 16 gives 32 rows, a whole number of the reference's bf16
row blocks (16), so its LayerNorm and epilogue Pallas kernels (in
interpret mode) serve every call, as the port's kernel arithmetic does;
at 24 rows it would run the XLA composition, which rounds bias+residual
to bf16 twice.

Tolerance: the loss of each step and every parameter after the third
step (the masters too, in float16) within ``FACTOR`` times the
reference's own distance between its AMP run and its f32 run without
AMP, taken over all losses or all parameters (on the CPU the port's
read 0.94 of it for the losses and 0.24 for the parameters in bf16,
0.12 and 0.77 in float16). So that a port whose AMP cast nothing (1x)
cannot pass, the port's parameters must also lie at least ``1 / FACTOR``
of that distance from the f32 run's (on the CPU 1.01 in bf16, 1.17 in
float16). Dropout is 0:
the two packages draw different masks (tests/test_torch_bert_train.py).
"""
import functools

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as ref_amp
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMLoss as RefMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss as PortMLM
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as PortBERT

KW = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
          max_length=16, vocab_size=50, use_pooler=False,
          use_classifier=False, use_decoder=False)
MLM = dict(vocab_size=50, units=32, chunk_size=16, prefix="mlm_")
BATCH, SEQ = 2, 16
FACTOR = 2.0


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    yield
    amp.reset()
    ref_amp.reset()


def _batch():
    rng = np.random.RandomState(0)
    return [rng.randint(0, hi, (BATCH, SEQ)).astype(np.float32)
            for hi in (50, 2, 50)]


def _arrays():
    net, mlm = RefBERT(prefix="bert_", dropout=0.0, **KW), RefMLM(**MLM)
    net.initialize()
    mlm.initialize()
    ids, tok, _ = _batch()
    net(mx.nd.array(ids), mx.nd.array(tok))
    rng = np.random.RandomState(1)
    out = {}
    for block in (net, mlm):
        for name, p in block.collect_params().items():
            a = (rng.randn(*p.shape) * 0.1).astype(np.float32)
            out[name] = a + 1.0 if name.endswith("gamma") else a
    return out


def _train(lib, arrays, mode, steps=3):
    """mode: "f32", "bf16" (AMP, f32 parameters) or "f16" (float16
    parameters with masters, AMP float16 and loss scaling). Returns the
    losses and the parameters (masters where there are) after the last
    step, as f32 numpy."""
    ctx = lib.cpu()
    net = (RefBERT if lib is mx else PortBERT)(prefix="bert_", dropout=0.0,
                                               **KW)
    mlm = (RefMLM if lib is mx else PortMLM)(**MLM)
    if lib is mx:
        net.initialize()
        mlm.initialize()
        ids, tok, _ = _batch()
        net(mx.nd.array(ids), mx.nd.array(tok))
        for block in (net, mlm):
            for name, p in block.collect_params().items():
                p.set_data(mx.nd.array(arrays[name]))
    else:
        for block in (net, mlm):
            pt.params_from_numpy(
                block, {n: arrays[n] for n in block.collect_params().keys()},
                ctx=ctx)
    lib_amp = ref_amp if lib is mx else amp
    if mode == "f16":
        net.cast("float16")
        mlm.cast("float16")
    if mode != "f32":
        lib_amp.init(target_dtype="bfloat16" if mode == "bf16"
                     else "float16")
    params = net.collect_params()
    params.update(mlm.collect_params())
    sched = lib.lr_scheduler.PolyScheduler(max_update=20, base_lr=1e-2,
                                           warmup_steps=2)
    trainer = lib.gluon.Trainer(params, "lamb", {
        "learning_rate": 1e-2, "wd": 0.01, "lr_scheduler": sched,
        "multi_precision": mode == "f16"})
    if mode == "f16":
        lib_amp.init_trainer(trainer)
    ids, tok, lab = (lib.nd.array(a, ctx=ctx) for a in _batch())
    losses = []
    for _ in range(steps):
        with lib.autograd.record():
            loss = mlm(net(ids, tok)[0], lab).mean()
            if mode == "f16":
                with lib_amp.scale_loss(loss, trainer) as scaled:
                    pass
        (scaled if mode == "f16" else loss).backward()
        trainer.step(BATCH)
        losses.append(float(loss.asnumpy().astype(np.float32)[0]))
    updater = trainer._updaters[0] if lib is mx else trainer._updater
    names = sorted(params.keys())
    if mode == "f16":
        weights = {n: updater.states[i][1].asnumpy()
                   for i, n in enumerate(names)}
    else:
        weights = {n: params[n].data().asnumpy().astype(np.float32)
                   for n in names}
    if mode != "f32":
        lib_amp.reset()
    return np.array(losses), weights


def _held(port, ref, twin):
    (pl, pw), (rl, rw), (tl, tw) = port, ref, twin
    own_loss = np.abs(rl - tl).max()
    own_w = max(np.abs(rw[n] - tw[n]).max() for n in rw)
    assert own_loss > 0 and own_w > 0
    assert np.abs(pl - rl).max() <= FACTOR * own_loss, (pl, rl, tl)
    assert pw.keys() == rw.keys()
    worst = max(np.abs(pw[n] - rw[n]).max() for n in rw)
    assert worst <= FACTOR * own_w, (worst, own_w)
    # not the f32 run: the port's parameters at least 1 / FACTOR of the
    # reference's own distance away from the f32 run's
    away = max(np.abs(pw[n] - tw[n]).max() for n in rw)
    assert away >= own_w / FACTOR, (away, own_w)
    return np.abs(pl - rl).max() / own_loss, worst / own_w


@functools.lru_cache(maxsize=None)
def _twin():
    """The reference's f32 run without AMP, and the weights (one run
    serves both tests)."""
    arrays = _arrays()
    return arrays, _train(mx, arrays, "f32")


def test_bert_amp_bf16_slice_matches_reference(pallas_interpret):
    arrays, twin = _twin()
    ref = _train(mx, arrays, "bf16")
    port = _train(pt, arrays, "bf16")
    _held(port, ref, twin)
    assert port[0][-1] < port[0][0]


def test_bert_amp_float16_slice_matches_reference(pallas_interpret):
    arrays, twin = _twin()
    ref = _train(mx, arrays, "f16")
    port = _train(pt, arrays, "f16")
    _held(port, ref, twin)
    assert np.isfinite(port[0]).all() and port[0][-1] < port[0][0]


def test_bert_amp_step_runs_the_chunked_head_and_the_cast_mix():
    """One AMP step of the port: the default head is the chunked one,
    the LayerNorms see bf16 data with f32 gamma (all but the
    embedding's, which sees f32), and every parameter's gradient is
    f32."""
    from mxnet_tpu_torch.ops import cuda_norm
    arrays = _arrays()
    net = PortBERT(prefix="bert_", dropout=0.0, **KW)
    mlm = PortMLM(**MLM)
    for block in (net, mlm):
        pt.params_from_numpy(
            block, {n: arrays[n] for n in block.collect_params().keys()},
            ctx=pt.cpu())
    amp.init()
    ids, tok, lab = (pt.nd.array(a, ctx=pt.cpu()) for a in _batch())
    seen = []
    real = cuda_norm.layer_norm

    def spy(x, gamma, beta, eps):
        seen.append((x.dtype, gamma.dtype))
        return real(x, gamma, beta, eps)
    cuda_norm.layer_norm = spy
    try:
        with pt.ops.recording() as ops, pt.autograd.record():
            loss = mlm(net(ids, tok)[0], lab).mean()
    finally:
        cuda_norm.layer_norm = real
    loss.backward()
    names = {o.name for o in ops}
    assert "_contrib_chunked_lm_head_ce" in names and \
        "log_softmax" not in names
    import torch
    assert seen[0] == (torch.float32, torch.float32)
    assert seen[1:] == [(torch.bfloat16, torch.float32)] * 5
    params = net.collect_params()
    params.update(mlm.collect_params())
    for p in params.values():
        assert p.grad().dtype == np.float32
