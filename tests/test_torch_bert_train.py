"""The port's training slice as a whole against the reference, in f32: a
2-layer, 64-unit, 4-head BERT with ``BERTMLMLoss(mode="dense")``, trained
through ``autograd.record()`` -> ``backward()`` -> ``gluon.Trainer.step``
with SGD (momentum) and with LAMB, the weights (biases, beta and gamma - 1
included) drawn from a seed and carried by ``params_from_numpy``.

In f32 the reference runs its LayerNorm and epilogue Pallas kernels in
interpret mode and the unfused attention (its fused kernel takes bf16
only), and so does the port with the plain versions; the step-0
gradients, the loss of each of 3 steps and every parameter after each
step agree within 1e-5 (abs + rel). tests/test_torch_bert_train_bf16.py
holds the bf16 slice.

Dropout > 0 cannot be held at slice level: the reference draws its
dropout seeds from ``jax.random`` and the port from its own generator,
so the masks differ. The kernel-level tests
(tests/test_torch_kernels_bwd.py) hold the attention mask bit for bit
for the same seeds; here dropout 0.1 is held to training that runs,
repeats under the same seed and lowers the loss.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTMLMLoss as RefMLM
from mxnet_tpu.gluon.model_zoo.bert import BERTModel as RefBERT

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTMLMLoss as PortMLM
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as PortBERT

KW = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
          max_length=32, vocab_size=100, use_pooler=False,
          use_classifier=False, use_decoder=False)
MLM = dict(vocab_size=100, units=64, mode="dense", prefix="mlm_")
HP = {"sgd": {"learning_rate": 1e-2, "wd": 0.01, "momentum": 0.9},
      "lamb": {"learning_rate": 1e-2, "wd": 0.01}}
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    """Unset every variable the port's config declares: other test files
    of the suite set some (MXNET_ZERO, ...) in os.environ without
    restoring them, and the port's Trainer refuses what they turn on."""
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, hi, (BATCH, SEQ)).astype(np.float32)
            for hi in (100, 2, 100)]


def _arrays(seed=1):
    """Every parameter of the slice drawn from N(0, 0.1^2) (gamma around
    1), with the reference's names and shapes."""
    net, mlm = RefBERT(prefix="bert_", dropout=0.0, **KW), RefMLM(**MLM)
    net.initialize()
    mlm.initialize()
    ids, tok, _ = _batch()
    net(mx.nd.array(ids), mx.nd.array(tok))
    rng = np.random.RandomState(seed)
    out = {}
    for block in (net, mlm):
        for name, p in block.collect_params().items():
            a = (rng.randn(*p.shape) * 0.1).astype(np.float32)
            out[name] = a + 1.0 if name.endswith("gamma") else a
    return out


def _slice(lib, ctx, arrays, dtype, dropout=0.0):
    """(net, mlm, all parameters) of one package, weights from
    ``arrays``."""
    bert = RefBERT if lib is mx else PortBERT
    mlm_cls = RefMLM if lib is mx else PortMLM
    net = bert(prefix="bert_", dropout=dropout, **KW)
    mlm = mlm_cls(**MLM)
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
    if dtype != "float32":
        net.cast(dtype)
        mlm.cast(dtype)
    params = net.collect_params()
    params.update(mlm.collect_params())
    return net, mlm, params


def _train(lib, ctx, arrays, dtype, opt, steps=3, hp=None):
    """Losses of each step, step-0 gradients, parameters after each
    step."""
    net, mlm, params = _slice(lib, ctx, arrays, dtype)
    trainer = lib.gluon.Trainer(params, opt, dict(hp or HP[opt]))
    ids, tok, lab = (lib.nd.array(a, ctx=ctx) for a in _batch())
    losses, grads, weights = [], None, []
    for step in range(steps):
        with lib.autograd.record():
            loss = mlm(net(ids, tok)[0], lab).mean()
        loss.backward()
        if step == 0:
            grads = {n: p.grad().asnumpy().astype(np.float32)
                     for n, p in params.items()}
        trainer.step(BATCH)
        losses.append(float(loss.asnumpy().astype(np.float32)[0]))
        weights.append({n: p.data().asnumpy().astype(np.float32)
                        for n, p in params.items()})
    return losses, grads, weights


def _assert_slice(ref, port, tol, grad_tol):
    (rl, rg, rw), (pl, pg, pw) = ref, port
    np.testing.assert_allclose(pl, rl, rtol=tol, atol=tol)
    assert rg.keys() == pg.keys()
    for n, g in rg.items():
        err = np.abs(pg[n] - g).max()
        assert err <= grad_tol * (1 + np.abs(g).max()), (n, err)
    for r_step, p_step in zip(rw, pw):
        for n, w in r_step.items():
            np.testing.assert_allclose(p_step[n], w, rtol=tol, atol=tol,
                                       err_msg=n)


@pytest.mark.parametrize("opt", ["sgd", "lamb"])
def test_bert_training_slice_f32_matches_reference(pallas_interpret, opt):
    arrays = _arrays()
    ref = _train(mx, mx.cpu(), arrays, "float32", opt)
    port = _train(pt, pt.cpu(), arrays, "float32", opt)
    _assert_slice(ref, port, 1e-5, 1e-5)


def test_mlm_loss_names_and_modes_match_reference():
    """Every mode builds, with the reference's parameter names, and
    resolves as the reference's does (the modes' numerics:
    tests/test_torch_lm_head_ce.py)."""
    for mode in ("dense", "auto", "chunked", "fused"):
        kw = dict(MLM, mode=mode, prefix="mlm_%s_" % mode)
        ref, port = RefMLM(**kw), PortMLM(**kw)
        names = list(ref.collect_params().keys())
        assert list(port.collect_params().keys()) == names
        assert {kw["prefix"] + n for n in (
            "head_weight", "head_bias", "transform_weight",
            "transform_bias")} < set(names) and len(names) == 6
        assert port._resolve_mode() == ref._resolve_mode()
    assert PortMLM(**dict(MLM, mode="auto"))._resolve_mode() == "chunked"


def test_bert_training_with_dropout_runs_and_repeats():
    arrays = _arrays()

    def run(seed):
        pt.random.seed(seed)
        net, mlm, params = _slice(pt, pt.cpu(), arrays, "float32",
                                  dropout=0.1)
        trainer = pt.gluon.Trainer(params, "lamb", dict(HP["lamb"]))
        ids, tok, lab = (pt.nd.array(a, ctx=pt.cpu()) for a in _batch())
        losses = []
        for _ in range(4):
            with pt.autograd.record():
                loss = mlm(net(ids, tok)[0], lab).mean()
            loss.backward()
            trainer.step(BATCH)
            losses.append(float(loss.asnumpy()[0]))
        return losses

    a, b, c = run(3), run(3), run(4)
    assert np.isfinite(a).all() and a[-1] < a[0]
    assert a == b and a != c
    # without dropout the first loss is the reference's; with it, not
    assert a[0] != _train(pt, pt.cpu(), arrays, "float32", "lamb", 1)[0][0]
