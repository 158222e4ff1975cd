"""The PTB word-language model (upstream MXNet's
``example/gluon/word_language_model``, tied) trained in both packages on
the CPU at a small size: vocabulary 50, embedding = hidden 16, 2 LSTM
layers, bptt 10, batch 4, dropout 0, SGD lr 20 on the per-token loss
with its gradients clipped to 0.05 (every step clips), the state
carried and detached between steps. ``chip_smoke.ptb_model``/``ptb_step`` are the
model and the step of the card's phase 12, run here with each package.

Eight steps on one window of token ids from the same weights: every step's
loss within 1e-5 relative of the reference's, and every parameter after
the last step within 1e-4 relative (atol 1e-5): the port eager, and
hybridized (its embedding, dropouts, LSTM and decoder each one CachedOp
call) against the reference's eager run, since the reference's own
hybridized LSTM cannot return its states. The reference's
``clip_global_norm`` calls ``nd.minimum``, which its namespace lacks; the
test lends it ``broadcast_minimum`` under that name.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from chip_smoke import ptb_model, ptb_step
from test_torch_gluon_surface import _xavier_from

VOCAB, UNITS, BPTT, BATCH, STEPS = 50, 16, 10, 4, 8
# the clip cut with the width: at 0.05 every step clips (the gradient of
# the per-token loss is ~0.16 at this width)
LR, CLIP = 20.0, 0.05
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5


def _tokens(seed=0):
    """One (bptt, batch) window of ids and its next-token targets."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, BPTT * BATCH + 1).astype(np.float32)
    return ids[:-1].reshape(BPTT, BATCH), ids[1:].reshape(BPTT, BATCH)


def _train(lib, ctx, net, hybridize=False):
    if hybridize:
        net.hybridize()
    trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": LR})
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = net.begin_state(batch_size=BATCH, ctx=ctx)
    data, target = (lib.nd.array(a, ctx=ctx) for a in _tokens())
    losses, norms = [], []
    for _ in range(STEPS):
        # one window every step, the state carried: the loss must fall
        loss, hidden, norm = ptb_step(lib, net, trainer, loss_fn, data,
                                      target, hidden, clip=CLIP)
        losses.append(float(loss.mean().asscalar()))
        norms.append(norm)
    params = {n: p.data().asnumpy() for n, p in
              net.collect_params().items()}
    return losses, norms, params, [h.asnumpy() for h in hidden]


@pytest.fixture(autouse=True, scope="module")
def _port_config_unset():
    """Unset every variable the port's config declares: other test files
    of the suite set some (MXNET_ZERO, ...) in os.environ without
    restoring them, and the port's Trainer refuses what they turn on."""
    with pytest.MonkeyPatch.context() as mp:
        for var in pt.config.VARS:
            mp.delenv(var, raising=False)
        yield


def _reference_run(seed):
    """The reference's weights, drawn from a RandomState of ``seed`` (not
    from the reference's global generator, whose state depends on what
    ran before in the process), and its training run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(mx.nd, "minimum", mx.nd.broadcast_minimum, raising=False)
    try:
        net = ptb_model(mx, VOCAB, UNITS, dropout=0.0)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        _xavier_from(np.random.RandomState(seed), net)
        arrays = {n: p.data().asnumpy()
                  for n, p in net.collect_params().items()}
        return arrays, _train(mx, mx.cpu(), net)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def reference():
    return _reference_run(0)


def test_decoder_is_tied_in_both_packages():
    for lib in (mx, pt):
        net = ptb_model(lib, VOCAB, UNITS, dropout=0.0)
        assert net.decoder.weight is net.encoder.weight
        names = list(net.collect_params().keys())
        assert names.count("rnnmodel_embedding0_weight") == 1
        assert "rnnmodel_embedding0_bias" in names
    assert list(ptb_model(mx, VOCAB, UNITS).collect_params().keys()) == \
        list(ptb_model(pt, VOCAB, UNITS).collect_params().keys())


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_ptb_training_matches_reference(reference, hybridize):
    _check_against(reference, hybridize)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_ptb_training_matches_reference_at_seeds(seed):
    """Seeds 1-4 of the reference's weights, the port eager and
    hybridized, at the same tolerances as seed 0. At some seeds the
    gradient norm falls under the clip in the last steps, so these
    require the clip reached, not reached at every step."""
    ref = _reference_run(seed)
    for hybridize in (False, True):
        _check_against(ref, hybridize, every_step_clips=False)


def _check_against(reference, hybridize, every_step_clips=True):
    arrays, (r_losses, r_norms, r_params, r_hidden) = reference
    net = ptb_model(pt, VOCAB, UNITS, dropout=0.0)
    pt.params_from_numpy(net, arrays, ctx=pt.cpu())
    losses, norms, params, hidden = _train(pt, pt.cpu(), net, hybridize)
    np.testing.assert_allclose(losses, r_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, r_norms, rtol=LOSS_RTOL)
    assert (min(norms) if every_step_clips else max(norms)) > CLIP
    assert losses[-1] < losses[0]
    assert sorted(params) == sorted(r_params)
    for n in params:
        np.testing.assert_allclose(params[n], r_params[n], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)
    for h, r in zip(hidden, r_hidden):
        np.testing.assert_allclose(h, r, rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_clip_reached_and_dropout_trains():
    """At dropout 0.5 the port's step still trains (the mask drawn
    through the Dropout op), and the clip bounds the update: the norm it
    returns is the norm of the gradients it was given."""
    net = ptb_model(pt, VOCAB, UNITS, dropout=0.5)
    net.initialize(pt.initializer.Xavier(), ctx=pt.cpu())
    trainer = pt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 20.0})
    loss_fn = pt.gluon.loss.SoftmaxCrossEntropyLoss()
    data, target = _tokens(1)
    hidden = net.begin_state(batch_size=BATCH, ctx=pt.cpu())
    x, y = (pt.nd.array(a, ctx=pt.cpu()) for a in (data, target))
    loss, hidden, norm = ptb_step(pt, net, trainer, loss_fn, x, y, hidden,
                                  clip=1e-3)
    assert np.isfinite(norm) and norm > 1e-3
    grads = [p.grad() for p in net.collect_params().values()]
    clipped = np.sqrt(sum(float((g.asnumpy() ** 2).sum()) for g in grads))
    np.testing.assert_allclose(clipped, 1e-3, rtol=1e-4)
    with pt.autograd.record():
        out, _ = net(x, hidden)
    assert np.isfinite(out.asnumpy()).all()
