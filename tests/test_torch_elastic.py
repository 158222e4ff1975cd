"""Elastic training in the port (``mxnet_tpu_torch/elastic.py``,
``Estimator.fit`` under ``MXNET_ELASTIC``) against the contracts of the
reference's ``docs/ELASTIC.md`` and ``mxnet_tpu/elastic.py``: each notice
source, the transition's ``"live"`` and ``"restored"`` outcomes, and a
fit preempted from 4 ``cpu(i)`` contexts to 2 that equals, bit for bit,
a fit that runs the rest on 2 from the same state (the live move's, or
the restored checkpoint's).
"""
import os
import signal

import numpy as np
import pytest

from mxnet_tpu import elastic as ref_elastic
import mxnet_tpu_torch as pt
from mxnet_tpu_torch import elastic
from mxnet_tpu_torch.gluon import zero as zero_mod


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    elastic.clear()
    pt.faultinject.clear()
    pt.telemetry.refresh()
    with pt.cpu():                  # the DataLoader stages to the CPU
        yield
    elastic.clear()
    pt.faultinject.clear()
    for var in ("MXNET_ZERO",):
        os.environ.pop(var, None)
    pt.telemetry.refresh()
    pt.telemetry.reset()


def _cpus(n):
    return [pt.cpu(i) for i in range(n)]


def test_public_surface_matches_the_reference():
    assert sorted(elastic.__all__) == sorted(ref_elastic.__all__)
    assert elastic.KV_KEY == ref_elastic.KV_KEY


# ---------------------------------------------------------------------------
# the notice sources
# ---------------------------------------------------------------------------
def test_programmatic_notice_is_consumed_once():
    ctxs = _cpus(4)
    assert elastic.poll_survivors(ctxs) is None
    elastic.request_preemption([0, 2])
    assert elastic.pending()
    assert elastic.poll_survivors(ctxs) == [ctxs[0], ctxs[2]]
    assert not elastic.pending() and elastic.poll_survivors(ctxs) is None
    elastic.request_preemption(3)
    assert elastic.poll_survivors(ctxs) == ctxs[:3]
    elastic.request_preemption("half")
    assert elastic.poll_survivors(ctxs) == ctxs[:2]
    for bad in ("0,9", "-1", "x", ","):
        elastic.request_preemption(bad)
        assert elastic.poll_survivors(ctxs) is None, bad
    # the specs parse as the reference's do
    for spec in ("half", "3", "0,2", "7"):
        assert ref_elastic._parse_spec(spec, list(range(4))) == \
            elastic._parse_spec(spec, list(range(4)))


def test_slice_preempt_site_keeps_the_front_half():
    ctxs = _cpus(4)
    pt.faultinject.set_fault("slice_preempt", 1.0, 1)
    assert elastic.poll_survivors(ctxs) == ctxs[:2]
    assert elastic.poll_survivors(ctxs) is None       # its budget: 1
    assert pt.faultinject.fires("slice_preempt") == 1


def test_sigterm_is_opt_in_and_lock_free():
    """No handler until asked (fit installs it only under
    MXNET_ELASTIC_SIGTERM); installed, a SIGTERM raises the notice with
    the front half surviving."""
    ctxs = _cpus(4)
    before = signal.getsignal(signal.SIGTERM)
    elastic._SIGTERM_INSTALLED[0] = False
    try:
        # a previous handler that is not callable: the signal only sets
        # the flag here
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        elastic.install_sigterm_handler()
        handler = signal.getsignal(signal.SIGTERM)
        assert callable(handler)
        elastic.install_sigterm_handler()              # idempotent
        assert signal.getsignal(signal.SIGTERM) is handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert elastic.pending()
        assert elastic.poll_survivors(ctxs) == ctxs[:2]
        assert not elastic.pending()
    finally:
        signal.signal(signal.SIGTERM, before)
        elastic._SIGTERM_INSTALLED[0] = False


def test_kv_notice_through_the_group_store(monkeypatch):
    """announce posts on the process group's store; a poll consumes the
    notice (deleted), the same spec never fires twice, a new one does."""
    kv = pt.dist.LocalKV()
    monkeypatch.setattr(pt.dist, "_coord_client", lambda: kv)
    ctxs = _cpus(4)
    assert elastic.announce("0,1,2")
    assert elastic.poll_survivors(ctxs) == ctxs[:3]
    assert elastic.poll_survivors(ctxs) is None
    assert elastic.announce("0,1,2")                  # a stale repost
    assert elastic.poll_survivors(ctxs) is None
    assert elastic.announce("1")
    assert elastic.poll_survivors(ctxs) == ctxs[:1]
    monkeypatch.setattr(pt.dist, "_coord_client", lambda: None)
    assert not elastic.announce("1")


# ---------------------------------------------------------------------------
# run_transition
# ---------------------------------------------------------------------------
class _Tr:
    def __init__(self, fail=False):
        self.fail, self.moved = fail, None

    def reshard_to(self, survivors):
        if self.fail:
            raise pt.parallel.reshard.ReshardError("planted")
        self.moved = list(survivors)


def test_run_transition_live_restored_and_minimum(monkeypatch):
    restored = []
    tr = _Tr()
    assert elastic.run_transition(tr, [1, 2], restored.append) == "live"
    assert tr.moved == [1, 2] and not restored
    tr = _Tr(fail=True)
    assert elastic.run_transition(tr, [1], restored.append) == "restored"
    assert restored == [[1]]
    monkeypatch.setenv("MXNET_ELASTIC_MIN_DEVICES", "3")
    tr = _Tr()
    assert elastic.run_transition(tr, [1, 2], restored.append) == \
        "restored"
    assert tr.moved is None
    with pytest.raises(pt.MXNetError, match="no checkpoint-restore"):
        elastic.run_transition(_Tr(fail=True), [1, 2, 3], None)


# ---------------------------------------------------------------------------
# Estimator.fit, preempted from 4 contexts to 2
# ---------------------------------------------------------------------------
_W = np.random.RandomState(13).randn(3, 4).astype(np.float32)


def _setup(ctxs, prefix):
    net = pt.gluon.nn.Dense(3, in_units=4, prefix=prefix)
    net.initialize(ctx=list(ctxs))
    net.weight.set_data(pt.nd.array(_W, ctx=pt.cpu()))
    tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9})
    est = pt.gluon.contrib.estimator.Estimator(
        net, pt.gluon.loss.L2Loss(), train_metrics=[pt.metric.MSE()],
        trainer=tr, context=list(ctxs))
    return net, tr, est


def _loader(lo=0, hi=32):
    rng = np.random.RandomState(0)
    X = rng.randn(32, 4).astype(np.float32)
    Y = (X @ rng.randn(4, 3)).astype(np.float32)
    return pt.gluon.data.DataLoader(
        pt.gluon.data.ArrayDataset(X[lo:hi], Y[lo:hi]), batch_size=8)


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._structural_params().items()}


@pytest.mark.parametrize("kind", ["live", "restored"])
@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_fit_preempted_4_to_2_equals_a_resumed_fit(zero, kind, tmp_path,
                                                  monkeypatch):
    """Two epochs of 4 batches; the slice_preempt site fires at step 6
    (poll every 6 steps) and the front half survives. Live: the run
    moves onto cpu(0), cpu(1) and its last two batches equal a fit on
    those two from the state after step 6. Restored (reshard_fail
    armed): the newest checkpoint (epoch 1) is restored onto the two and
    the last two batches equal a fit resumed there."""
    monkeypatch.setenv("MXNET_ZERO", "1" if zero else "0")
    ctxs = _cpus(4)
    net, tr, est = _setup(ctxs, "a_")
    monkeypatch.setenv("MXNET_ELASTIC", "1")
    monkeypatch.setenv("MXNET_ELASTIC_POLL", "6")
    pt.faultinject.set_fault("slice_preempt", 1.0, 1)
    if kind == "restored":
        pt.faultinject.set_fault("reshard_fail", 1.0)
    est.fit(_loader(), epochs=2, ckpt_prefix=str(tmp_path / "el"))
    assert tr._contexts == ctxs[:2]
    assert isinstance(tr._zero, zero_mod.ZeroEngine) == zero
    pt.faultinject.clear()
    monkeypatch.setenv("MXNET_ELASTIC", "0")

    # the control: 4 contexts up to the state the transition started
    # from, then 2 contexts for the rest
    net_c, tr_c, est_c = _setup(ctxs, "b_")
    est_c.fit(_loader(), epochs=1, ckpt_prefix=str(tmp_path / "ctl"))
    if kind == "live":
        est_c.fit(_loader(0, 16), epochs=1)
        state = (_params(net_c), tr_c.states_blob())
    net2, tr2, est2 = _setup(ctxs[:2], "c_")
    if kind == "live":
        est2._restore_arg_params({k: pt.nd.array(v, ctx=pt.cpu())
                                  for k, v in state[0].items()})
        tr2.load_states_blob(state[1])
    else:
        assert est2.resume_from(str(tmp_path / "ctl")) == 1
    est2.fit(_loader(16, 32), epochs=1)
    got, want = _params(net), _params(net2)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert isinstance(tr2._zero, zero_mod.ZeroEngine) == zero
    # the checkpoint written after the move carries the new layout
    sec = pt.model.checkpoint_sharding(str(tmp_path / "el"), 2)
    assert sec["n_devices"] == 2
    assert sec["layout"] == ("zero" if zero else "replicated")
