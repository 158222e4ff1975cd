"""The fused update in the port (``MXNET_TRAINER_FUSED_UPDATE``,
``mxnet_tpu_torch/gluon/trainer.py`` and the deferral in
``mxnet_tpu_torch/autograd.py``): the contracts of the reference's
``tests/test_trainer_fused_update.py`` on the CPU.

A hybridized MLP and loss train with the flag on and off: losses,
parameters and momentum states equal bit for bit (the port runs the same
ops in both; the reference asks for 1e-6) and equal the reference's
fused run within 1e-5 relative (f32 sums in another order over four
steps). The deferral: a plan stashed after every step but the first,
one cached plan with the update, the counters advanced once a step, a
gradient read or the next backward running the stashed plan without the
update, and no arming for anything but plain SGD. A served session over
a hybridized block answers as the eager forward does. The reference's
guard tests (``:183``, ``:204``): an enabled guard never arms, and one
installed mid-training sees the step already stashed.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu.gluon import nn as ref_nn

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import cached_op
from mxnet_tpu_torch.gluon import nn as port_nn


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    yield
    for lib in (ag, ref_ag):
        lib.disarm_fused_update()
        lib.flush_pending_step()


SHAPES = {"dense0_weight": (32, 12), "dense0_bias": (32,),
          "dense1_weight": (16, 32), "dense1_bias": (16,),
          "dense2_weight": (4, 16), "dense2_bias": (4,)}


def _weights():
    rng = np.random.RandomState(3)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in SHAPES.items()}


def _build(lib, prefix):
    nn = ref_nn if lib is mx else port_nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"))
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(4))
    arrays = {prefix + n: a for n, a in _weights().items()}
    if lib is mx:
        net.initialize()
        net(mx.nd.zeros((8, 12)))
        for n, p in net.collect_params().items():
            p.set_data(mx.nd.array(arrays[n]))
    else:
        pt.params_from_numpy(net, arrays, ctx=pt.cpu())
    return net


def _data(lib):
    rng = np.random.RandomState(0)
    return (lib.nd.array(rng.randn(8, 12).astype(np.float32), ctx=lib.cpu()),
            lib.nd.array(rng.randint(0, 4, (8,)).astype(np.float32),
                         ctx=lib.cpu()))


def _setup(lib, prefix, optimizer="sgd", opt_params=None, **hyb):
    net = _build(lib, prefix)
    net.hybridize(**(hyb or dict(static_alloc=True, static_shape=True)))
    lf = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    lf.hybridize()
    tr = lib.gluon.Trainer(net.collect_params(), optimizer,
                           opt_params or {"learning_rate": 0.1,
                                          "momentum": 0.9},
                           kvstore="device")
    return net, lf, tr


def _fwd_bwd(lib, net, lf, x, y):
    with lib.autograd.record():
        loss = lf(net(x), y)
    loss.backward()
    return loss


def _run_loop(lib, fused, monkeypatch, steps=4, momentum=0.9, wd=1e-4):
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1" if fused else "0")
    prefix = "f_" if fused else "u_"
    opt = {"learning_rate": 0.1, "wd": wd}
    if momentum:
        opt["momentum"] = momentum
    net, lf, tr = _setup(lib, prefix, opt_params=opt)
    x, y = _data(lib)
    losses = []
    for _ in range(steps):
        loss = _fwd_bwd(lib, net, lf, x, y)
        tr.step(8)
        losses.append(loss.asnumpy())
    params = {k[len(prefix):]: v.data().asnumpy()
              for k, v in net.collect_params().items()}
    updater = tr._updaters[0] if lib is mx else tr._updater
    states = {i: (s.asnumpy() if s is not None else None)
              for i, s in updater.states.items()}
    (ref_ag if lib is mx else ag).disarm_fused_update()
    return np.array(losses), params, states, tr


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_fused_update_off_path_parity(monkeypatch, momentum):
    l1, p1, s1, t1 = _run_loop(pt, True, monkeypatch, momentum=momentum)
    l2, p2, s2, t2 = _run_loop(pt, False, monkeypatch, momentum=momentum)
    assert t1._fused_armed and not t2._fused_armed
    np.testing.assert_array_equal(l1, l2)
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)
    assert s1.keys() == s2.keys()
    for i in s1:
        if s1[i] is None:
            assert s2[i] is None
        else:
            np.testing.assert_array_equal(s1[i], s2[i])
    lr, pr, _, _ = _run_loop(mx, True, monkeypatch, momentum=momentum)
    np.testing.assert_allclose(l1, lr, rtol=1e-5, atol=1e-6)
    for k in pr:
        np.testing.assert_allclose(p1[k], pr[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_fused_step_engages_and_caches_one_plan(monkeypatch):
    """After the first classic step the loop arms; every later backward
    is stashed and its step runs it through one cached plan with the
    update, never the separate multi-tensor update, kept by the
    optimizer; the counters advance once a step."""
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    net, lf, tr = _setup(pt, "e_")
    x, y = _data(pt)
    separate = []
    real = tr._optimizer.update_multi
    tr._optimizer.update_multi = lambda *a: (separate.append(1), real(*a))
    stashed = []
    for _ in range(4):
        _fwd_bwd(pt, net, lf, x, y)
        stashed.append(ag._PENDING[0] is not None)
        tr.step(8)
    assert stashed == [False, True, True, True]
    assert tr._fused_armed
    assert len(tr._optimizer.step_runners) == 1
    assert separate == [1]
    assert tr._optimizer.num_update == 4


def _two_trainers(fused, monkeypatch):
    """Two SGD Trainers without momentum, one after the other, over one
    hybridized net, at different rates and batch sizes."""
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1" if fused else "0")
    prefix = "t%d_" % fused
    net = _build(pt, prefix)
    net.hybridize(static_alloc=True, static_shape=True)
    lf = pt.gluon.loss.SoftmaxCrossEntropyLoss()
    lf.hybridize()
    x, y = _data(pt)
    losses, trainers = [], []
    for lr, batch in ((0.1, 8), (0.02, 4)):
        tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": lr}, kvstore="device")
        for _ in range(4):
            losses.append(_fwd_bwd(pt, net, lf, x, y).asnumpy())
            tr.step(batch)
        trainers.append(tr)
    ag.disarm_fused_update()
    return losses, [p.data().asnumpy()
                    for p in net.collect_params().values()], trainers


def test_each_trainer_keeps_its_own_fused_step(monkeypatch):
    """A second Trainer over the same hybridized net builds the same plan
    and the same update math as the first; its fused step is its own
    (kept by its optimizer, reading its rate and rescale), so the two
    Trainers' steps equal the separate update bit for bit."""
    got, gp, trainers = _two_trainers(True, monkeypatch)
    want, wp, _ = _two_trainers(False, monkeypatch)
    for a, b in zip(got + gp, want + wp):
        np.testing.assert_array_equal(a, b)
    a, b = (t._optimizer.step_runners for t in trainers)
    assert len(a) == len(b) == 1
    assert next(iter(a.values())) is not next(iter(b.values()))


def test_grad_read_between_backward_and_step_flushes(monkeypatch):
    """Parameter.grad() in the deferral window runs the stashed plan
    first; the step then updates as usual and the loop is where the
    unfused loop is."""
    l_ref, _, _, _ = _run_loop(pt, False, monkeypatch, steps=3, wd=0.0)
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    net, lf, tr = _setup(pt, "g_")
    x, y = _data(pt)
    _fwd_bwd(pt, net, lf, x, y)
    tr.step(8)                          # classic, then armed
    loss = _fwd_bwd(pt, net, lf, x, y)
    assert ag._PENDING[0] is not None
    g = list(net.collect_params().values())[0].grad()
    assert ag._PENDING[0] is None       # run by the read
    assert np.isfinite(g.asnumpy()).all() and np.abs(g.asnumpy()).max() > 0
    tr.step(8)                          # the classic update
    np.testing.assert_array_equal(loss.asnumpy(), l_ref[1])
    loss = _fwd_bwd(pt, net, lf, x, y)
    np.testing.assert_array_equal(loss.asnumpy(), l_ref[2])


def test_ndarray_grad_read_flushes(monkeypatch):
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    net, lf, tr = _setup(pt, "n_")
    x, y = _data(pt)
    _fwd_bwd(pt, net, lf, x, y)
    tr.step(8)
    _fwd_bwd(pt, net, lf, x, y)
    assert ag._PENDING[0] is not None
    assert net[0].weight.data().grad is not None
    assert ag._PENDING[0] is None


def test_unconsumed_plan_flushes_on_next_backward(monkeypatch):
    """A loop that breaks after backward() (no step) keeps its
    gradients: the next backward runs the stashed plan first, then
    stashes its own."""
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    net, lf, tr = _setup(pt, "h_")
    x, y = _data(pt)
    _fwd_bwd(pt, net, lf, x, y)
    tr.step(8)
    _fwd_bwd(pt, net, lf, x, y)
    first = ag._PENDING[0]
    assert first is not None
    _fwd_bwd(pt, net, lf, x * 2, y)
    assert ag._PENDING[0] is not None and ag._PENDING[0] is not first
    # the first plan's gradients were written when it ran
    grads = [p.grad().asnumpy() for p in net.collect_params().values()]
    assert all(np.isfinite(g).all() for g in grads)
    tr.step(8)


@pytest.mark.parametrize("optimizer,opt_params,hyb", [
    ("adam", {"learning_rate": 1e-3}, None),
    ("lamb", {"learning_rate": 1e-3}, None),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True}, None),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, "add")])
def test_ineligible_trainers_never_arm(monkeypatch, optimizer, opt_params,
                                       hyb):
    """Only plain SGD without masters, with every grad_req write (or
    null), arms; the others keep the separate update, and their steps
    equal the same steps with the flag off."""
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", flag)
        net, lf, tr = _setup(pt, "j%s_" % flag, optimizer, opt_params)
        if hyb == "add":
            for p in net.collect_params().values():
                p.grad_req = "add"
        x, y = _data(pt)
        for _ in range(2):
            _fwd_bwd(pt, net, lf, x, y)
            assert ag._PENDING[0] is None
            tr.step(8)
        assert not tr._fused_armed
        out[flag] = [p.data().asnumpy()
                     for p in net.collect_params().values()]
    for a, b in zip(out["1"], out["0"]):
        np.testing.assert_array_equal(a, b)


def test_fused_backward_off_runs_node_by_node(monkeypatch):
    """MXNET_FUSED_BACKWARD=0: no plan, no deferral (the Trainer does not
    arm), each node's own backward; the gradients equal the plan's."""
    grads = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_FUSED_BACKWARD", flag)
        net, lf, tr = _setup(pt, "b%s_" % flag)
        x, y = _data(pt)
        plans = []
        real = cached_op._tape_fn
        monkeypatch.setattr(cached_op, "_tape_fn",
                            lambda *a: (plans.append(1), real(*a)))
        _fwd_bwd(pt, net, lf, x, y)
        monkeypatch.setattr(cached_op, "_tape_fn", real)
        assert len(plans) == (flag == "1")
        tr.step(8)
        assert tr._fused_armed is (flag == "1")
        _fwd_bwd(pt, net, lf, x, y)
        grads[flag] = [p.grad().asnumpy()
                       for p in net.collect_params().values()]
    for a, b in zip(grads["1"], grads["0"]):
        np.testing.assert_array_equal(a, b)


def test_scan_steps_still_refused(monkeypatch):
    """K-step scan is ported; what stays refused is scan over several
    devices: MXNET_ZERO beside MXNET_SCAN_STEPS raises naming item 11
    (the reference's red test_replicated_and_zero_paths_fall_back)."""
    net, lf, tr = _setup(pt, "s_")
    monkeypatch.setenv("MXNET_SCAN_STEPS", "4")
    monkeypatch.setenv("MXNET_ZERO", "1")
    with pytest.raises(NotImplementedError, match="item 11"):
        tr.step(8)


def test_served_hybridized_session_equals_eager_forward():
    """InferenceSession over a hybridized block (its buckets run the
    CachedOp's eval path) against the same block's eager forward on the
    same padded inputs, bit for bit, and the reference's session within
    f32 tolerance."""
    x = np.random.RandomState(5).randn(3, 12).astype(np.float32)
    net = _build(pt, "s_")
    net.hybridize(static_alloc=True, static_shape=True)
    sess = net.serve_session(pt.nd.array(x, ctx=pt.cpu()), max_batch=4)
    got = sess.infer(x)
    assert net._cached_op is not None
    padded = np.zeros((4, 12), np.float32)
    padded[:3] = x
    with cached_op.eager():
        want = net(pt.nd.array(padded, ctx=pt.cpu())).asnumpy()[:3]
    np.testing.assert_array_equal(got, want)
    ref = _build(mx, "s_")
    ref_sess = ref.serve_session(mx.nd.array(x), max_batch=4)
    np.testing.assert_allclose(got, ref_sess.infer(x), rtol=1e-5,
                               atol=1e-6)
    # weights are live: a set_data in place is seen by the next request
    w = net[2].weight
    w.set_data(w.data().asnumpy() * 2)
    again = sess.infer(x)
    with cached_op.eager():
        want2 = net(pt.nd.array(padded, ctx=pt.cpu())).asnumpy()[:3]
    np.testing.assert_array_equal(again, want2)
    assert not np.array_equal(again, got)


@pytest.mark.parametrize("lib", ["ref", "port"])
def test_guard_disables_fused_update(monkeypatch, lib):
    """An enabled guard needs the gradients on the host before the
    update: the fused path never arms (reference :183), in both
    packages."""
    lib = mx if lib == "ref" else pt
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    monkeypatch.setenv("MXNET_GUARD_NONFINITE", "skip_step")
    net, lf, tr = _setup(lib, "gd_")
    x, y = _data(lib)
    for _ in range(2):
        _fwd_bwd(lib, net, lf, x, y)
        tr.step(8)
    assert not tr._fused_armed
    assert tr.grad_guard.steps == 2 and tr.grad_guard.sync_count == 2


@pytest.mark.parametrize("lib", ["ref", "port"])
def test_guard_installed_mid_training_not_bypassed(monkeypatch, lib):
    """Eligibility is checked again when the stashed step is consumed: a
    guard installed after the loop armed sees the very next step (the
    stashed plan runs without the update, the classic guard pass runs;
    reference :204), and the parameters equal the reference's."""
    libs = {"ref": mx, "port": pt}
    got = {}
    for name in ("ref", "port"):
        if name != lib and lib != "port":
            continue
        m = libs[name]
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
        monkeypatch.delenv("MXNET_GUARD_NONFINITE", raising=False)
        net, lf, tr = _setup(m, "gm_")
        x, y = _data(m)
        for _ in range(2):
            _fwd_bwd(m, net, lf, x, y)
            tr.step(8)
        assert tr._fused_armed
        _fwd_bwd(m, net, lf, x, y)
        assert (ref_ag if m is mx else ag)._PENDING[0] is not None
        monkeypatch.setenv("MXNET_GUARD_NONFINITE", "skip_step")
        tr.grad_guard = m.guardrails.from_env()
        checked = []
        orig_check = tr.grad_guard.check
        tr.grad_guard.check = lambda *a, **k: (checked.append(1),
                                               orig_check(*a, **k))[1]
        tr.step(8)
        assert checked, "guard bypassed by the stashed fused plan"
        assert not tr._fused_armed
        got[name] = [p.data().asnumpy()
                     for p in net.collect_params().values()]
        (ref_ag if m is mx else ag).disarm_fused_update()
    if lib == "port":
        for a, b in zip(got["port"], got["ref"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
