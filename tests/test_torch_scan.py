"""K-step whole-loop compilation in the port (``MXNET_SCAN_STEPS``,
``mxnet_tpu_torch/scan.py``): the contracts of the reference's
``tests/test_scan.py`` on the CPU, each against the reference's run.

The same MLP (two Dense layers and an L2 loss, hybridized) starts from
the same numpy weights in both packages and trains on the same batches.
The port at K = 8 (or 4) equals the port at K = 1 bit for bit (losses,
parameters, momenta: the chunk runs the per-step math, on the CPU
eagerly) and the reference's scanned run within ``RTOL``/``ATOL`` (f32
sums in another order, as ``tests/test_torch_fused_update.py`` holds
the fused step). The guard's counters, ``sync_count`` and events equal
the reference's. The runner's ``retired_chunks`` and the per-step
forward calls stand in for the reference's compilewatch count; on the
card the chunk is one captured graph (``tests/test_torch_cuda.py``).

What the port adds, each pinned here: a schedule's lr with a step
skipped inside a chunk (the port's skipped step advances no counter, as
per step; the reference's does), an eager op between forward and
backward and a read between backward and step (both force), a gradient
read mid-chunk, the BatchNorm rung, and the ``scaled_grad`` site.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as ref_ag
from mxnet_tpu.gluon import nn as ref_nn

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch import cached_op, faultinject, guardrails, scan
from mxnet_tpu_torch.gluon import nn as port_nn

RTOL, ATOL = 1e-5, 1e-6

SHAPES = {"dense0_weight": (16, 6), "dense0_bias": (16,),
          "dense1_weight": (3, 16), "dense1_bias": (3,)}

_RS = np.random.RandomState(7)
_X = _RS.randn(40, 4, 6).astype(np.float32)
_Y = _RS.randn(40, 4, 3).astype(np.float32)


@pytest.fixture(autouse=True)
def _scan_env(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    faultinject.reset()
    mx.faultinject.reset()
    yield
    for lib in (ag, ref_ag):
        lib.flush_all_pending()
        lib.disarm_fused_update()
        lib.flush_pending_step()
    faultinject.reset()
    mx.faultinject.reset()


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.4).astype(np.float32)
            for n, s in SHAPES.items()}


def _build(lib, prefix, opt="sgd", opt_kw=None, guard=None, seed=0):
    nn = ref_nn if lib is mx else port_nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu", in_units=6))
        net.add(nn.Dense(3, in_units=16))
    arrays = {prefix + n: a for n, a in _weights(seed).items()}
    if lib is mx:
        net.initialize()
        for n, p in net.collect_params().items():
            p.set_data(mx.nd.array(arrays[n]))
    else:
        pt.params_from_numpy(net, arrays, ctx=pt.cpu())
    net.hybridize(static_alloc=True, static_shape=True)
    lf = lib.gluon.loss.L2Loss()
    lf.hybridize(static_alloc=True, static_shape=True)
    kw = dict(opt_kw or {"learning_rate": 0.05, "momentum": 0.9,
                         "wd": 1e-4})
    tr = lib.gluon.Trainer(net.collect_params(), opt, kw, kvstore=None)
    if guard is not None:
        tr.grad_guard = guard
    return net, lf, tr


def _arr(lib, a):
    return lib.nd.array(a, ctx=lib.cpu()) if lib is pt else lib.nd.array(a)


def _drive(lib, net, lf, tr, steps, start=0, hook=None):
    losses = []
    for i in range(start, start + steps):
        with lib.autograd.record():
            loss = lf(net(_arr(lib, _X[i])), _arr(lib, _Y[i]))
        loss.backward()
        tr.step(4)
        losses.append(loss)
        if hook is not None:
            hook(i, loss)
    return losses


def _params(lib, net, prefix):
    lib.autograd.flush_all_pending()
    return {k.replace(prefix, ""): p.data().asnumpy()
            for k, p in net.collect_params().items()}


def _states(lib, tr):
    lib.autograd.flush_all_pending()
    upd = tr._updaters[0] if lib is mx else tr._updater
    return {i: (s.asnumpy() if s is not None else None)
            for i, s in upd.states.items()}


def _run(lib, monkeypatch, k, prefix, steps=17, **bkw):
    monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
    net, lf, tr = _build(lib, prefix, **bkw)
    losses = _drive(lib, net, lf, tr, steps)
    return (_params(lib, net, prefix), _states(lib, tr),
            [l.asnumpy() for l in losses], tr)


def _equal(a, b):
    assert set(a) == set(b)
    for n in a:
        if a[n] is None:
            assert b[n] is None
        else:
            assert np.array_equal(a[n], b[n]), n


def _close(a, b):
    assert set(a) == set(b)
    for n in a:
        if a[n] is not None:
            np.testing.assert_allclose(a[n], b[n], rtol=RTOL, atol=ATOL,
                                       err_msg=str(n))


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_scan_bitwise_parity(monkeypatch, momentum):
    """K=8 == K=1 bit for bit after 17 steps (one arming step, two
    chunks, a tail drained by the read), and the reference's K=8 run
    within f32 tolerance."""
    kw = {"learning_rate": 0.05, "momentum": momentum, "wd": 1e-4}
    tag = int(momentum * 10)
    p1, s1, l1, _ = _run(pt, monkeypatch, 1, "sp1%d_" % tag, opt_kw=kw)
    p8, s8, l8, tr8 = _run(pt, monkeypatch, 8, "sp8%d_" % tag, opt_kw=kw)
    _equal(p1, p8)
    _equal(s1, s8)
    for a, b in zip(l1, l8):
        assert np.array_equal(a, b)
    assert tr8._scan.retired_chunks == 2
    rp, rs, rl, _ = _run(mx, monkeypatch, 8, "sr8%d_" % tag, opt_kw=kw)
    _close(p8, rp)
    _close(s8, rs)
    for a, b in zip(l8, rl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_scan_engages_and_retires_chunks(monkeypatch):
    """After the classic arming step the runner buffers and retires
    whole chunks; the read drains the tail per step; the counts are the
    reference's."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "4")
    got = {}
    for lib in (pt, mx):
        net, lf, tr = _build(lib, "se_")
        _drive(lib, net, lf, tr, 11)   # 1 classic + 2 chunks + 2 buffered
        runner = tr._scan
        assert runner is not None and not runner.bailed
        buffered = (lambda: runner.plans) if lib is mx else \
            (lambda: runner.steps)
        got[lib] = [runner.retired_chunks, len(buffered())]
        lib.autograd.flush_all_pending()
        got[lib] += [len(buffered()), runner.flushed_steps,
                     tr._optimizer.num_update]
    assert got[pt] == got[mx] == [2, 2, 0, 2, 11]


def test_scan_one_program_and_k_step_credit(monkeypatch):
    """One chunk function serves every retired chunk: after the arming
    step no per-step forward runs (the reference counts one compiled
    program by compilewatch; the port counts the runner's chunks and the
    CachedOps' own calls), and the 13 steps are all taken."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "4")
    eager, chunks = [], []
    real_eager, real_chunk = cached_op.CachedOp._eager, \
        scan.ChunkRunner._chunk
    monkeypatch.setattr(cached_op.CachedOp, "_eager",
                        lambda *a, **k: (eager.append(1),
                                         real_eager(*a, **k))[1])
    monkeypatch.setattr(scan.ChunkRunner, "_chunk",
                        lambda *a, **k: (chunks.append(a[1]),
                                         real_chunk(*a, **k))[1])
    net, lf, tr = _build(pt, "sc_")
    _drive(pt, net, lf, tr, 13)         # 1 classic + 3 chunks, no tail
    ag.flush_all_pending()
    assert len(eager) == 2              # the arming step's two calls
    assert chunks == [4, 4, 4]
    assert tr._scan.retired_chunks == 3 and tr._scan.flushed_steps == 0
    assert tr._optimizer.num_update == 13
    ref_net, ref_lf, ref_tr = _build(mx, "sc_")
    _drive(mx, ref_net, ref_lf, ref_tr, 13)
    ref_ag.flush_all_pending()
    assert ref_tr._scan.retired_chunks == 3
    assert ref_tr._optimizer.num_update == 13


def _guarded(lib, monkeypatch, k, prefix, plant=4, steps=14,
             site="nan_grad", opt_kw=None):
    monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
    fi = faultinject if lib is pt else mx.faultinject
    gr = guardrails if lib is pt else mx.guardrails
    fi.reset()
    guard = gr.GradGuard(nonfinite="skip_step")
    net, lf, tr = _build(lib, prefix, guard=guard, opt_kw=opt_kw)
    events = []
    unsub = gr.on_event(events.append)

    def hook(i, _loss):
        if i == plant:   # armed after step 4's draw: fires at step 5
            fi.set_fault(site, 1.0, max_fires=1)
    try:
        losses = _drive(lib, net, lf, tr, steps, hook=hook)
        p = _params(lib, net, prefix)
    finally:
        unsub()
        fi.reset()
    evs = [(e["kind"], [n.replace(prefix, "") for n in e["params"]],
            e["step"]) for e in events]
    return p, [l.asnumpy() for l in losses], guard, evs, tr


def test_guard_skip_inside_chunk_bitwise(monkeypatch):
    """A nan_grad fault inside a chunk: the select in the chunk drops
    exactly that step's update, the guard's counters replay at the
    boundary, bit for bit with the per-step guarded run at fewer host
    reads; counters, reads and events equal the reference's."""
    p1, l1, g1, e1, _ = _guarded(pt, monkeypatch, 1, "gi1_")
    p8, l8, g8, e8, _ = _guarded(pt, monkeypatch, 8, "gi8_")
    _equal(p1, p8)
    for a, b in zip(l1, l8):
        assert np.array_equal(a, b)
    for v in p8.values():
        assert np.isfinite(v).all()
    assert g1.skipped_steps == g8.skipped_steps == 1
    assert g1.nonfinite_steps == g8.nonfinite_steps == 1
    assert g1.steps == g8.steps
    assert g8.sync_count < g1.sync_count
    # 1 arming step + 1 chunk + the 5-step tail at its own length
    assert (g1.sync_count, g8.sync_count) == (14, 3)
    assert e1 == e8 and [k for k, _, _ in e8] == ["nonfinite", "skip"]
    rp, _, rg, re, _ = _guarded(mx, monkeypatch, 8, "gir_")
    _close(p8, rp)
    assert (rg.skipped_steps, rg.nonfinite_steps, rg.steps,
            rg.sync_count) == (g8.skipped_steps, g8.nonfinite_steps,
                               g8.steps, g8.sync_count)
    assert re == e8


def test_guard_skip_inside_chunk_with_schedule(monkeypatch):
    """With a PolyScheduler the lr moves every step: the steps after a
    skip inside a chunk take the lr of the count the per-step path has
    (a skipped step advances no counter), bit for bit with K=1, and the
    counters end equal. (The reference advances the counter of a step
    skipped inside its chunk, so its two paths part here.)"""
    def kw():
        return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
                "lr_scheduler": pt.lr_scheduler.PolyScheduler(
                    max_update=30, base_lr=0.05, warmup_steps=2, pwr=1)}
    p1, l1, g1, _, t1 = _guarded(pt, monkeypatch, 1, "gs1_", opt_kw=kw())
    p4, l4, g4, _, t4 = _guarded(pt, monkeypatch, 4, "gs4_", opt_kw=kw())
    _equal(p1, p4)
    for a, b in zip(l1, l4):
        assert np.array_equal(a, b)
    assert g4.skipped_steps == 1
    assert t1._optimizer.num_update == t4._optimizer.num_update == 13
    assert t1._optimizer._index_update_count == \
        t4._optimizer._index_update_count


def test_scaled_grad_inside_chunk_bitwise(monkeypatch):
    """The scaled_grad site, drawn at push and applied in the chunk: a
    finite, exploding last gradient that skip_step lets through, bit for
    bit with the per-step guarded run."""
    p1, l1, g1, _, _ = _guarded(pt, monkeypatch, 1, "sg1_",
                                site="scaled_grad")
    p4, l4, g4, _, _ = _guarded(pt, monkeypatch, 4, "sg4_",
                                site="scaled_grad")
    _equal(p1, p4)
    # the blown-up layer makes later gradients overflow: skipped alike
    assert g1.skipped_steps == g4.skipped_steps
    assert g1.nonfinite_steps == g4.nonfinite_steps
    assert g1.steps == g4.steps == 14


def test_checkpoint_mid_chunk_flushes_bitwise(monkeypatch):
    """states_blob() inside a chunk drains it first: the blob equals the
    per-step run's at the same step, byte for byte, and the run keeps
    its parity after; the reference's blob loads into the port."""
    def run(lib, k, prefix):
        monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
        net, lf, tr = _build(lib, prefix)
        blob = {}

        def hook(i, _loss):
            if i == 10:              # strictly inside chunk 2
                blob["b"] = tr.states_blob()
        _drive(lib, net, lf, tr, 15, hook=hook)
        return _params(lib, net, prefix), blob["b"], tr

    p1, b1, _ = run(pt, 1, "ck1_")
    p8, b8, tr8 = run(pt, 8, "ck8_")
    assert b1 == b8
    _equal(p1, p8)
    rp, rb, _ = run(mx, 8, "ckr_")
    _close(p8, rp)
    tr8.load_states_blob(b8)
    mine = _states(pt, tr8)
    tr8.load_states_blob(rb)
    _close(mine, _states(pt, tr8))


def test_loss_read_forces_chunk_then_bails(monkeypatch, caplog):
    """Reading each step's loss drains the chunk so the value is exact;
    after three forces in a row the runner bails with one warning and
    the loop runs per step, bit for bit with K=1 (and with the
    reference's K=8 run within tolerance)."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "8")
    net, lf, tr = _build(pt, "fr_")
    losses8 = []
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.scan"):
        _drive(pt, net, lf, tr, 12,
               hook=lambda i, l: losses8.append(l.asnumpy().copy()))
    assert tr._scan is not None and tr._scan.bailed
    bails = [r for r in caplog.records
             if "read every chunk" in r.getMessage()]
    assert len(bails) == 1
    p8 = _params(pt, net, "fr_")
    monkeypatch.setenv("MXNET_SCAN_STEPS", "1")
    net1, lf1, tr1 = _build(pt, "fr1_")
    losses1 = []
    _drive(pt, net1, lf1, tr1, 12,
           hook=lambda i, l: losses1.append(l.asnumpy().copy()))
    _equal(_params(pt, net1, "fr1_"), p8)
    for a, b in zip(losses8, losses1):
        assert np.array_equal(a, b)
    monkeypatch.setenv("MXNET_SCAN_STEPS", "8")
    rnet, rlf, rtr = _build(mx, "frr_")
    rl = []
    _drive(mx, rnet, rlf, rtr, 12,
           hook=lambda i, l: rl.append(l.asnumpy().copy()))
    assert rtr._scan.bailed
    _close(p8, _params(mx, rnet, "frr_"))
    for a, b in zip(losses8, rl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_eager_op_between_forward_and_backward_forces(monkeypatch,
                                                      caplog):
    """An eager op on a deferred output forces its step (the reference
    defers eager registry ops too; the port does not, ROADMAP.md queue
    3): the loop goes down the force-streak rung, bit for bit with
    K=1."""
    def drive(k, prefix):
        monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
        net, lf, tr = _build(pt, prefix)
        for i in range(8):
            with pt.autograd.record():
                loss = lf(net(_arr(pt, _X[i])), _arr(pt, _Y[i]))
                seen.append(loss.mean())     # an eager op
            loss.backward()
            tr.step(4)
        return _params(pt, net, prefix), tr
    seen = []
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.scan"):
        p4, tr4 = drive(4, "eo4_")
    p1, _ = drive(1, "eo1_")
    _equal(p1, p4)
    assert tr4._scan.bailed and tr4._scan.retired_chunks == 0
    assert len([r for r in caplog.records
                if "read every chunk" in r.getMessage()]) == 1


def test_read_between_backward_and_step_forces(monkeypatch):
    """A stashed step's loss read before step(): the step's calls run for
    real, the step is taken per step, bit for bit with K=1; a gradient
    read inside a chunk drains it, also bit for bit."""
    def drive(k, prefix):
        monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
        net, lf, tr = _build(pt, prefix)
        seen = []
        for i in range(11):
            with pt.autograd.record():
                loss = lf(net(_arr(pt, _X[i])), _arr(pt, _Y[i]))
            loss.backward()
            if i == 6:
                seen.append(loss.asnumpy())
            if i == 8:
                seen.append(net[0].weight.grad().asnumpy())
            tr.step(4)
        return _params(pt, net, prefix), seen, tr
    p1, s1, _ = drive(1, "rb1_")
    p4, s4, tr4 = drive(4, "rb4_")
    _equal(p1, p4)
    for a, b in zip(s1, s4):
        assert np.array_equal(a, b)
    assert not tr4._scan.bailed


def test_batchnorm_template_not_buffered(monkeypatch, caplog):
    """A forward that writes auxiliary state (BatchNorm's moving
    statistics) is not buffered: one warning, then the per-step fused
    path, bit for bit with K=1."""
    def drive(k, prefix):
        monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
        net = port_nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(port_nn.Dense(8, in_units=6))
            net.add(port_nn.BatchNorm(in_channels=8))
            net.add(port_nn.Dense(3, in_units=8))
        net.initialize(ctx=pt.cpu())
        rng = np.random.RandomState(2)
        for _, p in sorted(net.collect_params().items()):
            p.set_data(pt.nd.array(rng.rand(*p.shape).astype(np.float32),
                                   ctx=pt.cpu()))
        net.hybridize(static_alloc=True, static_shape=True)
        lf = pt.gluon.loss.L2Loss()
        lf.hybridize(static_alloc=True, static_shape=True)
        tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        _drive(pt, net, lf, tr, 6)
        return _params(pt, net, prefix), tr
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.scan"):
        p4, tr4 = drive(4, "bn4_")
    p1, _ = drive(1, "bn1_")
    _equal(p1, p4)
    assert tr4._scan.bailed and tr4._fused_armed
    assert len([r for r in caplog.records
                if "auxiliary state" in r.getMessage()]) == 1


def test_eligibility_adam_stays_per_step(monkeypatch, caplog):
    """Adam has no in-graph update: the loop never arms, never scans,
    and says so once, as the reference's does."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "8")
    for lib, logger in ((pt, "mxnet_tpu_torch.scan"),
                        (mx, "mxnet_tpu.scan")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            net, lf, tr = _build(lib, "ad_", opt="adam",
                                 opt_kw={"learning_rate": 1e-3})
            _drive(lib, net, lf, tr, 4)
        assert tr._scan is None
        assert not tr._fused_armed
        warns = [r for r in caplog.records
                 if "not scan-eligible" in r.getMessage()]
        assert len(warns) == 1
        assert tr._optimizer.num_update == 4


def test_eligibility_guard_zero_policy_stays_per_step(monkeypatch):
    """Only skip_step has a form in the chunk; a zero-policy guard runs
    the classic per-step pass, one host read a step, in both
    packages."""
    monkeypatch.setenv("MXNET_SCAN_STEPS", "8")
    got = {}
    for lib in (pt, mx):
        gr = guardrails if lib is pt else mx.guardrails
        guard = gr.GradGuard(nonfinite="zero")
        net, lf, tr = _build(lib, "gz_", guard=guard)
        _drive(lib, net, lf, tr, 6)
        assert tr._scan is None
        assert guard.sync_count == guard.steps == 6
        got[lib] = _params(lib, net, "gz_")
        for name, v in got[lib].items():
            assert np.isfinite(v).all(), name
    _close(got[pt], got[mx])


def test_scan_off_by_default(monkeypatch):
    """MXNET_SCAN_STEPS unset: no runner is made and the per-step fused
    path is untouched."""
    monkeypatch.delenv("MXNET_SCAN_STEPS", raising=False)
    net, lf, tr = _build(pt, "off_")
    losses = _drive(pt, net, lf, tr, 4)
    assert tr._scan is None
    assert tr._fused_armed
    assert all(l._pending is None for l in losses)


def test_replicated_and_zero_paths_fall_back(monkeypatch):
    """The reference's multi-device scan test: a Trainer over several
    contexts (replicated or MXNET_ZERO) never arms the fused update, so
    K > 1 runs its per-step path unchanged and K = 8 equals K = 1 bit
    for bit; the ZeRO run shards (item 11, ported), and both equal the
    reference's replicated run within its tolerance."""
    w = [np.random.RandomState(3).randn(*s).astype(np.float32) * 0.3
         for s in ((8, 6), (8,), (3, 8), (3,))]

    def run(k, prefix, zero, lib=pt):
        monkeypatch.setenv("MXNET_SCAN_STEPS", str(k))
        monkeypatch.setenv("MXNET_ZERO", "1" if zero else "0")
        nn = ref_nn if lib is mx else port_nn
        cs = [lib.cpu(i) for i in range(2)]
        net = nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(nn.Dense(8, activation="relu", in_units=6))
            net.add(nn.Dense(3, in_units=8))
        net.initialize(ctx=cs)
        for p, a in zip(net.collect_params().values(), w):
            p.set_data(_arr(lib, a))
        net.hybridize(static_alloc=True, static_shape=True)
        lf = lib.gluon.loss.L2Loss()
        tr = lib.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
        for i in range(5):
            xs = lib.gluon.utils.split_and_load(_arr(lib, _X[i]), cs)
            ys = lib.gluon.utils.split_and_load(_arr(lib, _Y[i]), cs)
            with lib.autograd.record():
                ls = [lf(net(x), y) for x, y in zip(xs, ys)]
            lib.autograd.backward(ls)
            tr.step(4)
        assert tr._scan is None          # never entered the scan path
        if lib is pt:
            from mxnet_tpu_torch.gluon import zero as zero_mod
            assert isinstance(tr._zero, zero_mod.ZeroEngine) == zero
        return {k2.replace(prefix, ""): p.data(cs[0]).asnumpy()
                for k2, p in net.collect_params().items()}

    ref = run(1, "rr_", False, lib=mx)
    for zero in (False, True):
        tag = "z" if zero else "r"
        p1 = run(1, "m1%s_" % tag, zero)
        p8 = run(8, "m8%s_" % tag, zero)
        for name in p1:
            assert p1[name].tobytes() == p8[name].tobytes(), name
            np.testing.assert_allclose(p1[name], ref[name], rtol=1e-5,
                                       atol=1e-6)
