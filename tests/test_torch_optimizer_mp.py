"""The port's update operators, multi-precision master weights, Adam,
AdamW, LAMB's one-tensor update and the learning-rate schedulers against
the reference (mxnet_tpu/ops/optimizer_ops.py, optimizer/__init__.py,
lr_scheduler.py), on the same numpy inputs.

Each op is held in f32 and, for the ``mp_`` forms, with a float16 weight
and its f32 master, the per-tensor hyperparameters passed as the
reference's optimizer passes them (Python floats to the one-tensor ops;
f32 arrays for lrs, wds, step counts and rescale_grad to the
multi-tensor ones). f32 results agree within 1e-6 (relative, 1e-7
absolute); float16 weights, rounded from f32 masters that agree, within
one float16 ulp. The Trainer runs three steps of a float16 MLP with
``multi_precision=True`` in both packages. Its forward and backward run
in float16, where the two packages' products may round a sum
differently, so the masters are held to twice the reference's own
float16-vs-f32 distance (on the CPU the port's read 0.04-1.5 times it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import ops as ref_ops
from mxnet_tpu import lr_scheduler as ref_sched

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import lr_scheduler as port_sched
from mxnet_tpu_torch.ops import get_op as port_op

SHAPES = [(7, 5), (13,)]


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _arrays(seed, kinds):
    """Per tensor of SHAPES, one array per kind: w (the f32 master's
    value), g, m, v (v >= 0)."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in SHAPES:
        grp = {"w": rng.randn(*shape).astype(np.float32),
               "g": rng.randn(*shape).astype(np.float32),
               "m": (rng.randn(*shape) * 0.1).astype(np.float32),
               "v": (rng.rand(*shape) * 0.1).astype(np.float32)}
        out.append([grp[k] for k in kinds])
    return out


def _run(name, arrays, ref_kw, port_kw=None):
    """The reference op and the port op on the same arrays; returns both
    outputs as lists of f32 numpy arrays."""
    ref = ref_ops.get_op(name).impl(*[jnp.asarray(a) for a in arrays],
                                    **ref_kw)
    port = port_op(name).impl(*[torch.tensor(a) for a in arrays],
                              **(ref_kw if port_kw is None else port_kw))
    ref = ref if isinstance(ref, (tuple, list)) else [ref]
    port = port if isinstance(port, (tuple, list)) else [port]
    return ([np.asarray(r.astype(jnp.float32)) for r in ref],
            [p.float().numpy() for p in port])


def _close(ref, port, f16_outputs=()):
    assert len(ref) == len(port)
    for k, (r, p) in enumerate(zip(ref, port)):
        if k in f16_outputs:
            np.testing.assert_allclose(p, r, rtol=2 ** -10, atol=2 ** -24,
                                       err_msg="output %d" % k)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7,
                                       err_msg="output %d" % k)


HP = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.8)


@pytest.mark.parametrize("name,kinds,kw", [
    ("adam_update", "wgmv", dict(HP, lr=0.01, beta1=0.9, beta2=0.999,
                                 epsilon=1e-8)),
    ("adamw_update", "wgmv", dict(HP, lr=0.01, beta1=0.9, beta2=0.99,
                                  epsilon=1e-8, eta=0.7)),
    ("lamb_update_phase1", "wgmv", dict(HP, beta1=0.9, beta2=0.999,
                                        epsilon=1e-6, t=3,
                                        bias_correction=True)),
    ("lamb_update_phase1", "wgmv", dict(HP, beta1=0.8, beta2=0.99,
                                        epsilon=1e-6, t=1,
                                        bias_correction=False)),
])
def test_one_tensor_op_f32(name, kinds, kw):
    for arrays in _arrays(0, kinds):
        _close(*_run(name, arrays, kw))


@pytest.mark.parametrize("bounds", [(-1.0, -1.0), (0.5, 2.0)])
def test_lamb_phase2_f32(bounds):
    for w, u in _arrays(1, "wg"):
        for r1, r2 in ((np.linalg.norm(w), np.linalg.norm(u)), (0.0, 1.0)):
            arrays = [w, u, np.float32([r1]), np.float32([r2])]
            _close(*_run("lamb_update_phase2", arrays,
                         dict(lr=0.01, lower_bound=bounds[0],
                              upper_bound=bounds[1])))


def _mp(arrays):
    """f32 arrays [w, g, ...] -> [w16, g16, ..., w32]: the weight and
    gradient in float16, the states and the master in f32."""
    w, g = arrays[0], arrays[1]
    return [w.astype(np.float16), g.astype(np.float16)] + list(arrays[2:]) \
        + [w]


@pytest.mark.parametrize("name,kinds,kw,f16", [
    ("mp_sgd_update", "wg", dict(HP, lr=0.1), (0,)),
    ("mp_sgd_mom_update", "wgm", dict(HP, lr=0.1, momentum=0.9), (0,)),
    ("mp_lamb_update_phase1", "wgmv", dict(HP, beta1=0.9, beta2=0.999,
                                           epsilon=1e-6, t=2), ()),
    ("_mp_adamw_update", "wgmv", dict(HP, lr=0.01, beta1=0.9, beta2=0.999,
                                      epsilon=1e-8, eta=1.0), (0,)),
])
def test_one_tensor_op_float16_master(name, kinds, kw, f16):
    for arrays in _arrays(2, kinds):
        _close(*_run(name, _mp(arrays), kw), f16_outputs=f16)


def test_mp_lamb_phase2_float16_master():
    for w, u in _arrays(3, "wg"):
        arrays = [w.astype(np.float16), u, np.float32([np.linalg.norm(w)]),
                  np.float32([np.linalg.norm(u)]), w]
        _close(*_run("mp_lamb_update_phase2", arrays, dict(lr=0.01)),
               f16_outputs=(0,))


def _multi(name, groups, kw, mp, lr_key, wd_key, step=False,
           preloaded=False):
    n = len(groups)
    arrays = [a for grp in groups for a in (_mp(grp) if mp else grp)]
    lrs = np.float32([0.01, 0.02][:n])
    wds = np.float32([0.0, 0.05][:n])
    ref_kw, port_kw = dict(kw), dict(kw)
    if preloaded:
        ref_in = arrays + [lrs, wds]
        ref = ref_ops.get_op(name).impl(*[jnp.asarray(a) for a in ref_in],
                                        **kw)
        port = port_op(name).impl(*[torch.tensor(a) for a in ref_in], **kw)
        return ([np.asarray(r.astype(jnp.float32)) for r in ref],
                [p.float().numpy() for p in port])
    ref_kw.update({lr_key: jnp.asarray(lrs), wd_key: jnp.asarray(wds),
                   "rescale_grad": jnp.float32(kw["rescale_grad"])})
    port_kw.update({lr_key: [float(x) for x in lrs],
                    wd_key: [float(x) for x in wds]})
    if step:
        ref_kw["step_count"] = jnp.asarray(np.float32([1, 4][:n]))
        port_kw["step_count"] = [1, 4][:n]
    return _run(name, arrays, ref_kw, port_kw)


_ADAM = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5,
             clip_gradient=0.8)
_LAMB = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, bias_correction=True,
             rescale_grad=0.5, clip_gradient=0.8, lower_bound=-1.0,
             upper_bound=-1.0)
_SGD = dict(rescale_grad=0.5, clip_gradient=0.8)


@pytest.mark.parametrize("name,kinds,kw,mp,keys,step", [
    ("multi_adam_update", "wgmv", _ADAM, False, "lw", False),
    ("_multi_adamw_update", "wgmv", dict(_ADAM, etas=1.0), False, "lw",
     False),
    ("_multi_lamb_update", "wgmv", _LAMB, False, "lw", True),
    ("multi_mp_adam_update", "wgmv", _ADAM, True, "lw", False),
    ("_multi_mp_adamw_update", "wgmv", dict(_ADAM, etas=1.0), True, "lw",
     False),
    ("_multi_mp_lamb_update", "wgmv", _LAMB, True, "lw", True),
    ("multi_mp_sgd_update", "wg", _SGD, True, "ls", False),
    ("multi_mp_sgd_mom_update", "wgm", dict(_SGD, momentum=0.9), True, "ls",
     False),
])
def test_multi_tensor_op(name, kinds, kw, mp, keys, step):
    groups = _arrays(4, kinds)
    lr_key, wd_key = ("learning_rates", "wds") if keys == "lw" \
        else ("lrs", "wds")
    ref, port = _multi(name, groups, dict(kw, num_tensors=2) if keys == "lw"
                       else dict(kw, num_weights=2), mp, lr_key, wd_key,
                       step)
    _close(ref, port, f16_outputs=(0, 1) if mp else ())


@pytest.mark.parametrize("name,kinds,kw", [
    ("preloaded_multi_mp_sgd_update", "wg", _SGD),
    ("preloaded_multi_mp_sgd_mom_update", "wgm", dict(_SGD, momentum=0.9)),
])
def test_preloaded_mp_sgd_op(name, kinds, kw):
    ref, port = _multi(name, _arrays(5, kinds), dict(kw, num_weights=2),
                       True, None, None, preloaded=True)
    _close(ref, port, f16_outputs=(0, 1))


def test_multi_all_finite_and_norm_ops():
    good = [np.ones((3, 4), np.float32), np.arange(5, dtype=np.float32)]
    for bad_val in (np.inf, -np.inf, np.nan):
        bad = [good[0], good[1].copy()]
        bad[1][2] = bad_val
        for arrays in (good, bad):
            _close(*_run("multi_all_finite", arrays, dict(num_arrays=2)))
    w = _arrays(6, "w")[0][0]
    for kw in (dict(), dict(ord=1), dict(axis=1), dict(axis=0,
                                                       keepdims=True)):
        _close(*_run("norm", [w], kw))
    assert pt.nd.array(w, ctx=pt.cpu()).norm().shape == (1,)


# ---------------------------------------------------------------------------
# optimizers through the Trainer
# ---------------------------------------------------------------------------
X = np.random.RandomState(0).rand(16, 10).astype(np.float32)
Y = np.random.RandomState(1).randint(0, 3, (16,)).astype(np.float32)


def _mlp(lib, ctx, dtype):
    net = lib.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(16, activation="relu", in_units=10))
        net.add(lib.gluon.nn.Dense(3, in_units=16))
    net.initialize(ctx=ctx)
    rng = np.random.RandomState(7)
    for name in sorted(net.collect_params()):
        p = net.collect_params()[name]
        p.set_data(lib.nd.array(
            (rng.rand(*p.shape).astype(np.float32) - 0.5) * 0.6, ctx=ctx))
    if dtype != "float32":
        net.cast(dtype)
    return net


def _train_mlp(lib, ctx, opt, hp, dtype, steps=3):
    net = _mlp(lib, ctx, dtype)
    params = net.collect_params()
    trainer = lib.gluon.Trainer(params, opt, dict(hp))
    loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
    x = lib.nd.array(X, ctx=ctx, dtype=dtype)
    y = lib.nd.array(Y, ctx=ctx)
    for _ in range(steps):
        with lib.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(16)
    names = sorted(params)
    updater = trainer._updaters[0] if lib is mx else trainer._updater
    states = updater.states
    weights = [params[n].data().asnumpy().astype(np.float32) for n in names]
    masters = [states[i][1].asnumpy() for i in range(len(names))] \
        if hp.get("multi_precision") and dtype == "float16" else None
    return weights, masters, trainer


OPTS = {"adam": {"learning_rate": 0.01, "wd": 0.01},
        "adamw": {"learning_rate": 0.01, "wd": 0.01},
        "lamb": {"learning_rate": 0.01, "wd": 0.01},
        "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_trainer_multi_precision_matches_reference(opt):
    """Three steps of the float16 MLP with masters: each master within
    twice the reference's own float16-vs-f32 distance (its masters
    against its f32 twin's weights) of the reference's, each weight
    within that plus 2^-10 relative (one float16 rounding) of the
    reference's, and exactly its master rounded to float16."""
    hp = dict(OPTS[opt], multi_precision=True)
    rw, rm, _ = _train_mlp(mx, mx.cpu(), opt, hp, "float16")
    pw, pm, trainer = _train_mlp(pt, pt.cpu(), opt, hp, "float16")
    twin, _, _ = _train_mlp(mx, mx.cpu(), opt, OPTS[opt], "float32")
    limit = 2 * max(np.abs(m - w).max() for m, w in zip(rm, twin))
    for r, p in zip(rm, pm):
        assert np.abs(p - r).max() <= limit
    # not the f32 run: the port's masters at least half the reference's
    # own distance from the f32 twin (1.0-2.4 of it on the CPU)
    assert max(np.abs(p - w).max() for p, w in zip(pm, twin)) >= limit / 4
    for r, p in zip(rw, pw):
        np.testing.assert_allclose(p, r, rtol=2 ** -10, atol=limit)
    for w, m in zip(pw, pm):
        np.testing.assert_array_equal(w, m.astype(np.float16)
                                      .astype(np.float32))
    assert all(isinstance(s, tuple) and s[1].dtype == np.float32
               for s in trainer._updater.states.values())


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_trainer_adam_f32_matches_reference(opt):
    rw, _, _ = _train_mlp(mx, mx.cpu(), opt, OPTS[opt], "float32")
    pw, _, _ = _train_mlp(pt, pt.cpu(), opt, OPTS[opt], "float32")
    for r, p in zip(rw, pw):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lib", [mx, pt], ids=["reference", "port"])
@pytest.mark.parametrize("opt", ["lamb", "sgd", "adam"])
def test_bfloat16_weight_gets_no_master(lib, opt):
    o = lib.optimizer.create(opt, multi_precision=True)
    ctx = lib.cpu()
    w = lib.nd.array(np.ones((3,), np.float32), ctx=ctx, dtype="bfloat16")
    w16 = lib.nd.array(np.ones((3,), np.float32), ctx=ctx, dtype="float16")
    plain, mp = o.create_state_multi_precision(0, w), \
        o.create_state_multi_precision(1, w16)
    assert plain is None or not isinstance(plain, tuple) or \
        not isinstance(plain[0], tuple)
    assert isinstance(mp, tuple) and str(mp[1].dtype).endswith("float32")


@pytest.mark.parametrize("opt", ["lamb", "adam", "adamw", "sgd"])
def test_one_tensor_mp_update_matches_the_multi_tensor_update(opt):
    """The one-tensor update of a float16 weight with a master (LAMB's
    mp phase ops, Adam's master update, mp AdamW, mp SGD) against the
    reference's multi-tensor update on the same one tensor (its
    ``update_multi``: ``_multi_mp_lamb_update``, ``multi_mp_adam_update``,
    ``_multi_mp_adamw_update``, ``preloaded_multi_mp_sgd_mom_update``),
    three steps: the reference's one-tensor LAMB, Adam and AdamW cannot
    take a master's nested state. The master within 1e-6 (relative,
    1e-7 absolute), the float16 weight within one float16 ulp; and the
    port's own multi-tensor update on that tensor gives the same."""
    hp = dict(OPTS[opt], multi_precision=True, rescale_grad=0.5)
    outs = []
    for lib, how in ((mx, "multi"), (pt, "one"), (pt, "multi")):
        o = lib.optimizer.create(opt, **hp)
        rng = np.random.RandomState(9)
        w = lib.nd.array(rng.randn(6, 4), ctx=lib.cpu(), dtype="float16")
        state = o.create_state_multi_precision(0, w)
        for _ in range(3):
            g = lib.nd.array(rng.randn(6, 4), ctx=lib.cpu(),
                             dtype="float16")
            if how == "multi":
                o.update_multi([0], [w], [g], [state])
            else:
                o.update_multi_precision(0, w, g, state)
        outs.append((w.asnumpy().astype(np.float32), state[1].asnumpy()))
    ref = outs[0]
    for w, m in outs[1:]:
        np.testing.assert_allclose(m, ref[1], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(w, ref[0], rtol=2 ** -10, atol=2 ** -24)
    np.testing.assert_array_equal(outs[1][0], outs[2][0])


def test_lamb_one_tensor_update_matches_reference():
    """LAMB's one-tensor update (phase 1, the two norms, phase 2) with
    the reference's, f32, three steps."""
    res = []
    for lib in (mx, pt):
        o = lib.optimizer.create("lamb", learning_rate=0.01, wd=0.01,
                                 rescale_grad=0.5, lower_bound=0.1,
                                 upper_bound=10.0)
        rng = np.random.RandomState(10)
        w = lib.nd.array(rng.randn(6, 4), ctx=lib.cpu())
        st = o.create_state(0, w)
        for _ in range(3):
            o.update(0, w, lib.nd.array(rng.randn(6, 4), ctx=lib.cpu()), st)
        res.append([w.asnumpy()] + [s.asnumpy() for s in st])
    for r, p in zip(*res):
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------
def _schedulers(mod):
    return [
        mod.FactorScheduler(step=7, factor=0.5, base_lr=1.0,
                            stop_factor_lr=0.05, warmup_steps=5,
                            warmup_begin_lr=0.1),
        mod.FactorScheduler(step=3, factor=0.9, base_lr=0.3),
        mod.MultiFactorScheduler(step=[5, 15, 30], factor=0.1, base_lr=1.0,
                                 warmup_steps=4, warmup_mode="constant",
                                 warmup_begin_lr=0.2),
        mod.PolyScheduler(max_update=40, base_lr=1.0, pwr=2, final_lr=0.01,
                          warmup_steps=10),
        mod.PolyScheduler(max_update=30, base_lr=0.5, pwr=1),
        mod.CosineScheduler(max_update=45, base_lr=1.0, final_lr=0.1,
                            warmup_steps=6, warmup_begin_lr=0.05),
        mod.CosineScheduler(max_update=20, base_lr=2.0,
                            warmup_mode="constant", warmup_steps=3)]


@pytest.mark.parametrize("k", range(7))
def test_schedulers_match_reference(k):
    ref, port = _schedulers(ref_sched)[k], _schedulers(port_sched)[k]
    assert [port(t) for t in range(51)] == [ref(t) for t in range(51)]


def test_scheduler_warmup_mode_refused():
    for mod in (ref_sched, port_sched):
        with pytest.raises(ValueError, match="warmup_mode"):
            mod.PolyScheduler(max_update=10, warmup_steps=2,
                              warmup_mode="cubic")(0)


def test_scheduler_drives_optimizer():
    """tests/test_schedulers_metrics.py's case, in both packages, and the
    learning rates of each update equal."""
    lrs = []
    for lib in (mx, pt):
        s = lib.lr_scheduler.FactorScheduler(step=1, factor=0.5, base_lr=0.8)
        opt = lib.optimizer.SGD(learning_rate=0.8, lr_scheduler=s)
        w = lib.nd.ones((2,), ctx=lib.cpu())
        g = lib.nd.ones((2,), ctx=lib.cpu())
        st = opt.create_state(0, w)
        opt.update(0, w, g, st)
        seen = [opt._get_lr(0)]
        for _ in range(3):
            opt.update(0, w, g, st)
            seen.append(opt._get_lr(0))
        assert seen[-1] < seen[0]
        lrs.append((seen, w.asnumpy()))
        with pytest.raises(UserWarning):
            opt.set_learning_rate(0.1)
    assert lrs[0][0] == lrs[1][0]
    np.testing.assert_allclose(lrs[1][1], lrs[0][1], rtol=1e-6)


@pytest.mark.parametrize("opt", ["lamb", "adamw"])
def test_trainer_with_poly_warmup_matches_reference(opt):
    """A PolyScheduler with warmup through the Trainer: the learning
    rate it reads at each step and the weights after three steps."""
    out = []
    for lib, ctx in ((mx, mx.cpu()), (pt, pt.cpu())):
        sched = lib.lr_scheduler.PolyScheduler(max_update=10, base_lr=0.05,
                                               warmup_steps=2)
        hp = dict(OPTS[opt], lr_scheduler=sched)
        net = _mlp(lib, ctx, "float32")
        trainer = lib.gluon.Trainer(net.collect_params(), opt, hp)
        loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
        x, y = lib.nd.array(X, ctx=ctx), lib.nd.array(Y, ctx=ctx)
        rates = []
        for _ in range(3):
            with lib.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(16)
            rates.append(trainer.learning_rate)
        out.append((rates, [net.collect_params()[n].data().asnumpy()
                            for n in sorted(net.collect_params())]))
    assert out[0][0] == out[1][0]
    for r, p in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)
