"""The rest of the optimizers against the reference (mxnet_tpu) on the
same numpy inputs: the thirteen update and norm ops the port lacked,
NAG, RMSProp (plain and centered), Ftrl, SignSGD and AdaGrad through
the Trainer, and the aggregation width ``MXNET_OPTIMIZER_AGGREGATION_SIZE``.

Each op in f32 within 1e-6 relative (1e-7 absolute), as the other
optimizer tests hold theirs; the elementwise ones also in bfloat16,
within one bfloat16 ulp (the reference applies a Python float
hyperparameter in the tensor's dtype, and so does the port). The
Trainer steps write the gradients into the parameters directly, so the
optimizers alone are compared (f32, 1e-6).

Aggregation: with the width at 1 both packages update each tensor alone
and arm no fused SGD step; at 2 a multi-tensor optimizer takes its
parameters two at a time; at the default, all in one call. A bfloat16
weight shows the difference: the one-tensor SGD update keeps bf16
arithmetic, the multi-tensor one works in f32 (ROADMAP.md queue 3).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import mxnet_tpu as mx
from mxnet_tpu import ops as ref_ops

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import autograd as port_ag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import get_op as port_op
from mxnet_tpu_torch.ops import optimizer_ops as port_opt_ops

from test_torch_checkpoint import (SHAPES, _as_np, _close, _grads,
                                   _init_weights, _steps, _trainer)

NEW_OPS = ["nag_mom_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "signsgd_update", "ftml_update",
           "multi_sgd_update", "multi_sgd_mom_update", "multi_l2_norm",
           "multi_finite_norm", "multi_update_norm",
           "_contrib_group_adagrad_update", "_contrib_multi_lars"]


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    for var in list(pt.config.VARS) + ["MXNET_OPTIMIZER_AGGREGATION_SIZE"]:
        monkeypatch.delenv(var, raising=False)


def _inputs(seed, kinds, shape=(6, 5)):
    """One array per kind: w, g (normal), m (small normal), p (positive),
    c (g-state of centered RMSProp: c^2 <= the p before it)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in kinds:
        if k in "wg":
            a = rng.randn(*shape)
        elif k == "m":
            a = rng.randn(*shape) * 0.1
        elif k == "p":
            a = rng.rand(*shape) * 0.1 + 0.01
        else:
            a = np.sqrt(out[-1]) * rng.uniform(-0.9, 0.9, shape)
        out.append(a.astype(np.float32))
    return out


def _run(name, arrays, kw, dtype="float32", atol=1e-7):
    if dtype == "float32":
        ref_in = [jnp.asarray(a) for a in arrays]
        port_in = [torch.tensor(a) for a in arrays]
    else:
        ref_in = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        port_in = [torch.tensor(a).to(torch.bfloat16) for a in arrays]
    ref = ref_ops.get_op(name).impl(*ref_in, **kw)
    port = port_op(name).impl(*port_in, **kw)
    ref = list(ref) if isinstance(ref, (tuple, list)) else [ref]
    port = list(port) if isinstance(port, (tuple, list)) else [port]
    assert len(ref) == len(port)
    for k, (r, p) in enumerate(zip(ref, port)):
        assert p.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16,
                           "bool": torch.bool}[str(r.dtype)], (k, r.dtype)
        r = np.asarray(r.astype(jnp.float32))
        p = p.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(p, r, rtol=1e-6, atol=atol,
                                       err_msg="output %d" % k)
        else:
            np.testing.assert_allclose(p, r, rtol=2 ** -8, atol=1e-30,
                                       err_msg="output %d" % k)


HP = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
ONE_TENSOR = [
    ("nag_mom_update", "wgm", dict(HP, lr=0.1, momentum=0.9)),
    ("rmsprop_update", "wgp", dict(HP, lr=0.01, gamma1=0.9, epsilon=1e-8)),
    ("rmsprop_update", "wgp", dict(HP, lr=0.5, gamma1=0.95, epsilon=1e-8,
                                   clip_weights=1.0)),
    ("rmspropalex_update", "wgpcm", dict(HP, lr=0.01, gamma1=0.9,
                                         gamma2=0.8, epsilon=1e-8)),
    ("rmspropalex_update", "wgpcm", dict(HP, lr=0.5, gamma1=0.95,
                                         gamma2=0.9, epsilon=1e-8,
                                         clip_weights=1.0)),
    ("ftrl_update", "wgmp", dict(HP, lr=0.1, lamda1=0.01, beta=1.0)),
    ("ftrl_update", "wgmp", dict(wd=0.0, lr=0.5, lamda1=0.3, beta=0.5)),
    ("signsgd_update", "wg", dict(HP, lr=0.01)),
    ("ftml_update", "wgppm", dict(wd=0.01, rescale_grad=0.5, clip_grad=0.8,
                                  lr=0.05, beta1=0.6, beta2=0.999,
                                  epsilon=1e-8, t=3)),
    ("_contrib_group_adagrad_update", "wgp", dict(lr=0.1, epsilon=1e-5,
                                                  rescale_grad=0.5,
                                                  clip_gradient=0.8)),
]


@pytest.mark.parametrize("name,kinds,kw", ONE_TENSOR)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_tensor_op(name, kinds, kw, dtype):
    arrays = _inputs(0, kinds)
    if name == "_contrib_group_adagrad_update":
        arrays[2] = arrays[2][:, :1]           # one history value a row
    # Ftrl's z' = z + g - sigma * w cancels terms of order 1, and torch's
    # f32 sqrt on the CPU is not correctly rounded (one ulp off for about
    # 0.7% of inputs, where numpy and the reference are exact): z' is held
    # to 1e-6 of those terms
    _run(name, arrays, kw, dtype, atol=1e-6 if name == "ftrl_update"
         else 1e-7)


def test_group_adagrad_one_dimensional():
    _run("_contrib_group_adagrad_update", _inputs(1, "wgp", (7,)),
         dict(lr=0.1, epsilon=1e-5))


@pytest.mark.parametrize("name,per,kw", [
    ("multi_sgd_update", "wg", dict(lrs=(0.1, 0.2, 0.05),
                                    wds=(0.0, 0.01, 0.1), rescale_grad=0.5,
                                    clip_gradient=0.8)),
    ("multi_sgd_update", "wg", dict(lrs=(0.1,), wds=(0.01,))),
    ("multi_sgd_mom_update", "wgm", dict(lrs=(0.1, 0.2, 0.05),
                                         wds=(0.0, 0.01, 0.1), momentum=0.9,
                                         rescale_grad=0.5,
                                         clip_gradient=0.8)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_sgd_ops(name, per, kw, dtype):
    n = len(kw["lrs"]) if len(kw["lrs"]) > 1 else 3
    arrays = [a for i in range(n) for a in _inputs(2 + i, per, (4 + i, 3))]
    _run(name, arrays, dict(kw, num_weights=n), dtype)


def test_multi_sgd_op_one_weight_returns_the_array():
    _run("multi_sgd_update", _inputs(5, "wg"),
         dict(lrs=0.1, wds=0.0, num_weights=1))


def _norm_arrays(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(5, 3).astype(np.float32) * 3,
            rng.randn(7).astype(np.float32),
            np.zeros((2, 2), np.float32)]


def test_multi_l2_norm():
    arrays = _norm_arrays(3)
    _run("multi_l2_norm", arrays, dict(num_arrays=len(arrays)))


@pytest.mark.parametrize("bad", [None, np.inf, np.nan])
@pytest.mark.parametrize("num_weights", [0, 2])
def test_multi_finite_norm(bad, num_weights):
    arrays = _norm_arrays(4)
    if bad is not None:
        arrays[1][3] = bad
    weights = _norm_arrays(5)[:num_weights]
    _run("multi_finite_norm", arrays + weights,
         dict(num_arrays=len(arrays), num_weights=num_weights))


def test_multi_update_norm():
    old, new = _norm_arrays(6), _norm_arrays(7)
    arrays = [a for pair in zip(old, new) for a in pair]
    _run("multi_update_norm", arrays, dict(num_arrays=len(old)))


def test_multi_lars():
    rng = np.random.RandomState(8)
    lrs = np.float32([0.1, 0.2, 0.3, 0.4, 0.5])
    w2 = np.float32([4.0, 0.0, 2.5, 9.0, 1.0])
    g2 = np.float32([1.0, 3.0, 0.0, 0.25, 2.0])
    wds = rng.rand(5).astype(np.float32) * 0.01
    _run("_contrib_multi_lars", [lrs, w2, g2, wds],
         dict(eta=0.001, eps=1e-8, rescale_grad=0.5))


def test_the_thirteen_op_names_are_registered():
    for name in NEW_OPS:
        assert port_op(name).name == name
        assert ref_ops.get_op(name).name == name
    assert len(pt.ops._OPS) >= 194


# ---------------------------------------------------------------------------
# the five optimizers through the Trainer
# ---------------------------------------------------------------------------
NEW_OPTIMIZERS = [
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("nag", dict(learning_rate=0.1, wd=0.01, clip_gradient=1.0)),
    ("rmsprop", dict(learning_rate=0.01, wd=0.01, clip_gradient=1.5)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, wd=0.01,
                     clip_weights=2.0)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.001, wd=0.01)),
    ("signsgd", dict(learning_rate=0.01, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01, clip_gradient=2.0)),
]
OPT_IDS = ["nag_momentum", "nag_plain", "rmsprop", "rmsprop_centered",
           "ftrl", "signsgd", "adagrad"]


@pytest.mark.parametrize("opt,kw", NEW_OPTIMIZERS, ids=OPT_IDS)
@pytest.mark.parametrize("aggregated", [False, True])
def test_optimizer_three_trainer_steps(opt, kw, aggregated, monkeypatch):
    """One parameter per Trainer (the one-tensor path) or all three in
    one Trainer (update_multi)."""
    grads = _grads(9, 3)
    w0 = _init_weights(9)
    names = list(SHAPES) if aggregated else [[n] for n in SHAPES]
    groups = [names] if aggregated else names
    got, want = {}, {}
    for group in groups:
        monkeypatch.setattr("test_torch_checkpoint.SHAPES",
                            {n: SHAPES[n] for n in group})
        for lib, out in ((pt, got), (mx, want)):
            params, tr = _trainer(lib, opt, kw, "float32", w0)
            out.update(_steps(lib, params, tr, grads, "float32"))
            if lib is pt:
                assert tr.optimizer.num_update == 3
    _close(got, want, "float32")


@pytest.mark.parametrize("opt,kw", NEW_OPTIMIZERS, ids=OPT_IDS)
def test_optimizer_float16_masters(opt, kw):
    """multi_precision: a float16 weight gets an f32 master and updates
    as MXNet 1.x does (the master by the widened gradient, the weight its
    value), so masters equal an f32 run from the same values, and the
    weights that run rounded."""
    grads = [{n: g.astype(np.float16).astype(np.float32)
              for n, g in step.items()} for step in _grads(10, 3)]
    w0 = {n: w.astype(np.float16).astype(np.float32)
          for n, w in _init_weights(10).items()}
    params, tr = _trainer(pt, opt, dict(kw, multi_precision=True),
                          "float16", w0)
    got = _steps(pt, params, tr, grads, "float16")
    params32, tr32 = _trainer(pt, opt, kw, "float32", w0)
    want = _steps(pt, params32, tr32, grads, "float32")
    for i, p in enumerate(params):
        inner, w32 = tr._updater.states[i]
        assert w32._tdtype == torch.float32
        np.testing.assert_array_equal(_as_np(w32), want[p.name])
        np.testing.assert_array_equal(
            got[p.name], want[p.name].astype(np.float16).astype(np.float32))


def test_create_accepts_every_name():
    for name, klass in (("nag", "NAG"), ("rmsprop", "RMSProp"),
                        ("ftrl", "Ftrl"), ("signsgd", "SignSGD"),
                        ("adagrad", "AdaGrad"), ("SGD", "SGD")):
        opt = pt.optimizer.create(name)
        assert type(opt).__name__ == klass
        ref = mx.optimizer.create(name)
        for attr in ("lr", "wd", "momentum", "gamma1", "gamma2", "epsilon",
                     "centered", "lamda1", "beta", "float_stable_eps"):
            assert getattr(opt, attr, None) == getattr(ref, attr, None), \
                (name, attr)
    with pytest.raises(MXNetError, match="dcasgd"):
        pt.optimizer.create("dcasgd")


# ---------------------------------------------------------------------------
# the aggregation width
# ---------------------------------------------------------------------------
AGG_SHAPES = {"ag_w%d" % i: (3 + i, 2) for i in range(5)}
AGG_OPTS = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01),
     "preloaded_multi_sgd_mom_update"),
    ("adam", dict(learning_rate=0.01, wd=0.01), "multi_adam_update"),
    ("lamb", dict(learning_rate=0.01, wd=0.01), "multi_lamb_update"),
]


@pytest.mark.parametrize("size,calls", [("1", 0), ("2", 3), (None, 1),
                                        ("0", 0)])
@pytest.mark.parametrize("opt,kw,op", AGG_OPTS, ids=["sgd", "adam", "lamb"])
def test_aggregation_width_chunks_the_update(monkeypatch, size, calls, opt,
                                             kw, op):
    """Five parameters: per tensor at 1 and at 0 (the Trainer aggregates
    only above 1), three multi-tensor calls a step at 2, one at the
    default; the results equal the reference's at each width."""
    if size is not None:
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", size)
    monkeypatch.setattr("test_torch_checkpoint.SHAPES", AGG_SHAPES)
    counted = []
    real = getattr(port_opt_ops, op)
    monkeypatch.setattr(port_opt_ops, op,
                        lambda *a, **k: (counted.append(1), real(*a, **k))[1])
    rng = np.random.RandomState(11)
    grads = [{n: rng.randn(*s).astype(np.float32)
              for n, s in AGG_SHAPES.items()} for _ in range(2)]
    w0 = {n: rng.randn(*s).astype(np.float32) for n, s in AGG_SHAPES.items()}
    runs = {}
    for lib in (pt, mx):
        params, tr = _trainer(lib, opt, kw, "float32", w0)
        assert tr.optimizer.aggregate_num == (4096 if size is None
                                              else int(size))
        runs[lib] = _steps(lib, params, tr, grads, "float32")
    assert len(counted) == 2 * calls
    _close(runs[pt], runs[mx], "float32")


def test_width_1_keeps_a_bfloat16_sgd_weight_in_bf16_arithmetic(monkeypatch):
    """At width 1 both packages take the one-tensor sgd_mom_update, whose
    bf16 arithmetic the port reproduces bit for bit; at the default the
    port's multi-tensor update computes in f32 and lands elsewhere."""
    rng = np.random.RandomState(12)
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(3)]
    w0 = _init_weights(12)
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01)
    runs = {}
    for size in ("1", "4096"):
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", size)
        for lib in (pt, mx):
            if lib is mx and size != "1":
                continue      # the reference's turns the weights to f32
            params, tr = _trainer(lib, "sgd", kw, "bfloat16", w0)
            out = _steps(lib, params, tr, grads, "bfloat16")
            assert all(p.data().dtype == ml_dtypes.bfloat16 for p in params)
            runs[(lib, size)] = out
    for n in SHAPES:
        np.testing.assert_array_equal(runs[(pt, "1")][n], runs[(mx, "1")][n],
                                      err_msg=n)
    assert any(not np.array_equal(runs[(pt, "4096")][n], runs[(mx, "1")][n])
               for n in SHAPES)


def _hybrid_step(net, tr, x, y):
    loss_fn = pt.gluon.loss.L2Loss()
    with pt.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    tr.step(x.shape[0])


@pytest.mark.parametrize("size,armed", [("1", False), ("2", True),
                                        (None, True)])
def test_fused_step_arms_only_above_width_1(monkeypatch, size, armed):
    if size is not None:
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", size)
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    with pt.cpu():
        net = pt.gluon.nn.Dense(3, in_units=4, prefix="fz%s_" % size)
        net.initialize()
        net.hybridize()
        tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        x = pt.nd.array(np.random.RandomState(0).randn(2, 4))
        y = pt.nd.zeros((2, 3))
        for _ in range(2):
            _hybrid_step(net, tr, x, y)
        assert tr._fused_armed is armed
        _hybrid_step(net, tr, x, y)
        assert port_ag._PENDING[0] is None
    port_ag.disarm_fused_update()


def test_fused_step_arms_for_one_parameter(monkeypatch):
    """The reference's eligibility reads the width, not the number of
    parameters: one parameter arms too, and its fused step equals the
    separate update bit for bit."""
    monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1")
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", flag)
        with pt.cpu():
            net = pt.gluon.nn.Dense(3, in_units=4, use_bias=False,
                                    prefix="one%s_" % flag)
            net.initialize(pt.init.Constant(0.5))
            net.hybridize()
            tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
            x = pt.nd.array(np.random.RandomState(1).randn(2, 4))
            y = pt.nd.zeros((2, 3))
            for _ in range(3):
                _hybrid_step(net, tr, x, y)
            assert tr._fused_armed is (flag == "1")
            out[flag] = net.weight.data().asnumpy()
        port_ag.disarm_fused_update()
    np.testing.assert_array_equal(out["1"], out["0"])


@pytest.mark.parametrize("opt,kw,op,calls", [o + (c,) for o, c in
                                              zip(AGG_OPTS, (4, 1, 1))],
                         ids=["sgd", "adam", "lamb"])
def test_width_0_chunks_as_the_reference(monkeypatch, opt, kw, op, calls):
    """update_multi called directly at a width of 0 or less: the
    reference's SGD takes chunks of one, its adaptive optimizers every
    parameter in one multi-tensor call; the port counts the same calls
    and lands on the same weights."""
    import mxnet_tpu.optimizer as ref_optimizer
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "0")
    counted = {pt: [], mx: []}
    real = getattr(port_opt_ops, op)
    monkeypatch.setattr(port_opt_ops, op, lambda *a, **k: (
        counted[pt].append(1), real(*a, **k))[1])
    if opt == "sgd":
        ref_real = mx.nd.preloaded_multi_sgd_mom_update
        monkeypatch.setattr(mx.nd, "preloaded_multi_sgd_mom_update",
                            lambda *a, **k: (counted[mx].append(1),
                                             ref_real(*a, **k))[1])
    before = ref_optimizer._MULTI_DISPATCH_COUNT[0]
    rng = np.random.RandomState(13)
    ws = [rng.randn(3, 2).astype(np.float32) for _ in range(4)]
    gs = [rng.randn(3, 2).astype(np.float32) for _ in range(4)]
    out = {}
    for lib in (pt, mx):
        optimizer = lib.optimizer.create(opt, **kw)
        assert optimizer.aggregate_num == 0
        updater = lib.optimizer.get_updater(optimizer)
        w = [lib.nd.array(a, ctx=lib.cpu()) for a in ws]
        updater.update_multi(list(range(4)),
                             [lib.nd.array(a, ctx=lib.cpu()) for a in gs], w)
        out[lib] = [_as_np(a) for a in w]
    if opt != "sgd":
        counted[mx] = [1] * (ref_optimizer._MULTI_DISPATCH_COUNT[0] - before)
    assert len(counted[pt]) == len(counted[mx]) == calls
    for a, b in zip(out[pt], out[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
