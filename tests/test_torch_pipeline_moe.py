"""``mxnet_tpu_torch.parallel.pipeline`` and ``.moe`` against the
reference's (``tests/test_parallel.py``'s pipeline and MoE cases).

The reference runs on the virtual CPU devices of ``tests/conftest.py``,
the port on ``cpu(i)`` contexts with the same mesh shapes, one thread a
device, on the same numpy inputs. Tolerances: the pipeline's forward
within rtol 1e-5 (atol 1e-6) of the reference's and of the stages run
in sequence; three SGD steps' losses and parameters within 1e-5 of the
reference's ``make_pipeline_step``; the MoE layer within 1e-5 of the
reference's layer, whose weights the same seed draws, and of the dense
per-token expert; commwatch's rows equal to the reference's trace-time
records.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import parallel as rpar
from mxnet_tpu_torch import parallel as ppar

TOL = dict(rtol=1e-5, atol=1e-6)
CPUS = [pt.cpu(i) for i in range(8)]


def pmesh(n, **axes):
    return ppar.make_mesh(ppar.MeshConfig(**axes), devices=CPUS[:n])


def rmesh(n, **axes):
    return rpar.make_mesh(rpar.MeshConfig(**axes), devices=jax.devices()[:n])


def _comm_rows(lib, run, monkeypatch):
    """commwatch's rows of one call of ``run`` with telemetry on."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    lib.telemetry.refresh()
    lib.telemetry.reset()
    try:
        run()
        return sorted((r["op"], r["axis"], r["ops"], r["bytes"])
                      for r in lib.commwatch.report())
    finally:
        monkeypatch.delenv("MXNET_TELEMETRY")
        lib.telemetry.refresh()
        lib.telemetry.reset()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def _pipeline_inputs():
    rng = np.random.RandomState(0)
    d = 8
    Ws = rng.randn(4, d, d).astype(np.float32) * 0.3
    bs = rng.randn(4, d).astype(np.float32) * 0.1
    x = rng.randn(3, 5, d).astype(np.float32)
    return Ws, bs, x


def _ref_pipeline_forward(Ws, bs, x):
    def stage_fn(params, t):
        W, b = params
        return jnp.tanh(t @ W[0] + b[0])
    P = rpar.P
    f = rpar.shard_map(
        lambda W, b, xm: rpar.pipeline_apply(stage_fn, (W, b), xm, "pp")[None],
        mesh=rmesh(4, pp=4), in_specs=(P("pp"), P("pp"), P()),
        out_specs=P("pp"))
    return np.asarray(jax.jit(f)(jnp.asarray(Ws), jnp.asarray(bs),
                                 jnp.asarray(x)))


def _port_pipeline_forward(Ws, bs, x):
    def stage_fn(params, t):
        W, b = params
        return torch.tanh(t @ W[0] + b[0])
    P = ppar.P
    f = ppar.shard_map(
        lambda W, b, xm: ppar.pipeline_apply(
            stage_fn, (W.tensor(), b.tensor()), xm, "pp")[None],
        mesh=pmesh(4, pp=4), in_specs=(P("pp"), P("pp"), P()),
        out_specs=P("pp"))
    return f(*[torch.from_numpy(a) for a in (Ws, bs, x)]).asnumpy()


def test_pipeline_forward_matches_the_reference_and_the_sequence():
    Ws, bs, x = _pipeline_inputs()
    got = _port_pipeline_forward(Ws, bs, x)
    want = _ref_pipeline_forward(Ws, bs, x)
    # every stage's buffer: the last holds the outputs, the others zeros
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[:-1].any()
    ref = x.copy()
    for s in range(4):
        ref = np.tanh(ref @ Ws[s] + bs[s])
    np.testing.assert_allclose(got[-1], ref, **TOL)


def test_pipeline_rejects_inhomogeneous_stages():
    def stage_fn(W, t):
        return t[..., :2]
    f = ppar.shard_map(
        lambda W, xm: ppar.pipeline_apply(stage_fn, W, xm, "pp")[None],
        mesh=pmesh(2, pp=2), in_specs=(ppar.P("pp"), ppar.P()),
        out_specs=ppar.P("pp"))
    with pytest.raises(ValueError, match="homogeneous stages"):
        f(torch.zeros(2, 3, 3), torch.zeros(2, 4, 3))


def _train_inputs():
    rng = np.random.RandomState(1)
    d = 6
    Ws = rng.randn(4, d, d).astype(np.float32) * 0.3
    x = rng.randn(2, 4, d).astype(np.float32)
    y = rng.randn(2, 4, d).astype(np.float32)
    return Ws, x, y


def _ref_steps(Ws, x, y, n):
    step = rpar.make_pipeline_step(
        lambda W, t: jnp.tanh(t @ W), rmesh(4, pp=4), 2,
        lambda out, lab: jnp.mean((out - lab) ** 2), lr=0.1)
    params, losses = jnp.asarray(Ws), []
    for _ in range(n):
        params, loss = step(params, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return np.asarray(params), losses


def _port_steps(Ws, x, y, n):
    step = ppar.make_pipeline_step(
        lambda W, t: torch.tanh(t @ W), pmesh(4, pp=4), 2,
        lambda out, lab: ((out - lab) ** 2).mean(), lr=0.1)
    params, losses = torch.from_numpy(Ws), []
    for _ in range(n):
        params, loss = step(params, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(loss))
    return params.numpy(), losses


def test_pipeline_three_train_steps_match_the_reference():
    Ws, x, y = _train_inputs()
    p_port, l_port = _port_steps(Ws, x, y, 3)
    p_ref, l_ref = _ref_steps(Ws, x, y, 3)
    np.testing.assert_allclose(l_port, l_ref, rtol=1e-5)
    np.testing.assert_allclose(p_port, p_ref, rtol=1e-5, atol=1e-6)
    assert l_port[-1] < l_port[0]


def test_pipeline_first_step_is_the_sequential_sgd_step():
    """The stages' gradients equal the stack's run in sequence on one
    device (torch autograd on the CPU)."""
    Ws, x, y = _train_inputs()
    p_port, l_port = _port_steps(Ws, x, y, 1)
    W = torch.from_numpy(Ws).requires_grad_(True)
    t = torch.from_numpy(x)
    for s in range(4):
        t = torch.tanh(t @ W[s])
    loss = ((t - torch.from_numpy(y)) ** 2).mean()
    g, = torch.autograd.grad(loss, W)
    np.testing.assert_allclose(l_port[0], float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(p_port, (W - 0.1 * g).detach().numpy(),
                               **TOL)


def test_pipeline_takes_a_dict_of_ndarrays():
    """The stage function's parameters may be a dict (here of NDArrays,
    as the port's ``data_parallel_step`` takes them)."""
    Ws, x, y = _train_inputs()
    step = ppar.make_pipeline_step(
        lambda p, t: torch.tanh(t @ p["w"]), pmesh(4, pp=4), 2,
        lambda out, lab: ((out - lab) ** 2).mean(), lr=0.1)
    new, loss = step({"w": pt.nd.array(Ws, ctx=pt.cpu())},
                     pt.nd.array(x, ctx=pt.cpu()),
                     pt.nd.array(y, ctx=pt.cpu()))
    p_port, l_port = _port_steps(Ws, x, y, 1)
    np.testing.assert_array_equal(new["w"].numpy(), p_port)
    assert float(loss) == l_port[0]


def test_pipeline_commwatch_matches_the_reference(monkeypatch):
    """The reference's scan traces its permute once, charged
    n_micro + n_stages - 1 times; the port's loop charges the same once,
    and its backward records nothing."""
    Ws, x, y = _train_inputs()
    ref = _comm_rows(mx, lambda: _ref_steps(Ws, x, y, 1), monkeypatch)
    port = _comm_rows(pt, lambda: _port_steps(Ws, x, y, 1), monkeypatch)
    assert port == ref
    assert port == [("ppermute", "pp", 5.0, 5.0 * x[0].nbytes)]


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------
def test_moe_layer_matches_the_reference_and_the_dense_experts():
    d, dh, cap = 4, 16, 16
    rapply, rparams = rpar.make_moe_layer(rmesh(8, ep=8), d, dh, capacity=cap)
    papply, pparams = ppar.make_moe_layer(pmesh(8, ep=8), d, dh, capacity=cap)
    for k in ("w1", "w2", "wg"):
        np.testing.assert_array_equal(pparams[k].numpy(),
                                      np.asarray(rparams[k]))
    x = np.random.RandomState(2).randn(64, d).astype(np.float32)
    got = papply(pparams, torch.from_numpy(x)).asnumpy()
    np.testing.assert_allclose(
        got, np.asarray(jax.device_get(rapply(rparams, x))), **TOL)
    w1, w2, wg = (pparams[k].numpy() for k in ("w1", "w2", "wg"))
    logits = x @ wg
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    want = np.zeros_like(x)
    for t, e in enumerate(p.argmax(-1)):
        want[t] = (np.maximum(x[t] @ w1[e], 0.0) @ w2[e]) * p[t, e]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _drop_case(lib, par, mesh):
    d, cap = 4, 1
    rng = np.random.RandomState(3)
    x = rng.randn(32, d).astype(np.float32)
    gate = np.zeros((32, 8), np.float32)
    gate[:, 0] = 10.0     # every token wants expert 0

    def fn(xx, gg):
        return par.moe.moe_apply(lambda _p, tok: tok * 2.0, None, xx, gg,
                                 cap, "ep")
    f = par.shard_map(fn, mesh=mesh, in_specs=(par.P("ep"), par.P("ep")),
                      out_specs=par.P("ep"))
    if lib is mx:
        return x, np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(gate)))
    return x, f(torch.from_numpy(x), torch.from_numpy(gate)).asnumpy()


def test_moe_capacity_drops_excess_tokens_as_the_reference():
    x, got = _drop_case(pt, ppar, pmesh(8, ep=8))
    _, want = _drop_case(mx, rpar, rmesh(8, ep=8))
    np.testing.assert_allclose(got, want, **TOL)
    prob = 1.0 / (1.0 + 7 * np.exp(-10.0))
    for dev in range(8):
        blk = slice(dev * 4, dev * 4 + 4)
        np.testing.assert_allclose(got[blk][0], x[blk][0] * 2.0 * prob,
                                   rtol=1e-6)
        assert not got[blk][1:].any()


def test_moe_dispatch_is_deterministic_and_differentiable():
    """The dispatch adds in the tokens' order (bit for bit from run to
    run), and the expert weights' gradient flows back through both
    all-to-alls: equal to the dense per-token expert's."""
    d, dh, cap = 4, 8, 16
    _, params = ppar.make_moe_layer(pmesh(4, ep=4), d, dh, capacity=cap)
    x = np.random.RandomState(4).randn(32, d).astype(np.float32)
    P = ppar.P

    def body(w1, w2, wg, xx):
        ts = [a.tensor().detach().requires_grad_(True) for a in (w1, w2)]
        tx = xx.tensor()
        with torch.enable_grad():
            y = ppar.moe_apply(
                lambda p, tok: torch.relu(tok @ p[0][0]) @ p[1][0], ts,
                tx, tx @ wg.tensor(), cap, "ep")
            g = torch.autograd.grad((y ** 2).sum(), ts)
        return y, g[0], g[1]
    f = ppar.shard_map(body, mesh=pmesh(4, ep=4),
                       in_specs=(P("ep"), P("ep"), P(), P("ep")),
                       out_specs=(P("ep"), P("ep"), P("ep")))
    args = [params["w1"], params["w2"], params["wg"], torch.from_numpy(x)]
    runs = [[o.asnumpy() for o in f(*args)] for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    w1 = params["w1"].clone().requires_grad_(True)
    w2 = params["w2"].clone().requires_grad_(True)
    tx = torch.from_numpy(x)
    probs = torch.softmax(tx @ params["wg"], -1)
    e = probs.argmax(-1)
    y = torch.stack([torch.relu(tx[t] @ w1[e[t]]) @ w2[e[t]] * probs[t, e[t]]
                     for t in range(len(x))])
    g1, g2 = torch.autograd.grad((y ** 2).sum(), [w1, w2])
    np.testing.assert_allclose(runs[0][0], y.detach().numpy(), **TOL)
    np.testing.assert_allclose(runs[0][1], g1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[0][2], g2.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_commwatch_matches_the_reference(monkeypatch):
    d, dh, cap = 4, 16, 4
    x = np.random.RandomState(5).randn(64, d).astype(np.float32)
    rapply, rparams = rpar.make_moe_layer(rmesh(8, ep=8), d, dh, capacity=cap)
    papply, pparams = ppar.make_moe_layer(pmesh(8, ep=8), d, dh, capacity=cap)
    ref = _comm_rows(mx, lambda: np.asarray(rapply(rparams, x)), monkeypatch)
    port = _comm_rows(pt, lambda: papply(pparams, torch.from_numpy(x)),
                      monkeypatch)
    assert port == ref
    assert port == [("all_to_all", "ep", 2.0, 2.0 * 8 * cap * d * 4)]
