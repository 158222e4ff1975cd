"""``mxnet_tpu_torch.parallel.ring_attention`` and the differentiable
collectives under it against the reference's ``tests/test_ring_attention.py``.

The reference runs on 4 of the 8 virtual CPU devices of
``tests/conftest.py``, the port on ``cpu(0)..cpu(3)`` (one thread a
device), on the same numpy inputs. Outputs within rtol 1e-5, atol 1e-6
of the reference's; gradients within 1e-4 of its ``jax.grad``. The port
takes its gradients inside ``shard_map``'s function, on every device
(each device's loss is its block's share of the reference's whole
loss).

The last cases hold the backward's exchanges: ``ring_permute`` and
``all_to_all`` are differentiable on a 4-member mesh, ring attention's K
and V rotations are one exchange a hop inside one Function (its
gradients stay right when the devices walk their tapes in other
orders), and two independent permute chains walked in crossed orders
stop at the timeout instead of pairing one chain's cotangent with the
other's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import mxnet_tpu_torch as pt
from mxnet_tpu.parallel import shard_map as rshard_map
from mxnet_tpu.parallel import (local_attention as r_local,
                                ring_attention as r_ring,
                                ulysses_attention as r_ulysses)
from mxnet_tpu_torch import parallel as ppar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import _spmd
from mxnet_tpu_torch.parallel import collectives as pcoll

SP = 4
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SPEC = ppar.P(None, "sp", None, None)


def _qkv(b=2, t=32, h=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) * 0.3
            for _ in range(3)]


def _pmesh(n=SP):
    return ppar.make_mesh(ppar.MeshConfig(sp=n),
                          devices=[pt.cpu(i) for i in range(n)])


def _ref_sharded(fn, q, k, v, **kw):
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    spec = JP(None, "sp", None, None)
    f = rshard_map(lambda a, b, c: fn(a, b, c, axis_name="sp", **kw),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    with mesh:
        args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
                for a in (q, k, v)]
        return np.asarray(jax.jit(f)(*args))


def _port_sharded(fn, q, k, v, **kw):
    f = ppar.shard_map(lambda a, b, c: fn(a, b, c, "sp", **kw),
                       mesh=_pmesh(), in_specs=(SPEC,) * 3, out_specs=SPEC)
    return f(*[torch.from_numpy(a) for a in (q, k, v)]).asnumpy()


def _port_grads(fn, q, k, v, **kw):
    """d/d(q, k, v) of sum(out ** 2), each device differentiating its
    own block's loss."""
    def body(a, b, c):
        ts = [x.tensor().detach().requires_grad_(True) for x in (a, b, c)]
        with torch.enable_grad():
            out = fn(*ts, "sp", **kw)
            return list(torch.autograd.grad((out ** 2).sum(), ts))
    f = ppar.shard_map(body, mesh=_pmesh(), in_specs=(SPEC,) * 3,
                       out_specs=[SPEC] * 3)
    return [g.asnumpy() for g in f(*[torch.from_numpy(a)
                                     for a in (q, k, v)])]


def _ref_grads(fn, q, k, v, **kw):
    mesh = Mesh(np.array(jax.devices()[:SP]), ("sp",))
    spec = JP(None, "sp", None, None)
    f = rshard_map(lambda a, b, c: fn(a, b, c, axis_name="sp", **kw),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    with mesh:
        g = jax.grad(lambda args: (f(*args) ** 2).sum())(
            tuple(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in g]


def test_ring_attention_matches_local():
    q, k, v = _qkv()
    got = _port_sharded(ppar.ring_attention, q, k, v)
    np.testing.assert_allclose(got, _ref_sharded(r_ring, q, k, v),
                               **OUT_TOL)
    np.testing.assert_allclose(got, np.asarray(r_local(q, k, v)), **OUT_TOL)
    np.testing.assert_allclose(
        ppar.local_attention(*[torch.from_numpy(a) for a in (q, k, v)])
        .numpy(), np.asarray(r_local(q, k, v)), **OUT_TOL)


def test_ring_attention_causal():
    q, k, v = _qkv(seed=1)
    got = _port_sharded(ppar.ring_attention, q, k, v, causal=True)
    np.testing.assert_allclose(
        got, _ref_sharded(r_ring, q, k, v, causal=True), **OUT_TOL)
    # the reference test's own numpy causal attention
    t, d = q.shape[1], q.shape[-1]
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    logits = np.where(np.tril(np.ones((t, t), bool))[None, None], logits,
                      -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bhqk,bkhd->bqhd", w, v),
                               rtol=2e-4, atol=2e-5)


def test_ulysses_attention_matches_local():
    q, k, v = _qkv(seed=2)
    got = _port_sharded(ppar.ulysses_attention, q, k, v)
    np.testing.assert_allclose(got, _ref_sharded(r_ulysses, q, k, v),
                               **OUT_TOL)


@pytest.mark.parametrize("name,kw", [("ring", {}),
                                     ("ring", {"causal": True}),
                                     ("ulysses", {})])
def test_grads_match_the_reference(name, kw):
    q, k, v = _qkv(seed=3)
    pfn, rfn = {"ring": (ppar.ring_attention, r_ring),
                "ulysses": (ppar.ulysses_attention, r_ulysses)}[name]
    got = _port_grads(pfn, q, k, v, **kw)
    want = _ref_grads(rfn, q, k, v, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    if not kw:
        # and the reference test's own yardstick: local attention's grads
        ref = jax.grad(lambda a: (r_local(*a) ** 2).sum())(
            tuple(jnp.asarray(x) for x in (q, k, v)))
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def test_commwatch_counts_match_the_reference(monkeypatch):
    """One call records the reference's trace-time collectives: ring
    attention's two permutes charged sp times each, Ulysses' four
    all-to-alls; the backward records nothing."""
    import mxnet_tpu as mx
    from test_torch_pipeline_moe import _comm_rows
    q, k, v = _qkv(seed=4)
    for rfn, pfn, first in ((r_ring, ppar.ring_attention,
                             ("ppermute", "sp", 2.0 * SP)),
                            (r_ulysses, ppar.ulysses_attention,
                             ("all_to_all", "sp", 4.0))):
        ref = _comm_rows(mx, lambda: _ref_sharded(rfn, q, k, v), monkeypatch)
        port = _comm_rows(pt, lambda: _port_grads(pfn, q, k, v), monkeypatch)
        assert port == ref
        assert port[0][:3] == first


# ---------------------------------------------------------------------------
# the differentiable collectives on 4 members
# ---------------------------------------------------------------------------
def _run4(body, *arrays, spec=ppar.P("sp")):
    f = ppar.shard_map(body, mesh=_pmesh(), in_specs=(spec,) * len(arrays),
                       out_specs=spec)
    return f(*[torch.from_numpy(a) for a in arrays]).asnumpy()


@pytest.mark.parametrize("shift", [1, -1, 2])
def test_ring_permute_gradient(shift):
    """d/dx of sum(w * permute(x)): device i's block went to i + shift,
    so its gradient is the weight block of device i + shift."""
    rng = np.random.RandomState(5)
    x = rng.randn(SP * 3, 5).astype(np.float32)
    w = rng.randn(SP * 3, 5).astype(np.float32)

    def body(xb, wb):
        t = xb.tensor().detach().requires_grad_(True)
        with torch.enable_grad():
            y = pcoll.ring_permute(t, "sp", shift=shift)
            return torch.autograd.grad((y * wb.tensor()).sum(), t)[0]
    g = _run4(body, x, w)
    want = np.concatenate([w.reshape(SP, 3, 5)[(i + shift) % SP]
                           for i in range(SP)])
    np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("split,concat,tiled", [(0, 0, False), (0, 1, True),
                                                (1, 0, True)])
def test_all_to_all_gradient(split, concat, tiled):
    """The gradient of sum(w * all_to_all(x)) is all_to_all of w with the
    axes swapped, checked against the forward's own index map."""
    rng = np.random.RandomState(6)
    shape = (SP, 4, 3) if not tiled else (SP * 2, SP * 2, 3)
    x = rng.randn(SP * shape[0], *shape[1:]).astype(np.float32)
    probe = np.arange(x.size, dtype=np.float32).reshape(x.shape)

    def fwd(xb):
        return pcoll.all_to_all(xb.tensor(), "sp", split, concat, tiled)
    out_shape = _run4(fwd, x).shape
    w = rng.randn(*out_shape).astype(np.float32)

    def body(xb, wb):
        t = xb.tensor().detach().requires_grad_(True)
        with torch.enable_grad():
            y = pcoll.all_to_all(t, "sp", split, concat, tiled)
            return torch.autograd.grad((y * wb.tensor()).sum(), t)[0]
    f = ppar.shard_map(body, mesh=_pmesh(),
                       in_specs=(ppar.P("sp"), ppar.P("sp")),
                       out_specs=ppar.P("sp"))
    g = f(torch.from_numpy(x), torch.from_numpy(w)).asnumpy()
    # where each input element lands: the forward applied to its index
    idx = _run4(fwd, probe).astype(np.int64)
    want = np.zeros(x.size, np.float32)
    want[idx.reshape(-1)] = w.reshape(-1)
    np.testing.assert_array_equal(g, want.reshape(x.shape))


def test_ring_attention_gradient_whatever_the_tape_order():
    """Each device walks its tape from another loss (a device-dependent
    mix of the output and of local work on k and v): the K and V
    rotations are one exchange a hop inside the Function, so the
    gradients stay those of the whole loss."""
    q, k, v = _qkv(t=16, seed=7)
    coef = np.arange(1, SP + 1, dtype=np.float32)

    def body(a, b, c):
        ts = [x.tensor().detach().requires_grad_(True) for x in (a, b, c)]
        m = _spmd.member()
        i = m.axis_index("sp")
        with torch.enable_grad():
            out = ppar.ring_attention(*ts, "sp", causal=True)
            # devices differ in what else their tape holds, and in the
            # order their inputs are asked for
            extra = (ts[1] * ts[2]).sum() * float(coef[i])
            order = [2, 0, 1] if i % 2 else [0, 1, 2]
            grads = torch.autograd.grad((out ** 2).sum() + extra,
                                        [ts[j] for j in order])
        back = [None] * 3
        for j, g in zip(order, grads):
            back[j] = g
        return back
    f = ppar.shard_map(body, mesh=_pmesh(), in_specs=(SPEC,) * 3,
                       out_specs=[SPEC] * 3)
    got = [g.asnumpy() for g in f(*[torch.from_numpy(a)
                                    for a in (q, k, v)])]
    t_loc = q.shape[1] // SP
    w = np.repeat(coef, t_loc)[None, :, None, None]
    want = _ref_grads(r_ring, q, k, v, causal=True)
    want[1] = want[1] + v * w
    want[2] = want[2] + k * w
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g, wv, **GRAD_TOL)


def test_crossed_chains_stop_instead_of_pairing_wrong(monkeypatch):
    """Two independent permute chains differentiated in crossed orders
    (even devices A then B, odd ones B then A): paired by call order,
    the first backward exchange would join A's cotangent with B's. Keyed
    by their forward exchange, the devices wait for each other and the
    run stops at the timeout."""
    monkeypatch.setattr(_spmd, "WAIT_SECONDS", 1.0)
    rng = np.random.RandomState(8)
    a = rng.randn(SP * 2, 3).astype(np.float32)
    b = rng.randn(SP * 2, 3).astype(np.float32)

    def body(xa, xb):
        ta = xa.tensor().detach().requires_grad_(True)
        tb = xb.tensor().detach().requires_grad_(True)
        with torch.enable_grad():
            ya = pcoll.ring_permute(ta, "sp").sum()
            yb = pcoll.ring_permute(tb, "sp", shift=-1).sum()
            first, second = ((ya, ta), (yb, tb))
            if _spmd.member().axis_index("sp") % 2:
                first, second = second, first
            g1 = torch.autograd.grad(*first)[0]
            g2 = torch.autograd.grad(*second)[0]
        return g1, g2
    f = ppar.shard_map(body, mesh=_pmesh(),
                       in_specs=(ppar.P("sp"), ppar.P("sp")),
                       out_specs=(ppar.P("sp"), ppar.P("sp")))
    with pytest.raises(MXNetError, match="timed out"):
        f(torch.from_numpy(a), torch.from_numpy(b))


def test_a_backward_after_the_run_is_refused():
    """The gradient is taken inside shard_map's function: a backward
    after the run ended would wait for devices that no longer run."""
    q, k, v = [torch.from_numpy(a) for a in _qkv(t=8, seed=9)]

    def body(a, b, c):
        ts = [x.tensor().detach().requires_grad_(True) for x in (a, b, c)]
        with torch.enable_grad():
            return pcoll.ring_permute(ts[0], "sp")
    f = ppar.shard_map(body, mesh=_pmesh(), in_specs=(SPEC,) * 3,
                       out_specs=SPEC)
    out = f(q, k, v)
    with pytest.raises(MXNetError, match="inside shard_map"):
        out.tensor().sum().backward()
