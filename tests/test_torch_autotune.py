"""``mxnet_tpu_torch.autotune`` against the reference's
``tests/test_autotune.py`` (``mxnet_tpu/autotune.py``): the same
candidate grids (``build=None``) at the same peaks make the same
cost-mode choice in both packages, the measured gate keeps the default
unless a monkeypatched ``_measure`` says a candidate beats it, the cache
file has one shape (a file written by either package is read by the
other), a bogus entry or an infeasible grid gives the default, and with
``MXNET_AUTOTUNE=off`` every launch-plan function of the port returns
the plan it computed before the tuner existed, touching no table.

The reference's feasibility is its VMEM budget; the port's is what the
card can launch (the kernel's queries, shared memory within the opt-in
limit), so each package gets the grid in its own terms. The reference's
``test_attention_cost_mode_prefers_large_head_blocks`` is a known red
test of the reference and has no parity case here. No test reads a
timing.
"""
import json
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import autotune as rat
from mxnet_tpu_torch import autotune as pat
from mxnet_tpu_torch.ops import (contrib_ops, cuda_attention, cuda_dropout,
                                 cuda_epilogue, cuda_fused, cuda_norm)

PEAKS = (1e12, 1e11)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Each test starts from empty tables, off mode, no cache file and
    the same peaks in both packages."""
    monkeypatch.delenv("MXNET_AUTOTUNE", raising=False)
    monkeypatch.delenv("MXNET_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("MXNET_CHUNKED_CE_CHUNK", raising=False)
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(rat, "_peaks", lambda *a: PEAKS)
    monkeypatch.setattr(pat, "_peaks", lambda *a: PEAKS)
    rat.clear()
    pat.clear()
    yield
    rat.clear()
    pat.clear()


def _grids(feasible, builds=None):
    """The same grid in both packages' terms: candidate i of ``8 << i``
    with equal FLOPs and growing bytes; ``feasible[i]`` False puts it
    over the reference's VMEM budget and the port's shared-memory
    limit."""
    ref, port = [], []
    for i, ok in enumerate(feasible):
        b = None if builds is None else builds[i]
        ref.append(rat.Candidate(
            {"block": 8 << i}, flops=1e6, hbm_bytes=1e6 * (i + 1),
            vmem_bytes=1 if ok else rat._VMEM_BUDGET + 1, build=b))
        port.append(pat.Candidate(
            {"block": 8 << i}, flops=1e6, hbm_bytes=1e6 * (i + 1),
            smem_bytes=1 if ok else pat._SMEM_OPTIN_FALLBACK + 1, build=b))
    return ref, port


def _both(monkeypatch, mode, kernel, key, default, feasible, **kw):
    monkeypatch.setenv("MXNET_AUTOTUNE", mode)
    ref, port = _grids(feasible)
    r = rat.lookup(kernel, key, default, candidates=lambda: list(ref), **kw)
    p = pat.lookup(kernel, key, default, candidates=lambda: list(port), **kw)
    return r, p


def test_off_mode_returns_default_untouched():
    default = {"block": 123}
    for mod in (rat, pat):
        out = mod.lookup("k", {"M": 4}, default,
                         candidates=lambda: 1 / 0)
        assert out is default
        assert mod.table() == {}


def test_cost_mode_deterministic_and_feasible(monkeypatch):
    r, p = _both(monkeypatch, "cost", "k", {"M": 4}, {"block": 999},
                 [False, False, True])
    assert r == p == {"block": 32}
    # the same signature answers from the table (a raising enumerator
    # proves the grid is not enumerated again)
    for mod in (rat, pat):
        assert mod.lookup("k", {"M": 4}, {"block": 999},
                          candidates=lambda: 1 / 0) == {"block": 32}
    # a cleared table derives the same answer
    pat.clear()
    _, port = _grids([False, False, True])
    assert pat.lookup("k", {"M": 4}, {"block": 999},
                      candidates=lambda: port) == p


def test_cost_mode_ranks_on_roofline(monkeypatch):
    r, p = _both(monkeypatch, "cost", "k2", {"M": 4}, {"block": 999},
                 [True, True, True])
    assert r == p == {"block": 8}


@pytest.mark.parametrize("seed", range(8))
def test_same_grid_same_cost_choice(monkeypatch, seed):
    """Random grids with ties: both packages rank by the same roofline
    and break ties on candidate order."""
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    rnd = random.Random(seed)
    n = rnd.randint(1, 7)
    specs = [(rnd.choice([1e5, 1e6, 1e7]), rnd.choice([1e4, 1e5, 1e6]),
              rnd.random() < 0.8) for _ in range(n)]
    ref = [rat.Candidate({"i": i}, flops=f, hbm_bytes=b,
                         vmem_bytes=1 if ok else rat._VMEM_BUDGET + 1)
           for i, (f, b, ok) in enumerate(specs)]
    port = [pat.Candidate({"i": i}, flops=f, hbm_bytes=b,
                          smem_bytes=1 if ok else pat._SMEM_OPTIN_FALLBACK
                          + 1) for i, (f, b, ok) in enumerate(specs)]
    default = {"i": -1}
    r = rat.lookup("g", {"s": seed}, default, candidates=lambda: ref)
    p = pat.lookup("g", {"s": seed}, default, candidates=lambda: port)
    assert r == p
    key = "cpu|g|s=%d" % seed
    assert rat.table()[key]["score"] == pytest.approx(
        pat.table()[key]["score"])


def test_all_infeasible_falls_back_to_default(monkeypatch):
    default = {"block": 42}
    r, p = _both(monkeypatch, "cost", "k3", {"M": 4}, default,
                 [False, False, False])
    assert r == p == default
    # the port's own feasibility flag (the kernel's query) counts too
    pat.clear()
    out = pat.lookup("k3", {"M": 4}, default, candidates=lambda: [
        pat.Candidate({"block": 8}, feasible=False)])
    assert out == default


def test_cache_round_trip_between_the_packages(tmp_path, monkeypatch):
    cache = str(tmp_path / "tune.json")
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", cache)
    _, port = _grids([True, True, True])
    out = pat.lookup("k4", {"M": 8}, {"block": 999},
                     candidates=lambda: port)
    with open(cache) as f:
        data = json.load(f)
    key = pat.entry_key("k4", {"M": 8})
    assert key == rat.entry_key("k4", {"M": 8})
    assert data[key]["params"] == out
    assert set(data[key]) == {"params", "mode", "score"}
    # a fresh process of either package serves it without tuning
    pat.clear()
    assert pat.lookup("k4", {"M": 8}, {"block": 999},
                      candidates=lambda: 1 / 0) == out
    assert rat.lookup("k4", {"M": 8}, {"block": 999},
                      candidates=lambda: 1 / 0) == out
    # and a file the reference writes, the port reads
    cache2 = str(tmp_path / "tune2.json")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", cache2)
    rat.clear()
    ref, _ = _grids([False, True, True])
    out2 = rat.lookup("k5", {"M": 2}, {"block": 999},
                      candidates=lambda: ref)
    pat.clear()
    assert pat.lookup("k5", {"M": 2}, {"block": 999},
                      candidates=lambda: 1 / 0) == out2 == {"block": 16}


def test_bogus_cache_entry_falls_back(tmp_path, monkeypatch, caplog):
    cache = str(tmp_path / "tune.json")
    key = pat.entry_key("k5", {"M": 8})
    with open(cache, "w") as f:
        json.dump({key: {"params": {"block": -7}, "mode": "cost",
                         "score": 0.0}}, f)
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", cache)
    default = {"block": 64}

    def valid(p):
        return isinstance(p.get("block"), int) and p["block"] > 0
    for mod in (rat, pat):
        out = mod.lookup("k5", {"M": 8}, default,
                         candidates=lambda: 1 / 0, validate=valid)
        assert out == default
    assert any("failed validation" in r.message for r in caplog.records)
    # an unreadable file: the same
    with open(cache, "w") as f:
        f.write("{not json")
    for mod in (rat, pat):
        mod.clear()
        assert mod.lookup("k6", {"M": 8}, default) == default


def test_measure_mode_keeps_default_unless_beaten(monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "measure")

    def build():
        return (lambda: None), ()
    default = {"block": 8}
    for mod, kw in ((rat, {"vmem_bytes": 1}), (pat, {"smem_bytes": 1})):
        cands = [mod.Candidate(default, build=build, **kw),
                 mod.Candidate({"block": 16}, build=build, **kw)]
        monkeypatch.setattr(mod, "_measure", lambda c, b, **k: 1.5)
        assert mod.lookup("k7", {"M": 1}, default,
                          candidates=lambda: list(cands)) == default
        mod.clear()
        monkeypatch.setattr(mod, "_measure", lambda c, b, **k: 0.5)
        assert mod.lookup("k7", {"M": 1}, default,
                          candidates=lambda: list(cands)) == {"block": 16}
        assert mod.table()[mod.entry_key("k7", {"M": 1})]["mode"] == \
            "measure"


def test_measure_mode_default_absent_keeps_default(monkeypatch):
    r, p = _both(monkeypatch, "measure", "k7b", {"M": 1}, {"block": 999},
                 [True, True])
    assert r == p == {"block": 999}


def test_build_failure_disqualifies(monkeypatch):
    """A candidate whose runner cannot be built is never chosen; every
    candidate failing gives the default. The reference's cost mode
    compiles each probe and drops one that fails; the port's cost mode
    builds nothing (a runner allocates on the card, and a stream capture
    would record it), so the port drops such a candidate in measure
    mode, where it is built and launched, as it drops one whose launch
    fails."""
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")

    def boom():
        raise RuntimeError("no launch")
    cands = [rat.Candidate({"block": 8}, flops=1, hbm_bytes=1,
                           build=boom, vmem_bytes=1),
             rat.Candidate({"block": 16}, flops=1, hbm_bytes=2,
                           vmem_bytes=1)]
    assert rat.lookup("k9", {"M": 1}, {"block": 99},
                      candidates=lambda: list(cands)) == {"block": 16}
    rat.clear()
    assert rat.lookup("k9", {"M": 1}, {"block": 99},
                      candidates=lambda: [rat.Candidate(
                          {"block": 8}, build=boom, vmem_bytes=1)]) == \
        {"block": 99}
    # the port's cost mode calls no build
    assert pat.lookup("k9", {"M": 1}, {"block": 99},
                      candidates=lambda: [pat.Candidate(
                          {"block": 8}, flops=1, hbm_bytes=1, build=boom,
                          smem_bytes=1)]) == {"block": 8}
    pat.clear()
    monkeypatch.setenv("MXNET_AUTOTUNE", "measure")
    ok = pat.Candidate({"block": 99}, build=lambda: ((lambda: None), ()))
    unbuilt = pat.Candidate({"block": 8}, hbm_bytes=-1.0, build=boom)
    assert pat._measure(unbuilt, ok) is None
    assert pat.lookup("k9", {"M": 1}, {"block": 99},
                      candidates=lambda: [ok, unbuilt]) == {"block": 99}
    pat.clear()

    def launches_badly():
        return (lambda: 1 / 0), ()
    ok = pat.Candidate({"block": 8}, build=lambda: ((lambda: None), ()))
    bad = pat.Candidate({"block": 16}, hbm_bytes=-1.0, build=launches_badly)
    assert pat._measure(bad, ok) is None
    assert pat.lookup("k10", {"M": 1}, {"block": 8},
                      candidates=lambda: [ok, bad]) == {"block": 8}


def test_bad_mode_string_is_off(monkeypatch):
    monkeypatch.setenv("MXNET_AUTOTUNE", "turbo")
    for mod in (rat, pat):
        assert mod.mode() == "off"
        assert mod.lookup("k8", {}, {"block": 1},
                          candidates=lambda: 1 / 0) == {"block": 1}
    from mxnet_tpu_torch import config
    assert config.get("MXNET_AUTOTUNE") == "turbo"


# ---------------------------------------------------------------------------
# the port's launch plans
# ---------------------------------------------------------------------------
SMS = 132
ROW_SHAPES = [(1, 768), (5, 7), (129, 300), (1024, 768), (4096, 768),
              (4096, 3072), (1024, 3072)]
PER_SM = {1: 8, 2: 8, 4: 6}


def _plans():
    """Every plan function at a spread of shapes: (name, call, today's
    plan by the formulas the wrappers used before the tuner)."""
    out = []
    for M, C in ROW_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for al in (True, False):
                out.append(("ln_fwd", lambda M=M, C=C, dt=dt, al=al:
                            cuda_norm.fwd_plan(M, C, dt, al, SMS),
                            cuda_norm.fwd_blocks(M, C, dt, al, SMS)))
                out.append(("gelu_fwd", lambda M=M, C=C, dt=dt, al=al:
                            cuda_epilogue.fwd_plan("bias_gelu_fwd", M, C, dt,
                                                   al, SMS),
                            cuda_epilogue.fwd_strips(M, C, dt, al, SMS)))
                out.append(("residual_fwd", lambda M=M, C=C, dt=dt, al=al:
                            cuda_epilogue.fwd_plan("bias_residual_fwd", M, C,
                                                   dt, al, SMS),
                            cuda_epilogue.fwd_strips(M, C, dt, al, SMS)))
                out.append(("gelu_bwd", lambda M=M, C=C, dt=dt, al=al:
                            cuda_epilogue.bwd_plan(M, C, dt, al, SMS),
                            cuda_epilogue.bwd_scratch_shape(
                                M, C, dt, al, SMS)[0]))
                out.append(("dropout", lambda M=M, C=C, dt=dt, al=al:
                            cuda_dropout.tuned_launch_plan(
                                M * C, dt.itemsize, al, SMS, PER_SM),
                            cuda_dropout.launch_plan(M * C, dt.itemsize, al,
                                                     SMS, PER_SM)))
            out.append(("ln_bwd", lambda M=M, C=C, dt=dt:
                        cuda_norm.bwd_plan(M, C, dt, SMS),
                        cuda_norm.bwd_blocks(M, SMS)))
    for M, I, O in ((32 * 56 * 56, 64, 256), (32 * 56 * 56, 256, 64),
                    (32 * 28 * 28, 512, 128), (32 * 7 * 7, 512, 2048),
                    (100, 24, 40)):
        for emit in (False, True):
            out.append(("dual", lambda M=M, I=I, O=O, e=emit:
                        cuda_fused.tuned_dual_plan(M, I, O, SMS, e),
                        cuda_fused.dual_plan(M, I, O, SMS, emit)))
    for V in (50, 5000, 30522):
        out.append(("ce", lambda V=V: contrib_ops.ce_chunk_size(0, V, 32,
                                                                768),
                    min(4096, V)))
    return out


def test_off_mode_leaves_every_plan_as_it_was():
    for name, call, today in _plans():
        assert call() == today, name
    assert pat.table() == {}


def test_cost_mode_plans_are_valid_and_row_grids_keep_the_default(
        monkeypatch):
    """Every row kernel's candidates do the same work, so cost mode keeps
    the default there; every plan the tuner answers is one the launcher
    takes."""
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    for name, call, today in _plans():
        got = call()
        if name in ("ln_fwd", "ln_bwd", "gelu_fwd", "residual_fwd",
                    "gelu_bwd", "dropout"):
            assert got == today, name
        elif name == "dual":
            assert got["splits_w"] >= 1 and got["rows_w"] % 32 == 0
            assert got["splits_x"] >= 1 and got["depth_x"] % 32 == 0
        elif name == "ce":
            assert got >= 1
    keys = pat.table()
    assert any("|layer_norm_fwd|" in k for k in keys)
    assert not any("|selfatt" in k for k in keys)
    assert all(k.startswith("cpu|") for k in keys)


@pytest.mark.parametrize("name,bogus", [
    ("ln_fwd", {"blocks": 0}), ("ln_fwd", {"blocks": 10 ** 9}),
    ("ln_bwd", {"blocks": True}), ("gelu_bwd", {"strips": 10 ** 9}),
    ("gelu_fwd", {"strips": -3}), ("dropout", {"units": 3, "blocks": 8}),
    ("residual_fwd", {"strips": 0}),
    ("dual", {"splits_w": 0, "splits_x": 1})])
def test_plans_reject_a_bogus_cache_entry(tmp_path, monkeypatch, caplog,
                                          name, bogus):
    """A stale or hand-edited entry is warned about and the default
    plan runs: the kernel and its output never change with the table."""
    M, C = 4096, 768
    calls = {
        "ln_fwd": ("layer_norm_fwd", {"M": M, "C": C, "esize": 2,
                                      "aligned": 1},
                   lambda: cuda_norm.fwd_plan(M, C, torch.bfloat16, True,
                                              SMS),
                   cuda_norm.fwd_blocks(M, C, torch.bfloat16, True, SMS)),
        "ln_bwd": ("layer_norm_bwd", {"M": M, "C": C, "esize": 2},
                   lambda: cuda_norm.bwd_plan(M, C, torch.bfloat16, SMS),
                   cuda_norm.bwd_blocks(M, SMS)),
        "gelu_fwd": ("bias_gelu_fwd", {"M": M, "C": C, "esize": 2,
                                       "aligned": 1},
                     lambda: cuda_epilogue.fwd_plan(
                         "bias_gelu_fwd", M, C, torch.bfloat16, True, SMS),
                     cuda_epilogue.fwd_strips(M, C, torch.bfloat16, True,
                                              SMS)),
        "gelu_bwd": ("bias_gelu_bwd", {"M": M, "C": C, "esize": 2,
                                       "aligned": 1},
                     lambda: cuda_epilogue.bwd_plan(M, C, torch.bfloat16,
                                                    True, SMS),
                     cuda_epilogue.bwd_scratch_shape(
                         M, C, torch.bfloat16, True, SMS)[0]),
        "dropout": ("dropout", {"n": M * C, "esize": 2, "aligned": 1},
                    lambda: cuda_dropout.tuned_launch_plan(
                        M * C, 2, True, SMS, PER_SM),
                    cuda_dropout.launch_plan(M * C, 2, True, SMS, PER_SM)),
        "residual_fwd": ("bias_residual_fwd", {"M": M, "C": C, "esize": 2,
                                               "aligned": 1},
                         lambda: cuda_epilogue.fwd_plan(
                             "bias_residual_fwd", M, C, torch.bfloat16,
                             True, SMS),
                         cuda_epilogue.fwd_strips(M, C, torch.bfloat16,
                                                  True, SMS)),
        "dual": ("dual_bwd", {"M": M, "I": 256, "O": 64, "emit_next": 0,
                              "aligned": 1},
                 lambda: cuda_fused.tuned_dual_plan(M, 256, 64, SMS),
                 cuda_fused.dual_plan(M, 256, 64, SMS)),
    }
    kernel, key, call, today = calls[name]
    cache = str(tmp_path / "tune.json")
    with open(cache, "w") as f:
        json.dump({pat.entry_key(kernel, key): {
            "params": bogus, "mode": "measure", "score": 0.0}}, f)
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    monkeypatch.setenv("MXNET_AUTOTUNE_CACHE", cache)
    assert call() == today
    assert any("failed validation" in r.message for r in caplog.records)


def test_layer_norm_on_the_cpu_consults_nothing(monkeypatch):
    """The consults sit on the CUDA path: a CPU tensor runs the plain
    version, bit for bit in every mode, and the table stays empty."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(256, 64).astype(np.float32))
    g = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(64).astype(np.float32))
    off = cuda_norm.layer_norm(x, g, b, 1e-5)
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    assert torch.equal(cuda_norm.layer_norm(x, g, b, 1e-5), off)
    assert torch.equal(cuda_norm.layer_norm_plain(x, g, b, 1e-5), off)
    assert pat.table() == {}


def test_ce_chunk_consult_matches_the_reference(monkeypatch):
    """The chunked CE consults the tuner on the CPU too: off mode uses
    the configured chunk and records nothing; cost mode records the same
    chunk as the reference's ``_tuned_ce_chunk`` on the same grid (both
    from the analytic figures), and the losses agree."""
    from mxnet_tpu.ops.contrib_ops import chunked_lm_head_ce as rce
    monkeypatch.setattr(rat, "_aot_probe", lambda fn, args: (None,) * 3)
    rng = np.random.RandomState(1)
    T, U, V = 32, 16, 3000
    h = rng.randn(T, U).astype(np.float32)
    w = (rng.randn(V, U) * 0.05).astype(np.float32)
    b = np.zeros(V, np.float32)
    lab = rng.randint(0, V, (T,)).astype(np.int32)

    def port():
        return contrib_ops.chunked_lm_head_ce(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b),
            torch.from_numpy(lab).long()).numpy()

    def ref():
        return np.asarray(rce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(lab)))
    loss_off = port()
    assert pat.table() == {}
    for peaks in ((1e12, 1e11), (1e15, 1e9), (1e9, 1e15)):
        monkeypatch.setattr(rat, "_peaks", lambda *a: peaks)
        monkeypatch.setattr(pat, "_peaks", lambda *a: peaks)
        for env in ("1000", "4096"):
            monkeypatch.setenv("MXNET_CHUNKED_CE_CHUNK", env)
            monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
            rat.clear()
            pat.clear()
            loss_cost = port()
            want = ref()
            (pk, pv), = pat.table().items()
            (rk, rv), = rat.table().items()
            assert pk == rk
            # the roofline picks alike; where every chunk ties (the
            # products dominate) the reference takes its largest chunk
            # and the port keeps its default, listed first
            chunks = {min(int(env), V), 2048, 1024}
            ties = len({max(6.0 * T * U * V / peaks[0],
                            (3.0 * -(-V // c) * T * U + 2.0 * V * U) * 4
                            / peaks[1]) for c in chunks}) == 1
            if ties:
                assert pv["params"] == {"chunk": min(int(env), V)}
            else:
                assert pv["params"] == rv["params"], (peaks, env)
            assert pv["params"]["chunk"] >= 1
            np.testing.assert_allclose(loss_cost, want, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(loss_cost, loss_off, rtol=2e-5,
                                       atol=2e-5)


def test_attention_plan_consult_stable(monkeypatch):
    """The attention's head block names the mask's seed blocks only (the
    reference's tuned knob is a TPU block shape), so the port's tuner
    leaves it alone: in every mode the op draws the same mask from the
    same seed, and the table never names the attention kernels."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(16, 4, 4 * 3 * 64).astype(
        np.float32)).to(torch.bfloat16)
    outs = []
    for m in ("off", "cost", "measure"):
        monkeypatch.setenv("MXNET_AUTOTUNE", m)
        pat.clear()
        mx.random.seed(5)
        outs.append(contrib_ops.sdp_selfatt(qkv, heads=4, dropout=0.1,
                                            _train=True))
        assert not any("|selfatt" in k for k in pat.table())
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert not hasattr(cuda_attention, "tuned_block_heads")


def test_measure_gate_needs_a_margin(monkeypatch):
    """A measured candidate replaces the default only when it is faster
    by more than ``MEASURE_MARGIN`` and won every round: a ratio of 0.995
    (noise on a grid that does the same work) keeps the default."""
    monkeypatch.setenv("MXNET_AUTOTUNE", "measure")

    def build():
        return (lambda: None), ()
    default = {"block": 8}
    cands = [pat.Candidate(default, build=build),
             pat.Candidate({"block": 16}, build=build)]
    for ratio, want in ((0.995, default),
                        (1.0 - pat.MEASURE_MARGIN, default),
                        (0.9, {"block": 16})):
        pat.clear()
        monkeypatch.setattr(pat, "_measure", lambda c, b, r=ratio, **k: r)
        assert pat.lookup("k11", {"M": 1}, default,
                          candidates=lambda: list(cands)) == want, ratio
    # _measure: the paired median when the candidate wins every round,
    # else its worst round (at least 1)
    monkeypatch.undo()
    for rounds, want in (([0.9, 0.8, 0.85, 0.9, 0.7], 0.85),
                         ([0.5, 0.5, 0.5, 0.5, 1.2], 1.2)):
        times = iter([t for r in rounds for t in (r, 1.0)])
        monkeypatch.setattr(pat, "_time_once",
                            lambda fn, args, calls=10: next(times)
                            if calls > 1 else 0.0)
        assert pat._measure(cands[1], cands[0]) == pytest.approx(want)


def test_uncounted_is_per_thread():
    """The tuner's timing launches are not counted; another thread's
    launches in the meantime still are."""
    import threading
    from mxnet_tpu_torch.ops import cuda_build
    cuda_build.reset_launch_counts()
    with cuda_build.uncounted():
        cuda_build.count_launch("dropout")
        t = threading.Thread(target=cuda_build.count_launch,
                             args=("dropout",))
        t.start()
        t.join()
        with cuda_build.uncounted():
            cuda_build.count_launch("dropout")
        cuda_build.count_launch("dropout")
    cuda_build.count_launch("dropout")
    assert cuda_build.launch_counts()["dropout"] == 2
    cuda_build.reset_launch_counts()


def test_cached_gate_and_cpu_measure(monkeypatch):
    """The wrappers' gate is cached until ``refresh`` (chained from
    ``telemetry.refresh``) or ``clear``; a consult whose tensors are not
    on a card ranks by cost in ``measure`` mode and builds no probe."""
    from mxnet_tpu_torch import telemetry
    assert not pat.enabled()
    monkeypatch.setenv("MXNET_AUTOTUNE", "measure")
    assert not pat.enabled()
    telemetry.refresh()
    assert pat.enabled()
    monkeypatch.setenv("MXNET_AUTOTUNE", "off")
    assert pat.enabled()
    pat.clear()
    assert not pat.enabled()
    monkeypatch.setenv("MXNET_AUTOTUNE", "measure")
    monkeypatch.setattr(pat, "_measure", lambda *a, **k: 1 / 0)
    built = []
    chunk = contrib_ops.tuned_ce_chunk(
        64, 32, 20000, 4, 4096, torch.device("cpu"),
        probe=lambda q: built.append(q) or (lambda: 1 / 0))
    (entry,) = pat.table().values()
    assert entry["mode"] == "cost" and built == []
    pat.clear()
    monkeypatch.setenv("MXNET_AUTOTUNE", "cost")
    assert contrib_ops.tuned_ce_chunk(64, 32, 20000, 4, 4096,
                                      torch.device("cpu")) == chunk


def test_peaks_on_the_cpu_are_the_stated_constants(monkeypatch):
    monkeypatch.undo()
    assert pat._peaks() == (pat.CPU_PEAK_FLOPS, pat.CPU_PEAK_BW)
    assert pat._device_kind() == "cpu"
    assert pat._device_kind(torch.device("cpu")) == "cpu"
