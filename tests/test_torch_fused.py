"""The port's fused ResNet bottleneck module (``ops/cuda_fused.py``)
against the reference's ``ops/pallas_fused.py``.

On the CPU ``dual_bwd`` runs its kernel's plain version, so these tests
hold that plain version against the reference's Pallas kernel
(``pallas_fused._dual_bwd``) run in interpret mode, variant by variant,
and the port's ``conv1x1_bn_act``, ``bottleneck_v1_block`` and
``fused_stage`` against the reference's same functions (whose backwards
reach that kernel) on the same numpy inputs.

Tolerances. The kernel against the reference's kernel: bf16 outputs
within 1e-2 + 1e-2·|ref|, f32 sums (dW, the chaining sums) within 1e-3
of the largest value: the two differ only in the order of f32 sums. The
fused functions: both packages round at the same points (bf16 storage,
cdy rounded once), but their convolutions and statistics add in another
order, and a one-ulp flip in a bf16 activation moves everything after
it. bf16: outputs within 2 bf16 ulps (2^-7 relative) + 1e-2 of the
output's scale, statistics within 1e-3 of their scale, each gradient
within 2e-2 relative L2 (the bound of tests/test_torch_bert_train_bf16.py;
the largest reading here 5.4e-3). f32: the kernel still rounds its
operands to bf16 in both packages, so a flip there costs about 2^-8 of
one element: outputs and statistics within 1e-5 (abs + rel), gradients
within 5e-4 relative L2 (the largest reading 5.9e-5).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.ops.pallas_fused as rf

from mxnet_tpu_torch.ops import cuda_fused as pf

M, I, O = 256, 32, 64
VARIANTS = [
    # (mask_mode, has_addend, emit_jg, emit_next): the ones the block and
    # stage backwards use, then every option at once
    ("scale_shift", False, False, False),   # conv1x1_bn_act, relu
    ("none", False, False, False),          # chained tail
    ("out", False, True, False),            # block tail
    ("scale_shift", True, False, False),    # head with the shortcut
    ("none", True, False, False),           # downsample
    ("scale_shift", True, False, True),     # chained head
    ("scale_shift", False, False, True),    # chained head of a ds block
    ("out", True, True, True),
]


def _bf16(a):
    return a.astype(jnp.bfloat16)


def _torch(a):
    """A jax array as a torch tensor of the same dtype and values."""
    a = np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _close_bf16(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert (err <= 1e-2 + 1e-2 * np.abs(ref)).all(), err.max()


def _close_sum(got, ref, rel=1e-3):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("mask_mode,has_addend,emit_jg,emit_next", VARIANTS)
def test_dual_bwd_plain_matches_pallas_kernel(pallas_interpret, mask_mode,
                                              has_addend, emit_jg,
                                              emit_next):
    rng = np.random.RandomState(20)
    jg, y = (_bf16(jnp.asarray(rng.randn(M, O), jnp.float32)) for _ in "ab")
    x = _bf16(jnp.asarray(rng.randn(M, I), jnp.float32))
    w = _bf16(jnp.asarray(rng.randn(I, O) / np.sqrt(I), jnp.float32))
    coef = np.zeros((8, O), np.float32)
    coef[:5] = rng.randn(5, O) * np.array([[1.0], [0.1], [0.1], [1.0],
                                           [0.5]])
    coef = jnp.asarray(coef)
    args = [jg, y, x, w, coef]
    kw = {}
    if mask_mode == "out":
        args.append(_bf16(jnp.asarray(rng.randn(M, O), jnp.float32)))
        kw["mask"] = _torch(args[-1]).bfloat16()
    if has_addend:
        args.append(_bf16(jnp.asarray(rng.randn(M, I), jnp.float32)))
        kw["addend"] = _torch(args[-1]).bfloat16()
    if emit_next:
        y3p = _bf16(jnp.asarray(rng.randn(M, I), jnp.float32))
        mprev = jnp.asarray(rng.randn(I) * 0.1, jnp.float32)
        args += [y3p, jnp.concatenate([mprev[None],
                                       jnp.zeros((7, I), jnp.float32)])]
        kw.update(y3p=_torch(y3p).bfloat16(), mprev=_torch(mprev))
    call = rf._dual_bwd(M, I, O, mask_mode, has_addend, emit_jg, emit_next,
                        True)
    assert call is not None     # _pick_bm has a tile for this shape
    ref = list(call(*args))
    got = pf.dual_bwd(_torch(jg).bfloat16(), _torch(y).bfloat16(),
                      _torch(x).bfloat16(), _torch(w).bfloat16(),
                      _torch(coef), mask_mode, emit_jg=emit_jg, **kw)
    dx, dw, jg_out, sums = got
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _close_bf16(dx, ref.pop(0))
    _close_sum(dw, ref.pop(0))
    if emit_jg:
        # the masked jg is exact: a select of bf16 values
        np.testing.assert_array_equal(_np(jg_out), _np(ref.pop(0)))
    else:
        assert jg_out is None
    if emit_next:
        ref_sums = ref.pop(0)
        _close_sum(sums[0], ref_sums[0])
        _close_sum(sums[1], ref_sums[1])
    else:
        assert sums is None


# ---------------------------------------------------------------------------
# the fused functions against the reference's
# ---------------------------------------------------------------------------
def _mk(rng, i, o, k=1):
    if k == 1:
        return (rng.randn(i, o) * np.sqrt(2.0 / i)).astype(np.float32)
    return (rng.randn(k, k, i, o) * np.sqrt(2.0 / (i * k * k))) \
        .astype(np.float32)


def _bnp(rng, c):
    return ((rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


def _block_params(rng, i, c, o, with_ds):
    ps = [_mk(rng, i, c), *_bnp(rng, c), _mk(rng, c, c, 3), *_bnp(rng, c),
          _mk(rng, c, o), *_bnp(rng, o)]
    if with_ds:
        ps += [_mk(rng, i, o), *_bnp(rng, o)]
    return ps


def _run_both(fn_ref, fn_port, x, params, head, dtype):
    """Outputs and gradients of sum(out.f32 * head) w.r.t. x and every
    parameter, in both packages; returns ((outs, grads) ref, port)."""
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)
    jps = [jnp.asarray(p) for p in params]
    jhead = jnp.asarray(head)

    def loss_ref(x_, *ps):
        out, stats = fn_ref(jax, x_, ps)
        return jnp.sum(out.astype(jnp.float32) * jhead), (out, stats)

    (_, (out, stats)), grads = jax.value_and_grad(
        loss_ref, argnums=tuple(range(len(jps) + 1)), has_aux=True)(jx, *jps)
    ref = ([out] + list(jax.tree_util.tree_leaves(stats)), list(grads))

    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))) \
        .to(getattr(torch, dtype)).requires_grad_()
    tps = [torch.from_numpy(p).requires_grad_() for p in params]
    out, stats = fn_port(torch, tx, tps)
    loss = (out.float() * torch.from_numpy(head)).sum()
    tgrads = torch.autograd.grad(loss, [tx] + tps)
    return ref, ([out] + jax.tree_util.tree_leaves(stats), list(tgrads))


def _assert_matches(ref, port, dtype):
    (r_outs, r_grads), (p_outs, p_grads) = ref, port
    assert len(r_outs) == len(p_outs) and len(r_grads) == len(p_grads)
    for i, (a, b) in enumerate(zip(p_outs, r_outs)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and np.isfinite(a).all(), i
        scale = np.abs(b).max()
        if dtype == "bfloat16" and i == 0:
            tol = 2 ** -7 * np.abs(b) + 1e-2 * scale
        else:
            tol = 1e-5 * (scale + np.abs(b)) if dtype == "float32" else \
                1e-3 * scale
        assert (np.abs(a - b) <= tol).all(), (i, np.abs(a - b).max())
    bound = 2e-2 if dtype == "bfloat16" else 5e-4
    for i, (a, b) in enumerate(zip(p_grads, r_grads)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and np.isfinite(a).all(), i
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= bound, (i, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv1x1_bn_act_matches_reference(pallas_interpret, relu, dtype):
    rng = np.random.RandomState(21)
    x = rng.randn(4, 8, 8, I).astype(np.float32)
    params = [_mk(rng, I, O), *_bnp(rng, O)]
    head = rng.randn(4, 8, 8, O).astype(np.float32)

    def run(lib, x_, ps):
        fn = rf.conv1x1_bn_act if lib is jax else pf.conv1x1_bn_act
        out, mean, var = fn(x_, *ps, relu=relu)
        return out, (mean, var)
    ref, port = _run_both(run, run, x, params, head, dtype)
    _assert_matches(ref, port, dtype)
    assert port[0][0].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NHWC", "HWNC"])
@pytest.mark.parametrize("has_ds", [False, True])
def test_bottleneck_block_matches_reference(pallas_interpret, has_ds, fmt,
                                            dtype):
    rng = np.random.RandomState(22)
    c, o = 8, 32
    params = _block_params(rng, I, c, o, has_ds)
    x = rng.randn(8, 8, 4, I).astype(np.float32)
    head = rng.randn(8, 8, 4, o).astype(np.float32)
    if fmt == "NHWC":
        x, head = x.transpose(2, 0, 1, 3).copy(), head.transpose(2, 0, 1, 3) \
            .copy()

    def run(lib, x_, ps):
        fn = rf.bottleneck_v1_block if lib is jax else pf.bottleneck_v1_block
        return fn(x_, tuple(ps), data_format=fmt, has_ds=has_ds)
    ref, port = _run_both(run, run, x, params, head, dtype)
    _assert_matches(ref, port, dtype)


def _stage_blocks(rng):
    c, o = 8, 32
    return [_block_params(rng, I, c, o, True), _block_params(rng, o, c, o,
                                                              False),
            _block_params(rng, o, c, o, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stage_matches_reference(pallas_interpret, dtype):
    rng = np.random.RandomState(23)
    blocks = _stage_blocks(rng)
    flat = [p for b in blocks for p in b]
    x = rng.randn(8, 8, 4, I).astype(np.float32)
    head = rng.randn(8, 8, 4, 32).astype(np.float32)

    def run(lib, x_, ps):
        fn = rf.fused_stage if lib is jax else pf.fused_stage
        return fn(x_, (ps[:12], ps[12:21], ps[21:30]), data_format="HWNC",
                  ds_first=True)
    ref, port = _run_both(run, run, x, flat, head, dtype)
    _assert_matches(ref, port, dtype)


def test_fused_stage_matches_chained_block_refs(monkeypatch):
    """The stage's chained backward (pre-masked gradients, phase-A sums
    handed from block to block) against autograd of three chained
    unfused blocks, in f32 with the dual backward unrounded, as the
    reference's own test holds it (rtol 1e-4 on the loss, 5e-3 of the
    largest element on each gradient)."""
    monkeypatch.setattr(pf, "_run_dual",
                        functools.partial(pf._run_dual, rounding=False))
    rng = np.random.RandomState(3)
    blocks = _stage_blocks(rng)
    flat = [torch.from_numpy(p).requires_grad_() for b in blocks for p in b]
    x = torch.from_numpy(rng.randn(8, 8, 4, I).astype(np.float32)) \
        .requires_grad_()
    head = torch.from_numpy(rng.randn(8, 8, 4, 32).astype(np.float32))
    out, _ = pf.fused_stage(x, (flat[:12], flat[12:21], flat[21:30]),
                            data_format="HWNC", ds_first=True)
    l1 = (out * head).sum()
    g1 = torch.autograd.grad(l1, [x] + flat)
    ref = x
    for ps, ds in ((flat[:12], True), (flat[12:21], False),
                   (flat[21:30], False)):
        ref, _ = pf.bottleneck_v1_block_ref(ref, ps, data_format="HWNC",
                                            has_ds=ds)
    l2 = (ref * head).sum()
    g2 = torch.autograd.grad(l2, [x] + flat)
    np.testing.assert_allclose(float(l1.detach()), float(l2.detach()),
                               rtol=1e-4)
    for i, (a, b) in enumerate(zip(g1, g2)):
        assert float((a - b).abs().max() / (b.abs().max() + 1e-9)) < 5e-3, i


def test_1x1_weight_layouts_agree():
    """[I,O], HWIO and OIHW 1x1 kernels give the same result."""
    rng = np.random.RandomState(24)
    x = torch.from_numpy(rng.randn(2, 4, 4, 8).astype(np.float32))
    w = torch.from_numpy(_mk(rng, 8, 16))
    g, b = (torch.from_numpy(v) for v in _bnp(rng, 16))
    outs = [pf.conv1x1_bn_act(x, ww, g, b)[0]
            for ww in (w, w.reshape(1, 1, 8, 16), w.t().reshape(16, 8, 1, 1))]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
