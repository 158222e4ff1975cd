"""Six faults of the port against the reference, each held on the same
numpy inputs in both packages: ``topk``'s tie order, the dtypes of
integer reductions, integer modulo by zero, the public names module by
module, the ops the reference promotes from integers to f32, and
BERT-large in the model zoo. (The sixth, the unseeded reference weights
of the PTB, RNN and MNIST parity tests, is repaired in those files.)
"""
import importlib
import pkgutil
import types

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

CPU = pt.cpu()


def _both(fn):
    """``fn(lib, ctx)`` in each package: (reference, port)."""
    return fn(mx, mx.cpu()), fn(pt, CPU)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


# -- 1. topk puts the lowest index first among equal values -----------------
@pytest.mark.parametrize("row,dtype,k,ascend,want", [
    ([2, 2, 2, 1, 5, 5], "float32", 3, False, [4, 5, 0]),
    ([2, 2, 2, 1, 5, 5], "float32", 3, True, [3, 0, 1]),
    ([4, 4, 4, 4], "int32", 2, False, [0, 1]),
    ([4, 4, 4, 4], "int32", 2, True, [0, 1]),
])
def test_topk_tie_order(row, dtype, k, ascend, want):
    def run(lib, ctx):
        x = lib.nd.array(np.array([row, row[::-1]], dtype=dtype), ctx=ctx,
                         dtype=dtype)
        return [_np(o) for o in lib.nd.topk(x, k=k, is_ascend=ascend,
                                            ret_typ="both")]
    (rv, ri), (pv, pi) = _both(run)
    np.testing.assert_array_equal(pi[0], want)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)
    assert pv.dtype == rv.dtype


def test_topk_tie_order_along_axis_zero_and_mask_refused():
    x = np.array([[1, 3], [1, 3], [0, 3]], dtype=np.float32)

    def run(lib, ctx):
        return _np(lib.nd.topk(lib.nd.array(x, ctx=ctx), axis=0, k=2))
    ref, port = _both(run)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, [[0, 0], [1, 1]])
    for lib, ctx in ((mx, mx.cpu()), (pt, CPU)):
        with pytest.raises(ValueError, match="ret_typ"):
            lib.nd.topk(lib.nd.array(x, ctx=ctx), k=1, ret_typ="mask")


# -- 2. integer reductions keep the reference's dtypes -----------------------
_INTS = {"int32": np.random.RandomState(3).randint(-5, 5, (3, 4, 5)),
         "uint8": np.random.RandomState(4).randint(0, 255, (3, 4, 5))}


@pytest.mark.parametrize("dtype", sorted(_INTS))
@pytest.mark.parametrize("op", ["sum", "prod", "nansum", "nanprod"])
@pytest.mark.parametrize("axis", [None, 1, (0, 2)])
def test_integer_sums_and_products_keep_the_dtype(op, dtype, axis):
    x = _INTS[dtype].astype(dtype)
    if op in ("prod", "nanprod"):
        x = np.clip(x, 0, 2).astype(dtype)

    def run(lib, ctx):
        return _np(getattr(lib.nd, op)(lib.nd.array(x, ctx=ctx, dtype=dtype),
                                       axis=axis))
    ref, port = _both(run)
    assert port.dtype == ref.dtype == (np.int32 if dtype == "int32"
                                       else np.uint32)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("dtype", sorted(_INTS))
@pytest.mark.parametrize("axis", [None, 1])
def test_integer_mean_and_moments_are_f32(dtype, axis):
    x = _INTS[dtype].astype(dtype)

    def run(lib, ctx):
        a = lib.nd.array(x, ctx=ctx, dtype=dtype)
        m, v = lib.nd.moments(a, axes=(0, 1))
        return _np(lib.nd.mean(a, axis=axis)), _np(m), _np(v)
    ref, port = _both(run)
    for p, r in zip(port, ref):
        assert p.dtype == r.dtype == np.float32
        # within a few f32 ulps: the reference divides by a product
        # with the reciprocal and sums in another order
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=0)
    if dtype == "int32" and axis is None:
        np.testing.assert_allclose(port[0], [x.astype(np.float64).mean()],
                                   rtol=2e-7)


# -- 3. integer modulo by zero answers 0 --------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "uint8"])
def test_integer_modulo_by_zero_is_zero(dtype):
    a = np.array([5, 7, 0, 9, 3], dtype=dtype)
    b = np.array([0, 3, 0, 2, 0], dtype=dtype)

    def run(lib, ctx):
        x = lib.nd.array(a, ctx=ctx, dtype=dtype)
        y = lib.nd.array(b, ctx=ctx, dtype=dtype)
        return [_np(o) for o in (
            x % y, lib.nd.broadcast_mod(x, y), x % 0, 5 % y,
            lib.nd._mod_scalar(x, scalar=0), lib.nd._rmod_scalar(y, scalar=5),
            lib.nd._mod(x, y))]
    ref, port = _both(run)
    for p, r in zip(port, ref):
        assert p.dtype == r.dtype
        np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(port[0], [0, 1, 0, 1, 0])
    np.testing.assert_array_equal(port[2], [0, 0, 0, 0, 0])


# -- 4. public names, module by module ----------------------------------------
# Each exception is a name of a module the port does not have yet, or a
# name tied to JAX or the TPU that has a counterpart of another name.
_EXCEPTIONS = {
    "": {"Symbol": "item 16 (symbol)",
         "is_np_array": "item 16 (util, numpy)",
         "tpu": "TPU-specific (the port has gpu)",
         "num_tpus": "TPU-specific (the port has num_gpus)"},
    ".autograd": {"get_symbol": "item 16 (symbol)"},
    # the reference tunes TPU row blocks; the port tunes each kernel's
    # launch plan through tuned_plan
    ".autotune": {"tuned_rows": "TPU-specific (row blocks; the port's "
                                "launch plans go through tuned_plan)"},
    ".compilewatch": {"WatchedJit": "JAX-specific (the port watches "
                                    "capture sites, Watch)",
                      "watched_jit": "JAX-specific"},
    ".context": {"tpu": "TPU-specific", "num_tpus": "TPU-specific"},
    ".gluon": {"SymbolBlock": "item 16 (symbol)"},
    # the reference's kvstore "tpu" is registered as "nccl" (a registry
    # name, tests/test_torch_kvstore.py), and its mesh cache is JAX's
    ".kvstore": {"device_mesh": "JAX-specific (a jax Mesh cache; the "
                                "grouped reduce takes CUDA devices)"},
    ".gluon.block": {"SymbolBlock": "item 16 (symbol)"},
    ".ndarray": {n: "item 16 (sparse, quantization)" for n in (
        "CSRNDArray", "RowSparseNDArray", "dequantize", "quantize_v2",
        "quantized_conv", "quantized_fully_connected",
        "sparse_adagrad_update")},
    ".ops.optimizer_ops": {"sparse_adagrad_update": "item 16 (sparse)"},
    ".random": {"take_key": "JAX-specific (keys; the port has generators)"},
    ".rtc": {"PallasKernel": "JAX-specific (the port has CudaKernel)",
             "PallasModule": "JAX-specific (the port has CudaModule)"},
    ".scan": {"FusedPrep": "JAX-specific (the port captures CUDA graphs)"},
    ".symbol": {n: "item 16 (symbol)" for n in (
        "Group", "Symbol", "Variable", "compile_graph", "load", "load_json",
        "var")},
}
# The op modules are compared name by name through the registry
# (tests/test_torch_ops_registry.py): their module attributes are the
# reference's implementation functions and jit helpers.
_SKIP_PREFIX = ".ops"
_KEEP = (".ops.optimizer_ops",)


def _public(mod):
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    root = mod.__name__.split(".")[0]
    out = set()
    for k, v in vars(mod).items():
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        m = getattr(v, "__module__", None)
        if m is not None and not m.startswith(root):
            continue
        out.add(k)
    return out


def _modules(pkg):
    out = {"": pkg.__name__}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[info.name[len(pkg.__name__):]] = info.name
    return out


def _shared_modules():
    ref, port = _modules(mx), _modules(pt)
    return sorted(k for k in set(ref) & set(port)
                  if k in _KEEP or not (k == _SKIP_PREFIX
                                        or k.startswith(_SKIP_PREFIX + ".")))


@pytest.mark.parametrize("name", _shared_modules())
def test_public_names_match_the_reference(name):
    ref = importlib.import_module("mxnet_tpu" + name)
    port = importlib.import_module("mxnet_tpu_torch" + name)
    allowed = _EXCEPTIONS.get(name, {})
    missing = {n for n in _public(ref) - set(allowed) if not hasattr(port, n)}
    assert not missing, "%s lacks %s" % (name or "<top>", sorted(missing))
    # every listed exception is still a real gap (stale entries go)
    for n in allowed:
        assert n in _public(ref) and not hasattr(port, n), (name, n)


def test_the_new_names_work():
    assert pt.Monitor is pt.monitor.Monitor
    assert pt.Optimizer is pt.optimizer.Optimizer
    assert pt.GradGuard is pt.guardrails.GradGuard
    assert pt.save_checkpoint is pt.model.save_checkpoint
    assert pt.load_latest_checkpoint is pt.model.load_latest_checkpoint
    e = pt.nd.empty((2, 3), ctx=CPU, dtype="int32")
    assert e.shape == (2, 3) and e.dtype == np.int32
    x = pt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    y = pt.nd.from_dlpack(pt.nd.to_dlpack_for_write(x))
    y[:] = 7
    np.testing.assert_array_equal(x.asnumpy(), np.full((2, 3), 7))
    z = pt.nd.from_dlpack(np.arange(4, dtype=np.int32))
    np.testing.assert_array_equal(z.asnumpy(), np.arange(4))
    np.testing.assert_array_equal(
        pt.nd.from_dlpack(pt.nd.to_dlpack_for_read(x)).asnumpy(), x.asnumpy())
    d = pt.init.InitDesc("w_weight", {"__init__": ""})
    assert d == "w_weight" and d.attrs == {"__init__": ""}
    assert pt.base.string_types == mx.base.string_types
    assert "| `MXNET_TRACE` |" in pt.config.describe()
    assert isinstance(pt.nd.array([1], ctx=CPU), pt.gluon.parameter.tensor_types)
    before = pt.compilewatch.compile_seconds_total()
    pt.compilewatch.note_external_compile(0.25)
    assert pt.compilewatch.compile_seconds_total() == pytest.approx(
        before + 0.25)


def test_env_helpers_agree(monkeypatch):
    for raw in ("1", "0", "false", "7", "x"):
        monkeypatch.setenv("MXNET_TEST_ENV_HELPER", raw)
        assert pt.base.env_bool("MXNET_TEST_ENV_HELPER") == \
            mx.base.env_bool("MXNET_TEST_ENV_HELPER")
        assert pt.base.env_int("MXNET_TEST_ENV_HELPER", 3) == \
            mx.base.env_int("MXNET_TEST_ENV_HELPER", 3)
        assert pt.base.getenv("MXNET_TEST_ENV_HELPER") == \
            mx.base.getenv("MXNET_TEST_ENV_HELPER")
    pt.config.setenv("MXNET_TEST_ENV_HELPER", "5")
    assert mx.config.getenv_raw("MXNET_TEST_ENV_HELPER") == "5"
    assert pt.config.getenv_raw("MXNET_TEST_ENV_ABSENT", "d") == "d"


def test_bert_large_at_a_narrow_width(pallas_interpret, monkeypatch):
    """``bert_24_1024_16`` asks both packages' BERTModel for the same
    configuration; at a narrow width with its 16 heads, the two models
    serve the same outputs on the same weights."""
    from mxnet_tpu.gluon.model_zoo import bert as rbert
    from mxnet_tpu_torch.gluon.model_zoo import bert as pbert
    seen = []
    for mod in (rbert, pbert):
        monkeypatch.setattr(mod, "BERTModel",
                            lambda **kw: seen.append(kw) or kw)
        mod.bert_24_1024_16(prefix="bl_")
    assert seen[0] == seen[1]
    assert (seen[0]["num_layers"], seen[0]["units"], seen[0]["num_heads"],
            seen[0]["hidden_size"]) == (24, 1024, 16, 4096)
    monkeypatch.undo()
    kw = dict(seen[0], num_layers=2, units=64, hidden_size=128,
              vocab_size=100, max_length=32, dropout=0.0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 100, (2, 8)).astype(np.float32)
    tok = rng.randint(0, 2, (2, 8)).astype(np.float32)
    ref = rbert.BERTModel(**kw)
    ref.initialize()
    ref(mx.nd.array(ids), mx.nd.array(tok))
    port = pbert.BERTModel(**kw)
    pt.params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                ref.collect_params().items()}, ctx=CPU)
    r = ref(mx.nd.array(ids), mx.nd.array(tok))
    p = port(pt.nd.array(ids, ctx=CPU), pt.nd.array(tok, ctx=CPU))
    for a, b in zip(r, p):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=1e-4,
                                   atol=1e-4)


# -- 5. the ops the reference promotes from integers ---------------------------
def _promoted(lib, ctx, dtype):
    nd = lib.nd
    x = _INTS[dtype][:, :, :4].astype(dtype)
    a = nd.array(x, ctx=ctx, dtype=dtype)
    lab = nd.array(np.zeros(12, dtype=dtype), ctx=ctx, dtype=dtype)
    flat = a.reshape((12, 4))
    return {
        "softmax": nd.softmax(a), "log_softmax": nd.log_softmax(a),
        "softmin": nd.softmin(a), "SoftmaxActivation": nd.SoftmaxActivation(a),
        "SoftmaxOutput": nd.SoftmaxOutput(flat, lab),
        "softrelu": nd.softrelu(a), "log_sigmoid": nd.log_sigmoid(a),
        "broadcast_hypot": nd.broadcast_hypot(a, a),
        "_hypot": nd._hypot(a, a), "_hypot_scalar": nd._hypot_scalar(a, scalar=2),
        "multi_l2_norm": nd.multi_l2_norm(a, a, num_arrays=2),
        "multi_finite_norm": nd.multi_finite_norm(a, a, num_arrays=2),
        "multi_update_norm": nd.multi_update_norm(a, a + 1, num_arrays=2),
    }


# ops whose reference wraps uint8 arithmetic (x - max, -x) before it
# promotes: no oracle on uint8 there
_WRAPS_ON_UINT8 = ("softmax", "log_softmax", "softmin", "SoftmaxActivation",
                   "SoftmaxOutput", "log_sigmoid")


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
def test_integer_inputs_the_reference_promotes(dtype):
    ref, port = _both(lambda lib, ctx: _promoted(lib, ctx, dtype))
    assert sorted(port) == sorted(ref) and len(port) == 13
    for name in ref:
        r, p = _np(ref[name]), _np(port[name])
        assert p.dtype == r.dtype == np.float32, name
        if dtype == "uint8" and name in _WRAPS_ON_UINT8:
            continue
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6, err_msg=name)


def test_uint8_softmax_family_a_pinned_gap():
    """On uint8 the reference wraps ``x - max`` (and ``-x``) in uint8
    before it promotes, and answers NaN or -inf; the port promotes first,
    so its uint8 answers are the reference's answers on the same values
    held as int32."""
    ref8 = _promoted(mx, mx.cpu(), "uint8")
    port8 = _promoted(pt, CPU, "uint8")

    def as_int32(lib, ctx):
        orig = _INTS["int32"]
        try:
            _INTS["int32"] = _INTS["uint8"]
            return _promoted(lib, ctx, "int32")
        finally:
            _INTS["int32"] = orig
    ref32 = as_int32(mx, mx.cpu())
    for name in _WRAPS_ON_UINT8:
        p, r32 = _np(port8[name]), _np(ref32[name])
        assert np.isfinite(p).all(), name
        np.testing.assert_allclose(p, r32, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        assert not np.allclose(_np(ref8[name]), r32, equal_nan=False), name


def test_norm_of_uint8_is_computed_in_f32_a_pinned_gap():
    """The reference squares uint8 in uint8 and wraps, so it has no oracle
    here; the port computes in f32 and gives the true norm."""
    x = _INTS["uint8"].astype(np.uint8)
    ref, port = _both(lambda lib, ctx: _np(lib.nd.norm(
        lib.nd.array(x, ctx=ctx, dtype="uint8"))))
    true = np.sqrt((x.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(port, [true], rtol=1e-6)
    assert abs(float(ref[0]) - true) > 1.0
    # on int32 data both give the true norm
    xi = _INTS["int32"].astype(np.int32)
    ref, port = _both(lambda lib, ctx: _np(lib.nd.norm(
        lib.nd.array(xi, ctx=ctx, dtype="int32"))))
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=1e-6)


# -- 6. the Embedding gradient on the CPU is the same run to run --------------
def test_embedding_grad_is_the_same_run_to_run_on_the_cpu():
    """The weight gradient of ``Embedding`` adds the rows of repeated ids
    in one order on the CPU too (``index_put_(accumulate=True)`` adds
    them with atomics over the CPU's threads, which differed in the last
    bits between runs at BERT's width); within 1e-5 of the reference's."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 300, (64, 128)).astype(np.int32)
    w = rng.randn(300, 768).astype(np.float32)
    dy = rng.randn(64, 128, 768).astype(np.float32)

    def grad(lib):
        kw = {"ctx": CPU} if lib is pt else {}
        wt = lib.nd.array(w, **kw)
        wt.attach_grad()
        with lib.autograd.record():
            out = lib.nd.Embedding(lib.nd.array(ids, dtype="int32", **kw),
                                   wt, input_dim=300, output_dim=768)
        out.backward(lib.nd.array(dy, **kw))
        return wt.grad.asnumpy()
    got = [grad(pt) for _ in range(3)]
    assert all(g.tobytes() == got[0].tobytes() for g in got[1:])
    np.testing.assert_allclose(got[0], grad(mx), rtol=1e-5, atol=1e-5)
