"""Checkpoints in the reference's file formats, held against the
reference (mxnet_tpu) on the same numpy inputs: ``nd.save``/``nd.load``,
``Block.save_parameters``/``load_parameters``, ``ParameterDict.save``/
``load`` and the Trainer's states blob.

A file written by either package loads in the other to equal arrays,
and for the same arrays the two write the same bytes. The reference
keeps float64 and int64 arrays as float32 and int32 (JAX without x64),
so for those two dtypes its writer is fed the numpy array directly.

Trainer states: the gradients are written into the parameters directly
(no forward), so the optimizers alone are compared. The reference
trains two steps and saves; the port loads its files and trains two
more; the result is held to the reference's own resumed run within the
optimizer tests' tolerances (f32 within 1e-6 relative, 1e-7 absolute;
a float16 weight, rounded from f32 masters that agree, within one
float16 ulp). Both Trainers restart the optimizer's counters at a load
(the blob carries no optimizer), so a resumed LAMB or Adam restarts its
bias correction in both.
"""
import io
import pickle
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.base import MXNetError

DTYPES = ["float32", "float64", "float16", "bfloat16", "uint8", "int8",
          "int32", "int64", "bool"]
# what the reference holds each dtype as (JAX without x64)
REF_HOLDS = {"float64": "float32", "int64": "int32"}


@pytest.fixture(autouse=True)
def _port_config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)


def _np_arrays(dtype, seed=0):
    """A 2-D array, a 0-d one and an empty one of ``dtype``."""
    rng = np.random.RandomState(seed)
    a = rng.randn(3, 4) * 50
    if dtype == "bfloat16":
        cast = lambda x: np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    elif dtype == "bool":
        cast = lambda x: np.asarray(x) > 0
    else:
        cast = lambda x: np.asarray(x).astype(dtype)
    return {"a": cast(a), "s": cast(np.array(7.0)),
            "e": cast(np.zeros((0, 3)))}


class _Host(mx.nd.NDArray):
    """What the reference's writer reads of an array: ``asnumpy()`` (an
    NDArray by type, so a single one saves as one)."""

    def __init__(self, arr):
        self._arr = arr

    def asnumpy(self):
        return self._arr


def _ref_nd(arr):
    return mx.nd.array(arr, dtype=arr.dtype)


def _port_nd(arr):
    return pt.nd.array(arr, ctx=pt.cpu(), dtype=arr.dtype)


def _containers(arrays, make):
    return {"dict": {k: make(v) for k, v in arrays.items()},
            "list": [make(v) for v in arrays.values()],
            "single": make(arrays["a"])}


def _as_np(x):
    if isinstance(x, (pt.nd.NDArray,)):
        t = x.tensor()
        return pt.nd.host_numpy(t.detach().cpu())
    return np.asarray(x.asnumpy())


def _same(got, want, dtype=None):
    got, want = _as_np(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype is not None:
        assert got.dtype == np.dtype(dtype), (got.dtype, dtype)
    np.testing.assert_array_equal(got.astype(np.float64),
                                  want.astype(np.float64))


@pytest.mark.parametrize("kind", ["dict", "list", "single"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_save_writes_the_reference_bytes(tmp_path, dtype, kind):
    arrays = _np_arrays(dtype)
    pt.nd.save(str(tmp_path / "port"), _containers(arrays, _port_nd)[kind])
    held = _Host if dtype in REF_HOLDS else _ref_nd
    mx.nd.save(str(tmp_path / "ref"), _containers(arrays, held)[kind])
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()


@pytest.mark.parametrize("kind", ["dict", "list", "single"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_files_load_in_the_other_package(tmp_path, dtype, kind):
    arrays = _np_arrays(dtype, seed=1)
    held = _Host if dtype in REF_HOLDS else _ref_nd
    mx.nd.save(str(tmp_path / "ref"), _containers(arrays, held)[kind])
    pt.nd.save(str(tmp_path / "port"), _containers(arrays, _port_nd)[kind])
    got = pt.nd.load(str(tmp_path / "ref"), ctx=pt.cpu())
    back = mx.nd.load(str(tmp_path / "port"))
    want = list(arrays.values()) if kind != "single" else [arrays["a"]]
    if kind == "dict":
        assert list(got) == list(back) == list(arrays)
        got, back = list(got.values()), list(back.values())
    else:
        # an unnamed save loads back as a list, as in the reference
        assert isinstance(got, list) and isinstance(back, list)
    for g, b, w in zip(got, back, want):
        _same(g, w, dtype)
        assert g.context == pt.cpu()
        held = REF_HOLDS.get(dtype, dtype)
        _same(b, np.asarray(w).astype(held), held)


def test_load_places_on_the_context_given_or_current(tmp_path):
    f = str(tmp_path / "f")
    pt.nd.save(f, {"x": pt.nd.ones((2,), ctx=pt.cpu())})
    assert pt.nd.load(f, ctx=pt.cpu())["x"].context == pt.cpu()
    with pt.cpu():
        assert pt.nd.load(f)["x"].context == pt.cpu()
    if not torch.cuda.is_available():
        # the default context is the card: without one, loading raises
        # rather than landing on the CPU unasked
        with pytest.raises(MXNetError):
            pt.nd.load(f)


def _v1_file(arrays):
    """The container with legacy V1 records (no stype field)."""
    out = struct.pack("<QQQ", 0x112, 0, len(arrays))
    flags = {np.dtype("float32"): 0, np.dtype("int32"): 4}
    for a in arrays.values():
        out += struct.pack("<II", 0xF993FAC8, a.ndim)
        out += struct.pack("<%dq" % a.ndim, *a.shape)
        out += struct.pack("<iii", 2, 3, flags[a.dtype]) + a.tobytes()
    out += struct.pack("<Q", len(arrays))
    for k in arrays:
        out += struct.pack("<Q", len(k)) + k.encode()
    return out


def test_load_reads_v1_records(tmp_path):
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "i": np.array([4, 5], np.int32)}
    (tmp_path / "v1").write_bytes(_v1_file(arrays))
    for lib, kw in ((pt, {"ctx": pt.cpu()}), (mx, {})):
        got = lib.nd.load(str(tmp_path / "v1"), **kw)
        for k, a in arrays.items():
            _same(got[k], a, a.dtype)


@pytest.mark.parametrize("kind", ["single", "list", "named"])
def test_load_reads_the_npz_container(tmp_path, kind):
    a, b = np.ones((2, 2), np.float32), np.arange(3, dtype=np.float32)
    keys = {"single": {"__single__": a},
            "list": {"__list__1": b, "__list__0": a},
            "named": {"w": a, "b": b}}[kind]
    f = str(tmp_path / "f.npz")
    np.savez(f, **keys)
    got = pt.nd.load(f, ctx=pt.cpu())
    want = mx.nd.load(f)
    if kind == "single":
        _same(got, want.asnumpy())
    elif kind == "list":
        assert [g.shape for g in got] == [(2, 2), (3,)]
        for g, w in zip(got, want):
            _same(g, w.asnumpy())
    else:
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k].asnumpy())


def _record(magic=0xF993FAC9, stype=0, flag=0, payload=None):
    head = struct.pack("<QQQ", 0x112, 0, 1)
    rec = struct.pack("<Ii", magic, stype) + struct.pack("<Iq", 1, 2)
    rec += struct.pack("<iii", 1, 0, flag)
    data = np.ones(2, np.float32).tobytes() if payload is None else payload
    return head + rec + data + struct.pack("<Q", 0)


@pytest.mark.parametrize("raw,err", [
    (b"\x01\x02\x03", ValueError),
    (_record(magic=0x1234), ValueError),
    (_record(flag=9), ValueError),
    (_record(payload=b"\x00\x00"), ValueError),
    (_record(stype=1), MXNetError),
    (b"not an ndarray file at all", Exception),
])
def test_load_rejects_garbage(tmp_path, raw, err):
    f = tmp_path / "bad"
    f.write_bytes(raw)
    with pytest.raises(err):
        pt.nd.load(str(f), ctx=pt.cpu())


def test_array_of_a_0d_numpy_array_keeps_its_shape():
    """nd.array of a 0-d array is 0-d, as in the reference (np.
    ascontiguousarray made it 1-d); a pickled 0-d array comes back
    0-d."""
    for src in (np.array(3.0), np.float32(2.5), 1.5):
        assert pt.nd.array(src, ctx=pt.cpu()).shape == \
            mx.nd.array(src).shape == ()
    a = pt.nd.array(np.array(3.0, np.float32), ctx=pt.cpu())
    assert pickle.loads(pickle.dumps(a)).shape == ()


def test_pickle_keeps_bfloat16():
    a = pt.nd.array(np.arange(4, dtype=np.float32), ctx=pt.cpu()).astype(
        "bfloat16")
    b = pickle.loads(pickle.dumps(a))
    assert b.dtype == a.dtype and b._tdtype == torch.bfloat16
    _same(b, np.arange(4))


# ---------------------------------------------------------------------------
# save_parameters / load_parameters
# ---------------------------------------------------------------------------
def _bn_net(lib, prefix="cknet_"):
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(6, in_units=4), nn.BatchNorm(in_channels=6),
                nn.Dense(3, in_units=6))
    return net


def _tied_net(lib, prefix="tied_"):
    """Two Dense layers sharing one weight and bias (the PTB model's
    tied decoder)."""
    nn = lib.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        a = nn.Dense(4, in_units=4, prefix="a_")
        b = nn.Dense(4, in_units=4, prefix="a_", params=a.params)
        net.add(a, b)
    return net


def _values(seed, net):
    rng = np.random.RandomState(seed)
    return {n: (rng.rand(*p.shape) + 0.5 if n.endswith("_var")
                else rng.randn(*p.shape)).astype(np.float32)
            for n, p in net.collect_params().items()}


def _pair(build, seed=0, **kw):
    """The same net in both packages with the same values."""
    ref, port = build(mx, **kw), build(pt, **kw)
    ref.initialize()
    port.initialize(ctx=pt.cpu())
    vals = _values(seed, ref)
    assert sorted(vals) == sorted(port.collect_params())
    for lib, net in ((mx, ref), (pt, port)):
        for n, p in net.collect_params().items():
            p.set_data(vals[n])
    return ref, port, vals


def _out(lib, net, x):
    kw = {"ctx": pt.cpu()} if lib is pt else {}
    return net(lib.nd.array(x, **kw)).asnumpy()


@pytest.mark.parametrize("build,dedup", [(_bn_net, False), (_tied_net, False),
                                         (_tied_net, True)])
def test_save_parameters_writes_the_reference_bytes(tmp_path, build, dedup):
    ref, port, _ = _pair(build)
    ref.save_parameters(str(tmp_path / "ref"), deduplicate=dedup)
    port.save_parameters(str(tmp_path / "port"), deduplicate=dedup)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    names = list(pt.nd.load(str(tmp_path / "port"), ctx=pt.cpu()))
    if build is _tied_net:
        assert names == (["0.weight", "0.bias"] if dedup else
                         ["0.weight", "0.bias", "1.weight", "1.bias"])
    else:
        assert "1.running_mean" in names and "1.gamma" in names


@pytest.mark.parametrize("build,dedup", [(_bn_net, False), (_tied_net, True)])
def test_parameter_files_load_in_the_other_package(tmp_path, build, dedup):
    ref, port, vals = _pair(build, seed=1)
    ref.save_parameters(str(tmp_path / "ref"), deduplicate=dedup)
    port.save_parameters(str(tmp_path / "port"), deduplicate=dedup)
    ref2, port2, _ = _pair(build, seed=2)
    port2.load_parameters(str(tmp_path / "ref"))
    ref2.load_parameters(str(tmp_path / "port"))
    for net in (ref2, port2):
        for n, p in net.collect_params().items():
            _same(p.data(), vals[n], "float32")
    x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(_out(pt, port2, x), _out(mx, ref2, x),
                               rtol=1e-5, atol=1e-6)


def test_load_parameters_writes_in_place_and_converts(tmp_path):
    """The arrays keep their storage (a captured graph reading them stays
    valid), and take their parameter's dtype."""
    ref, port, vals = _pair(_bn_net)
    port.save_parameters(str(tmp_path / "f"))
    net = _bn_net(pt)
    net.initialize(ctx=pt.cpu())
    net.cast("bfloat16")     # BatchNorm keeps its parameters in f32
    before = {n: (p.data().tensor().data_ptr(), p.data()._tdtype)
              for n, p in net.collect_params().items()}
    assert torch.bfloat16 in {d for _, d in before.values()}
    net.load_parameters(str(tmp_path / "f"))
    for n, p in net.collect_params().items():
        ptr, dtype = before[n]
        assert p.data().tensor().data_ptr() == ptr
        assert p.data()._tdtype == dtype
        want = torch.tensor(vals[n]).to(dtype).float().numpy()
        _same(p.data().astype("float32"), want)


def test_load_parameters_cast_dtype_changes_nothing(tmp_path):
    """``cast_dtype``/``dtype_source`` are accepted and ignored, as in
    the reference: a float16 net loads an f32 file the same either
    way."""
    _, port, _ = _pair(_bn_net)
    port.save_parameters(str(tmp_path / "f"))
    got = {}
    for cast, source in ((False, "current"), (True, "saved"),
                         (True, "current")):
        for lib in (pt, mx):
            net = _bn_net(lib)
            net.initialize(**({"ctx": pt.cpu()} if lib is pt else {}))
            net.cast("float16")
            net.load_parameters(str(tmp_path / "f"), cast_dtype=cast,
                                dtype_source=source)
            got[(lib.__name__, cast, source)] = {
                n: _as_np(p.data()) for n, p in
                net.collect_params().items()}
    for lib in ("mxnet_tpu_torch", "mxnet_tpu"):
        base = got[(lib, False, "current")]
        for key, arrays in got.items():
            if key[0] != lib:
                continue
            for n in base:
                np.testing.assert_array_equal(arrays[n], base[n])
    # the port converts to the parameter's dtype in set_data
    net = _bn_net(pt)
    net.cast("float16")
    assert all(a.dtype == np.dtype(net.collect_params()[n].dtype)
               for n, a in got[("mxnet_tpu_torch", True, "saved")].items())


def test_load_parameters_missing_and_extra(tmp_path):
    _, port, _ = _pair(_bn_net)
    f = str(tmp_path / "f")
    full = pt.nd.load((port.save_parameters(f), f)[1], ctx=pt.cpu())
    part = dict(full)
    part.pop("2.bias")
    pt.nd.save(str(tmp_path / "part"), part)
    extra = dict(full, **{"3.weight": pt.nd.ones((2,), ctx=pt.cpu())})
    pt.nd.save(str(tmp_path / "extra"), extra)
    for lib in (pt, mx):
        net = _bn_net(lib)
        net.initialize(**({"ctx": pt.cpu()} if lib is pt else {}))
        with pytest.raises(AssertionError, match="2.bias missing"):
            net.load_parameters(str(tmp_path / "part"))
        net.load_parameters(str(tmp_path / "part"), allow_missing=True)
        with pytest.raises(ValueError, match="3.weight"):
            net.load_parameters(str(tmp_path / "extra"))
        net.load_parameters(str(tmp_path / "extra"), ignore_extra=True)


def test_load_parameters_resolves_prefixed_names(tmp_path):
    """Full parameter names (a ParameterDict.save file) and names
    without the block's prefix load too, in the reference's order."""
    _, port, vals = _pair(_bn_net)
    port.collect_params().save(str(tmp_path / "full"))
    port.collect_params().save(str(tmp_path / "stripped"),
                               strip_prefix="cknet_")
    for f in ("full", "stripped"):
        for lib in (pt, mx):
            net = _bn_net(lib)
            net.initialize(**({"ctx": pt.cpu()} if lib is pt else {}))
            net.load_parameters(str(tmp_path / f))
            for n, p in net.collect_params().items():
                _same(p.data(), vals[n])


def test_load_parameters_completes_deferred_shapes(tmp_path):
    _, port, vals = _pair(_bn_net)
    port.save_parameters(str(tmp_path / "f"))
    nets = {}
    for lib in (pt, mx):
        nn = lib.gluon.nn
        net = nn.HybridSequential(prefix="cknet_")
        with net.name_scope():
            net.add(nn.Dense(6), nn.BatchNorm(), nn.Dense(3))
        net.initialize(**({"ctx": pt.cpu()} if lib is pt else {}))
        net.load_parameters(str(tmp_path / "f"))
        nets[lib] = net
        for n, p in net.collect_params().items():
            assert p.shape == vals[n].shape
            _same(p.data(), vals[n])
    x = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    np.testing.assert_allclose(_out(pt, nets[pt], x), _out(mx, nets[mx], x),
                               rtol=1e-5, atol=1e-6)


def test_parameter_dict_save_and_load(tmp_path):
    ref, port, vals = _pair(_bn_net)
    ref.collect_params().save(str(tmp_path / "ref"), strip_prefix="cknet_")
    port.collect_params().save(str(tmp_path / "port"), strip_prefix="cknet_")
    assert (tmp_path / "port").read_bytes() == (tmp_path / "ref").read_bytes()
    for lib in (pt, mx):
        net = _bn_net(lib)
        net.initialize(**({"ctx": pt.cpu()} if lib is pt else {}))
        pdict = net.collect_params()
        with pytest.raises(ValueError, match="prefix"):
            pdict.save(str(tmp_path / "x"), strip_prefix="other_")
        pdict.load(str(tmp_path / "port"), restore_prefix="cknet_")
        for n, p in pdict.items():
            _same(p.data(), vals[n])
        with pytest.raises(AssertionError, match="missing"):
            pdict.load(str(tmp_path / "port"))


def test_reset_ctx_keeps_the_arrays_on_the_same_context():
    p = pt.gluon.Parameter("w", shape=(2, 3))
    p.initialize(ctx=pt.cpu())
    ptr = p.data().tensor().data_ptr()
    p.grad()[:] = 1.0
    p.reset_ctx(pt.cpu())
    assert p.data().tensor().data_ptr() == ptr
    assert float(p.grad().sum().asscalar()) == 0.0
    assert p.list_ctx() == [pt.cpu()]


# ---------------------------------------------------------------------------
# the Trainer's states
# ---------------------------------------------------------------------------
SHAPES = {"ck_w0": (5, 4), "ck_w1": (4,), "ck_w2": (3, 5)}
HP = dict(wd=0.01, rescale_grad=1.0)
OPTIMIZERS = [
    ("sgd", dict(HP, learning_rate=0.1, momentum=0.9, clip_gradient=2.0),
     "float32"),
    ("adam", dict(HP, learning_rate=0.01), "float32"),
    ("lamb", dict(HP, learning_rate=0.01, multi_precision=True), "float16"),
    ("nag", dict(HP, learning_rate=0.1, momentum=0.9), "float32"),
    ("rmsprop", dict(HP, learning_rate=0.01), "float32"),
    ("rmsprop", dict(HP, learning_rate=0.01, centered=True,
                     clip_weights=2.0), "float32"),
    ("ftrl", dict(HP, learning_rate=0.1, lamda1=0.001), "float32"),
    ("signsgd", dict(HP, learning_rate=0.01), "float32"),
    ("adagrad", dict(HP, learning_rate=0.1, clip_gradient=2.0), "float32"),
]
IDS = ["sgd", "adam", "lamb_f16_masters", "nag", "rmsprop",
       "rmsprop_centered", "ftrl", "signsgd", "adagrad"]


def _grads(seed, steps):
    rng = np.random.RandomState(seed)
    return [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
            for _ in range(steps)]


def _trainer(lib, opt, kw, dtype, weights):
    kwc = {"ctx": pt.cpu()} if lib is pt else {}
    params = []
    for n, s in SHAPES.items():
        p = lib.gluon.Parameter(n, shape=s, dtype=dtype)
        p.initialize(**kwc)
        p.set_data(lib.nd.array(weights[n], **kwc).astype(dtype))
        params.append(p)
    return params, lib.gluon.Trainer(params, opt, dict(kw))


def _steps(lib, params, trainer, grads, dtype):
    kwc = {"ctx": pt.cpu()} if lib is pt else {}
    for g in grads:
        for p in params:
            p.grad()[:] = lib.nd.array(g[p.name], **kwc).astype(dtype)
        trainer.step(1)
    return {p.name: _as_np(p.data()).astype(np.float32) for p in params}


def _close(got, want, dtype):
    for n in want:
        if dtype == "float16":
            np.testing.assert_allclose(got[n], want[n], rtol=2 ** -10,
                                       atol=2 ** -24, err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-6,
                                       atol=1e-7, err_msg=n)


def _init_weights(seed=7):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("opt,kw,dtype", OPTIMIZERS, ids=IDS)
def test_reference_states_resume_the_port(tmp_path, opt, kw, dtype):
    grads = _grads(0, 4)
    params, tr = _trainer(mx, opt, kw, dtype, _init_weights())
    mid = _steps(mx, params, tr, grads[:2], dtype)
    f = str(tmp_path / "states")
    tr.save_states(f)
    runs = {}
    for lib in (mx, pt):
        params, tr = _trainer(lib, opt, kw, dtype, mid)
        tr.load_states(f)
        assert tr.optimizer.num_update == 0
        runs[lib] = _steps(lib, params, tr, grads[2:], dtype)
    _close(runs[pt], runs[mx], dtype)


class _MapToReference(pickle.Unpickler):
    """Unpickles the port's blob with its array constructor mapped back
    to the reference's."""

    def find_class(self, module, name):
        if (module, name) == ("mxnet_tpu_torch.ndarray.ndarray", "_unpickle"):
            module = "mxnet_tpu.ndarray.ndarray"
        return super().find_class(module, name)


def _flat(state):
    if state is None:
        return [None]
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [state]


@pytest.mark.parametrize("opt,kw,dtype", OPTIMIZERS, ids=IDS)
def test_port_states_blob_reads_as_the_reference_states(opt, kw, dtype):
    grads = _grads(1, 2)
    states = {}
    for lib in (pt, mx):
        params, tr = _trainer(lib, opt, kw, dtype, _init_weights())
        _steps(lib, params, tr, grads, dtype)
        states[lib] = tr.states_blob()
    ref = pickle.loads(states[mx])
    got = _MapToReference(io.BytesIO(states[pt])).load()
    assert sorted(got) == sorted(ref)
    for i in ref:
        flat_g, flat_r = _flat(got[i]), _flat(ref[i])
        assert [type(x) for x in flat_g] == [type(x) for x in flat_r]
        for g, r in zip(flat_g, flat_r):
            if r is None:
                continue
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_allclose(np.asarray(g.asnumpy(), np.float32),
                                       np.asarray(r.asnumpy(), np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_states_blob_refuses_other_globals():
    class Evil:
        def __reduce__(self):
            import os
            return (os.system, ("echo unsafe",))

    params, tr = _trainer(pt, "sgd", {"momentum": 0.9}, "float32",
                          _init_weights())
    for obj, name in (({0: Evil()}, "system"),
                      ({0: __import__("collections").OrderedDict()},
                       "collections.OrderedDict")):
        with pytest.raises(MXNetError, match=name):
            tr.load_states_blob(pickle.dumps(obj))


def test_loaded_states_are_written_into_the_existing_tensors():
    """A Trainer that has states takes a blob's values into the same
    tensors (a captured step reading them replays the loaded values); a
    fresh one places them at the first update."""
    grads = _grads(2, 3)
    params, tr = _trainer(pt, "sgd", {"momentum": 0.9, "learning_rate": 0.1},
                          "float32", _init_weights())
    _steps(pt, params, tr, grads[:1], "float32")
    blob = tr.states_blob()
    saved = {i: _as_np(s).copy() for i, s in tr._updater.states.items()}
    _steps(pt, params, tr, grads[1:2], "float32")
    ptrs = {i: s.tensor().data_ptr() for i, s in tr._updater.states.items()}
    tr.load_states_blob(blob)
    for i, s in tr._updater.states.items():
        assert s.tensor().data_ptr() == ptrs[i]
        _same(s, saved[i], "float32")
    fresh_params, fresh = _trainer(pt, "sgd", {"momentum": 0.9}, "float32",
                                   _init_weights())
    fresh.load_states_blob(blob)
    assert fresh._updater._unplaced == set(saved)
    _steps(pt, fresh_params, fresh, grads[2:], "float32")
    assert not fresh._updater._unplaced
    assert all(s.context == pt.cpu() for s in fresh._updater.states.values())


def test_a_state_that_does_not_fit_closes_the_captured_steps(monkeypatch):
    """A loaded state that cannot be written into the existing tensors
    (here a blob without index 0, whose momentum starts anew) closes the
    optimizer's captured steps, which read the old tensors and keep them
    alive: none is left behind, the next step captures its own, and the
    run equals one with the fused step off that loaded the same blob."""
    def run(fused):
        monkeypatch.setenv("MXNET_TRAINER_FUSED_UPDATE", "1" if fused else "0")
        with pt.cpu():
            net = pt.gluon.nn.Dense(3, in_units=4, prefix="nf%d_" % fused)
            net.initialize(pt.init.Constant(0.5))
            net.hybridize(static_alloc=True, static_shape=True)
            tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
            rng = np.random.RandomState(3)
            x = pt.nd.array(rng.randn(2, 4))
            y = pt.nd.array(rng.randn(2, 3))
            lf = pt.gluon.loss.L2Loss()
            lf.hybridize()

            def step():
                with pt.autograd.record():
                    loss = lf(net(x), y)
                loss.backward()
                tr.step(2)
                return loss.asnumpy()
            for _ in range(3):
                step()
            runners = tr.optimizer.step_runners
            old = list(runners.values())
            assert len(old) == (1 if fused else 0)
            kept = {i: s for i, s in tr._updater.states.items() if i != 0}
            tr.load_states_blob(pickle.dumps(kept))
            assert runners == {} and all(r.closed for r in old)
            out = [step() for _ in range(2)]
            assert len(runners) == len(old)
            assert not any(r in old for r in runners.values())
        pt.autograd.disarm_fused_update()
        return out + [p.data().asnumpy()
                      for p in net.collect_params().values()]

    for a, b in zip(run(True), run(False)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wrapper", ["__mx_quant__", "__mx_zero_quant__"])
def test_quantize_wrapped_reference_blob_loads_its_plain_states(wrapper):
    grads = _grads(3, 2)
    params, tr = _trainer(mx, "sgd", {"momentum": 0.9}, "float32",
                          _init_weights())
    _steps(mx, params, tr, grads, "float32")
    plain = tr.states_blob()
    residual = {0: mx.nd.ones((5, 4))}
    if wrapper == "__mx_quant__":
        blob = pickle.dumps({"__mx_quant__": 1, "updater": plain,
                             "kv_residual": residual})
    else:
        blob = pickle.dumps({"__mx_zero_quant__": 1,
                             "states": pickle.loads(plain),
                             "grad_residual": residual})
    ref_states = pickle.loads(plain)
    params, ptr = _trainer(pt, "sgd", {"momentum": 0.9}, "float32",
                           _init_weights())
    ptr.load_states_blob(blob)
    assert sorted(ptr._updater.states) == sorted(ref_states)
    for i, s in ref_states.items():
        _same(ptr._updater.states[i], s.asnumpy(), "float32")


def test_bfloat16_states_keep_their_dtype(tmp_path):
    grads = _grads(4, 2)
    params, tr = _trainer(pt, "sgd", {"momentum": 0.9}, "bfloat16",
                          _init_weights())
    _steps(pt, params, tr, grads[:1], "bfloat16")
    f = str(tmp_path / "s")
    tr.save_states(f)
    ref = _MapToReference(open(f, "rb")).load()
    assert all(s.dtype == ml_dtypes.bfloat16 for s in ref.values())
    params2, tr2 = _trainer(pt, "sgd", {"momentum": 0.9}, "bfloat16",
                            _init_weights())
    tr2.load_states(f)
    for i, s in tr._updater.states.items():
        assert tr2._updater.states[i]._tdtype == torch.bfloat16
        assert torch.equal(tr2._updater.states[i].tensor(), s.tensor())


def test_dump_optimizer_is_refused():
    params, tr = _trainer(pt, "adam", {}, "float32", _init_weights())
    with pytest.raises(MXNetError, match="dump_optimizer"):
        tr._updater.get_states(dump_optimizer=True)
