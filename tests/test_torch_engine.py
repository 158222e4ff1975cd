"""The port's dependency engine (``mxnet_tpu_torch/engine.py`` over
``mxnet_tpu_torch/csrc/engine.cc``) against the reference's
(``mxnet_tpu/engine.py`` over its built ``native/libmxtpu_engine.so``):
every case of the reference's ``tests/test_engine.py``, run on both
engines with the same push sequences, must give the same orders, the
same errors and the same messages (the pushes go through one helper, so
the enqueue sites the messages name are equal too), and ``MXGetVersion``
the same version. Then what the port adds to check: poison along
dependency edges, the watchdog, the fault-injection sites, the facade
(``NaiveEngine``, ``waitall``) and a failed build raising.

No tolerance: every comparison is exact. Timings are bounds with wide
margins (a 0.05 s sleep must make two reads overlap on a 3-worker pool).
"""
import ctypes
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.engine import NativeDependencyEngine as RefEngine

import mxnet_tpu_torch as pt
from mxnet_tpu_torch import engine as port_engine
from mxnet_tpu_torch import faultinject, native
from mxnet_tpu_torch.engine import NativeDependencyEngine as PortEngine

ENGINES = {"ref": (RefEngine, mx.MXNetError),
           "port": (PortEngine, pt.MXNetError)}


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    yield


def _both(case, **kw):
    """``case(engine, error_type)`` on a 3-worker engine of each package;
    returns {"ref": result, "port": result}."""
    out = {}
    for name, (cls, err) in ENGINES.items():
        e = cls(num_workers=kw.get("workers", 3),
                naive=kw.get("naive", False))
        try:
            out[name] = case(e, err)
        finally:
            e.close()
    return out


def _push(eng, fn, reads=(), writes=(), label=None):
    """Every push of these tests: one enqueue site for both engines."""
    eng.push_async(fn, read_vars=list(reads), write_vars=list(writes),
                   label=label)


def _raised(call):
    try:
        call()
    except BaseException as e:  # noqa: BLE001 - compared by value
        return type(e), str(e), type(e.__cause__)
    return None


def test_write_ordering_single_var():
    def case(eng, _):
        v = eng.new_var()
        out = []
        for i in range(50):
            _push(eng, lambda i=i: out.append(i), writes=[v])
        eng.wait_for_var(v)
        return out
    got = _both(case)
    assert got["port"] == got["ref"] == list(range(50))


def test_read_write_dependencies():
    def case(eng, _):
        v = eng.new_var()
        log, lock = [], threading.Lock()

        def slow_write():
            time.sleep(0.05)
            with lock:
                log.append("w1")

        def read():
            with lock:
                log.append("r")

        def write2():
            with lock:
                log.append("w2")
        _push(eng, slow_write, writes=[v])
        _push(eng, read, reads=[v])
        _push(eng, read, reads=[v])
        _push(eng, write2, writes=[v])
        eng.wait_for_var(v)
        return log
    got = _both(case)
    assert got["port"] == got["ref"] == ["w1", "r", "r", "w2"]


def test_parallel_reads_concurrent():
    def case(eng, _):
        v = eng.new_var()
        active, peak, lock = [], [], threading.Lock()

        def read():
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.05)
            with lock:
                active.pop()
        for _ in range(3):
            _push(eng, read, reads=[v])
        eng.wait_for_all()
        return max(peak)
    got = _both(case)
    assert got["port"] >= 2 and got["ref"] >= 2


def test_exception_at_wait():
    """The original exception, its message extended by the op's label
    and enqueue site, at wait_for_var, once."""
    def case(eng, _):
        v = eng.new_var()

        def boom():
            raise RuntimeError("kaboom")
        _push(eng, boom, writes=[v], label="boom_op")
        first = _raised(lambda: eng.wait_for_var(v))
        second = _raised(lambda: eng.wait_for_var(v))
        return first, second
    got = _both(case)
    assert got["port"] == got["ref"]
    (typ, msg, cause), second = got["port"]
    assert typ is RuntimeError and cause is RuntimeError
    assert "kaboom" in msg and "boom_op" in msg and second is None


def test_error_does_not_poison_unrelated_var():
    def case(eng, _):
        v1, v2 = eng.new_var(), eng.new_var()
        _push(eng, lambda: (_ for _ in ()).throw(ValueError("x")),
              writes=[v1])
        _push(eng, lambda: None, writes=[v2])
        return _raised(lambda: eng.wait_for_var(v2)), \
            _raised(lambda: eng.wait_for_var(v1))
    got = _both(case)
    assert got["port"] == got["ref"]
    assert got["port"][0] is None and got["port"][1][0] is ValueError


def test_diamond_dependency():
    def case(eng, _):
        va, vb, vc = eng.new_var(), eng.new_var(), eng.new_var()
        log, lock = [], threading.Lock()

        def step(name):
            with lock:
                log.append(name)
        _push(eng, lambda: step("a"), writes=[va])
        _push(eng, lambda: step("b"), reads=[va], writes=[vb])
        _push(eng, lambda: step("c"), reads=[va], writes=[vc])
        _push(eng, lambda: step("d"), reads=[vb, vc])
        eng.wait_for_all()
        return log[0], set(log[1:3]), log[-1]
    got = _both(case)
    assert got["port"] == got["ref"] == ("a", {"b", "c"}, "d")


def test_stress_counters():
    def case(eng, _):
        rng = np.random.RandomState(0)
        vars_ = [eng.new_var() for _ in range(8)]
        counters, expected = [0] * 8, [0] * 8

        def bump(i):
            counters[i] += 1     # writes to var i are serialized
        for _ in range(400):
            i = int(rng.randint(8))
            expected[i] += 1
            _push(eng, lambda i=i: bump(i), writes=[vars_[i]])
        eng.wait_for_all()
        return counters, expected
    got = _both(case)
    assert got["port"] == got["ref"]
    assert got["port"][0] == got["port"][1]


def test_naive_mode_synchronous():
    def case(eng, _):
        v = eng.new_var()
        out = []
        _push(eng, lambda: out.append(1), writes=[v])
        return list(out)      # ran inline: no wait
    got = _both(case, workers=0, naive=True)
    assert got["port"] == got["ref"] == [1]


def test_read_and_write_same_var_rejected():
    def case(eng, err):
        v = eng.new_var()
        with pytest.raises(err) as ei:
            _push(eng, lambda: None, reads=[v], writes=[v])
        return str(ei.value)
    got = _both(case)
    assert got["port"] == got["ref"] == "var is both read and write"


def test_mx_version_abi():
    """MXGetVersion of the port's library equals the reference's."""
    from mxnet_tpu import native as ref_native
    versions = []
    for lib in (ref_native.load_engine_lib(), native.load_engine_lib()):
        out = ctypes.c_int(0)
        assert lib.MXGetVersion(ctypes.byref(out)) == 0
        versions.append(out.value)
    assert versions[0] == versions[1] >= 20000


def test_exception_message_preserved():
    def case(eng, _):
        v = eng.new_var()

        def boom():
            raise IOError("No space left on device")
        _push(eng, boom, writes=[v])
        return _raised(lambda: eng.wait_for_var(v))
    got = _both(case)
    assert got["port"] == got["ref"]
    typ, msg, cause = got["port"]
    assert issubclass(typ, OSError) and cause is OSError
    assert "No space left" in msg


def test_delete_var_busy_reports():
    def case(eng, _):
        v = eng.new_var()
        _push(eng, lambda: time.sleep(0.1), writes=[v])
        busy = eng.delete_var(v)
        eng.wait_for_all()
        return busy, eng.delete_var(v)
    got = _both(case)
    for name in ENGINES:
        assert got[name][0] in (True, False) and got[name][1] is True


# ---------------------------------------------------------------------------
# what the port adds to check
# ---------------------------------------------------------------------------
def test_poison_propagates_along_edges():
    """An op reading a poisoned var does not run; its own writes carry
    the original error with the path it took; wait_for_all raises it
    once."""
    def case(eng, _):
        va, vb = eng.new_var(), eng.new_var()
        ran = []

        def boom():
            raise KeyError("root cause")
        _push(eng, boom, writes=[va], label="producer")
        _push(eng, lambda: ran.append(1), reads=[va], writes=[vb],
              label="consumer")
        down = _raised(lambda: eng.wait_for_var(vb))
        return ran, down, _raised(eng.wait_for_all)
    got = _both(case)
    assert got["port"] == got["ref"]
    ran, (typ, msg, _), after = got["port"]
    assert ran == [] and typ is KeyError
    assert "root cause" in msg and "'producer'" in msg and "consumer" in msg
    assert after is None


def test_wait_for_all_raises_first_error_once():
    def case(eng, _):
        v = eng.new_var()
        _push(eng, lambda: (_ for _ in ()).throw(ZeroDivisionError("z")),
              writes=[v], label="div")
        return _raised(eng.wait_for_all), _raised(eng.wait_for_all)
    got = _both(case)
    assert got["port"] == got["ref"]
    assert got["port"][0][0] is ZeroDivisionError and got["port"][1] is None


def test_watchdog_names_pending_ops(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_WATCHDOG", "0.2")
    release = threading.Event()
    eng = PortEngine(num_workers=1)
    try:
        v = eng.new_var()
        _push(eng, lambda: release.wait(10), writes=[v], label="stuck_op")
        with pytest.raises(pt.MXNetError, match="stuck_op") as ei:
            eng.wait_for_var(v)
        assert "MXNET_ENGINE_WATCHDOG" in str(ei.value)
    finally:
        release.set()
        monkeypatch.delenv("MXNET_ENGINE_WATCHDOG")
        eng.close()


def test_fault_sites_engine_op_and_dep_drop():
    """``engine_op`` fails the op with the injected fault at the wait;
    ``engine_dep_drop`` drops the first declared read edge (the op still
    runs)."""
    eng = PortEngine(num_workers=2)
    try:
        faultinject.set_fault("engine_op", 1.0, 1)
        v = eng.new_var()
        _push(eng, lambda: None, writes=[v], label="victim")
        with pytest.raises(pt.MXNetError, match="engine_op 'victim'"):
            eng.wait_for_var(v)
        faultinject.clear()
        faultinject.set_fault("engine_dep_drop", 1.0, 1)
        va, vb = eng.new_var(), eng.new_var()
        gate, order = threading.Event(), []
        _push(eng, lambda: (gate.wait(5), order.append("a")), writes=[va])
        _push(eng, lambda: order.append("b"), reads=[va], writes=[vb])
        eng.wait_for_var(vb)
        assert order == ["b"]          # ran before its dropped producer
        gate.set()
        eng.wait_for_all()
        assert faultinject.fires("engine_dep_drop") == 1
    finally:
        faultinject.clear()
        eng.close()


def test_facade_naive_and_waitall(monkeypatch):
    """``engine()`` reads MXNET_ENGINE_TYPE at import and by set_naive;
    on the CPU on_dispatch and wait_for_var have nothing to wait for;
    ``nd.waitall`` drains the native engine."""
    eng = port_engine.engine()
    assert eng.is_naive is False
    try:
        eng.set_naive(True)
        x = pt.nd.array(np.ones(3, np.float32), ctx=pt.cpu())
        np.testing.assert_array_equal((x + 1).asnumpy(), [2, 2, 2])
    finally:
        eng.set_naive(False)
    done = []
    native_eng = port_engine.native_engine()
    v = native_eng.new_var()
    _push(native_eng, lambda: (time.sleep(0.1), done.append(1)), writes=[v])
    pt.nd.waitall()
    assert done == [1]
    native_eng.delete_var(v)


def test_failed_build_raises(tmp_path):
    """A source g++ refuses raises MXNetError with the compiler's
    output; nothing falls back to running the engine's work inline."""
    bad = tmp_path / "engine.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(pt.MXNetError, match="g\\+\\+ failed"):
        native.build_engine(bad)


def test_built_library_is_the_ports_own():
    """The port builds its own copy, under its build tree."""
    path, _ = native.build_engine()
    assert "mxnet_tpu_torch" in str(path) and path.name == "libmxt_engine.so"
    src = native.ENGINE_SOURCE.read_text()
    for name in ("MXGetVersion", "MXEngineCreate", "MXEngineFree",
                 "MXEngineNewVar", "MXEngineDeleteVar", "MXEnginePushAsync",
                 "MXEngineWaitForVar", "MXEngineWaitForAll"):
        assert name + "(" in src, name
