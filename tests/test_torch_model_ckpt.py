"""Crash-safe asynchronous checkpoints in the port
(``mxnet_tpu_torch/model.py``) against the reference's ``model.py``:
the manifest's fields, checkpoints cross-loaded both ways (the
reference's ``load_latest_checkpoint`` reads the port's prefix and the
other way round, arrays bit for bit), the fall-back past a corrupt or
missing file, retention with the optimizer-state sidecar, the
``ckpt_write`` fault surfacing at the wait, and the snapshot: a file
saved at step k holds step k's weights bit for bit after more in-place
updates.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.base import MXNetError

from test_torch_telemetry import _reset_all


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    _reset_all()
    yield
    for lib in (mx, pt):
        lib.model.wait_checkpoints()
    monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    _reset_all()


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32)}


def _nd(lib, a):
    return lib.nd.array(a, ctx=lib.cpu()) if lib is pt else lib.nd.array(a)


def _save(lib, prefix, epoch, seed=0, **kw):
    arg = {k: _nd(lib, v) for k, v in _arrays(seed).items()}
    lib.model.save_checkpoint(prefix, epoch, None, arg, {}, **kw)


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def test_manifest_fields_match_reference(tmp_path):
    def run(lib):
        prefix = str(tmp_path / lib.__name__ / "run")
        os.makedirs(os.path.dirname(prefix))
        _save(lib, prefix, 1, states_blob=b"state-bytes")
        _save(lib, prefix, 2, seed=1)
        lib.model.wait_checkpoints()
        with open(prefix + "-manifest.json") as f:
            man = json.load(f)
        entries = [{k: v for k, v in c.items() if k != "time"}
                   for c in man["checkpoints"]]
        return (man["version"], sorted(man), entries,
                sorted(os.listdir(os.path.dirname(prefix))),
                lib.model.checkpoint_entry(prefix, 1)["states_size"])
    ref, got = _both(run)
    assert got == ref
    assert got[2][0]["file"] == "run-0001.params"
    assert got[2][0]["states"] == "run-0001.states"


def _both(fn):
    return fn(mx), fn(pt)


@pytest.mark.parametrize("writer,reader", [("mx", "pt"), ("pt", "mx")])
def test_checkpoints_cross_load(tmp_path, writer, reader):
    libs = {"mx": mx, "pt": pt}
    w, r = libs[writer], libs[reader]
    prefix = str(tmp_path / "run")
    _save(w, prefix, 1, seed=0)
    _save(w, prefix, 2, seed=3, states_blob=b"abc")
    w.model.wait_checkpoints()
    arg, aux, epoch = r.model.load_latest_checkpoint(prefix)
    assert epoch == 2 and aux == {}
    got = _np(arg)
    for k, v in _arrays(3).items():
        assert got[k].tobytes() == v.tobytes()
    assert r.model.load_checkpoint_states(prefix, 2) == b"abc"
    arg1, _ = r.model.load_params(prefix, 1)
    assert _np(arg1)["w"].tobytes() == _arrays(0)["w"].tobytes()


@pytest.mark.parametrize("damage", ["truncate", "delete", "garbage"])
def test_falls_back_past_a_corrupt_checkpoint(tmp_path, damage):
    def run(lib):
        prefix = str(tmp_path / lib.__name__ / "run")
        os.makedirs(os.path.dirname(prefix))
        _save(lib, prefix, 1, seed=0)
        _save(lib, prefix, 2, seed=1)
        lib.model.wait_checkpoints()
        path = prefix + "-0002.params"
        if damage == "truncate":
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
        elif damage == "delete":
            os.remove(path)
        else:
            os.remove(prefix + "-manifest.json")      # no checksum left
            with open(path, "wb") as f:
                f.write(b"not a checkpoint")
        arg, _, epoch = lib.model.load_latest_checkpoint(prefix)
        return epoch, _np(arg)["w"].tobytes()
    ref, got = _both(run)
    assert got == ref
    assert got == (1, _arrays(0)["w"].tobytes())


def test_corrupt_file_raises_naming_it(tmp_path):
    path = str(tmp_path / "x-0001.params")
    with open(path, "wb") as f:
        f.write(b"\x12\x01" + b"\x00" * 30)
    with pytest.raises(MXNetError, match="x-0001.params"):
        pt.model.load_params(str(tmp_path / "x"), 1)


def test_retention_prunes_files_and_sidecars(tmp_path):
    def run(lib):
        d = tmp_path / lib.__name__
        d.mkdir()
        prefix = str(d / "run")
        for e in range(1, 5):
            _save(lib, prefix, e, seed=e, max_keep=2,
                  states_blob=b"s%d" % e)
        lib.model.wait_checkpoints()
        return sorted(os.listdir(d))
    ref, got = _both(run)
    assert got == ref == ["run-0003.params", "run-0003.states",
                          "run-0004.params", "run-0004.states",
                          "run-manifest.json"]


def test_retention_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_KEEP", "1")
    prefix = str(tmp_path / "run")
    for e in range(1, 4):
        _save(pt, prefix, e, seed=e)
    pt.model.wait_checkpoints()
    assert sorted(os.listdir(tmp_path)) == ["run-0003.params",
                                            "run-manifest.json"]


def test_ckpt_write_fault_surfaces_at_the_wait(tmp_path):
    def run(lib):
        d = tmp_path / lib.__name__
        d.mkdir()
        prefix = str(d / "run")
        _save(lib, prefix, 1)
        lib.model.wait_checkpoints()
        lib.faultinject.set_fault("ckpt_write", 1.0, max_fires=1)
        _save(lib, prefix, 2, seed=1)
        with pytest.raises(lib.base.MXNetError, match="ckpt_write"):
            lib.model.wait_checkpoints()
        lib.faultinject.clear()
        snap = lib.telemetry.snapshot()["counters"]
        return (sorted(os.listdir(d)),
                snap.get("mx_checkpoint_writes_total"),
                snap.get("mx_checkpoint_errors_total"),
                snap.get('mx_fault_injections_total{site="ckpt_write"}'),
                lib.model.load_latest_checkpoint(prefix)[2])
    ref, got = _both(run)
    assert got == ref == (["run-0001.params", "run-manifest.json"], 1, 1, 1,
                          1)


def test_snapshot_holds_the_step_it_was_taken_at(tmp_path):
    """The port's optimizer writes in place: the checkpoint copies the
    weights when it is saved, so more steps before the write lands do
    not leak into it."""
    with pt.cpu():
        net = pt.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        tr = pt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.5, "momentum": 0.9})
        x = pt.nd.array(np.random.RandomState(0).randn(8, 4))

        def step():
            with pt.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            tr.step(8)
        step()
        want = {n: p.data().asnumpy().copy()
                for n, p in net.collect_params().items()}
        prefix = str(tmp_path / "run")
        # hold the writer back until the later steps ran
        eng = pt.engine.native_engine()
        gate = eng.new_var()
        import threading
        release = threading.Event()
        eng.push_async(lambda: release.wait(30),
                       write_vars=(pt.model._ckpt_var(eng),),
                       label="hold")
        pt.model.save_checkpoint(prefix, 1, None,
                                 {n: p.data() for n, p in
                                  net.collect_params().items()}, {})
        for _ in range(3):
            step()
        release.set()
        arg, _ = pt.model.load_params(prefix, 1)
        eng.delete_var(gate)
    got = _np(arg)
    for n, v in want.items():
        assert got[n].tobytes() == v.tobytes(), n
    moved = net.collect_params()
    assert any(moved[n].data().asnumpy().tobytes() != v.tobytes()
               for n, v in want.items())


def test_symbol_and_sharding_wait_for_their_items(tmp_path):
    """The symbol still waits for item 16; the sharding section is
    written (reshard.py, which makes one, waits for item 11)."""
    with pytest.raises(NotImplementedError, match="item 16"):
        pt.model.save_checkpoint(str(tmp_path / "r"), 1, object(), {}, {})
    pt.model.save_checkpoint(str(tmp_path / "r"), 1, None, {}, {},
                             sharding={"x": 1})
    pt.model.wait_checkpoints()
    assert pt.model.checkpoint_sharding(str(tmp_path / "r"), 1) == {"x": 1}
    with pytest.raises(NotImplementedError, match="item 16"):
        pt.model.load_checkpoint(str(tmp_path / "r"), 1)
    assert pt.model.BatchEndParam._fields == mx.model.BatchEndParam._fields


def test_checkpoint_write_span_and_engine_op(tmp_path):
    pt.profiler.set_state("run")
    _save(pt, str(tmp_path / "run"), 1)
    pt.model.wait_checkpoints()
    pt.profiler.set_state("stop")
    names = [e["name"] for e in
             json.loads(pt.profiler.dumps(reset=True))["traceEvents"]]
    assert "checkpoint::write" in names
    assert "engine::checkpoint_write:run-0001.params" in names
    snap = pt.telemetry.snapshot()
    assert snap["histograms"]["mx_checkpoint_write_seconds"]["count"] == 1
    assert snap["counters"][
        'mx_engine_ops_total{label="checkpoint_write"}'] == 1


def test_save_checkpoint_sharding_section_as_the_reference(tmp_path):
    """The same section in both packages' v2 manifest entries, and
    ``checkpoint_sharding`` reads the same back; none written reads
    None."""
    section = {"version": 1, "mesh": {"dp": 4, "tp": 2},
               "params": {"dense0_weight": ["tp", None],
                          "dense0_bias": [None]}}
    entries = []
    for lib in (mx, pt):
        prefix = str(tmp_path / lib.__name__)
        arg = {"w": lib.nd.array(np.arange(6, dtype=np.float32), **(
            {"ctx": pt.cpu()} if lib is pt else {}))}
        lib.model.save_checkpoint(prefix, 3, None, arg, {}, sharding=section)
        lib.model.save_checkpoint(prefix, 4, None, arg, {})
        lib.model.wait_checkpoints()
        assert lib.model.checkpoint_sharding(prefix, 3) == section
        assert lib.model.checkpoint_sharding(prefix, 4) is None
        entries.append({k: v for k, v in
                        lib.model.checkpoint_entry(prefix, 3).items()
                        if k not in ("time", "file")})
    assert entries[0] == entries[1]
