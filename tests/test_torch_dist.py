"""The port's process group and dist kvstore (``mxnet_tpu_torch/dist.py``,
``mxnet_tpu_torch/kvstore/dist.py``, ``mxnet_tpu_torch/tools/launch.py``)
against the reference's ``tests/test_dist.py`` and its workers, and the
comms watchdogs of its ``tests/test_guardrails.py``.

The multi-process cases run real worker processes started by the port's
launcher (``python -m mxnet_tpu_torch.tools.launch -n 2 --cpu-devices 2``,
gloo over CPU contexts; ``tests/torch_dist_worker.py``), one group for
all of them, each launch under its own 60 s timeout that kills the whole
process group; no test opens a process group in the pytest process. The
Trainer over ``dist_sync`` is held to the reference's single-process run
on the concatenated batch (its own equivalence claim), computed here.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_dist_worker as w  # noqa: E402
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
LAUNCH = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch"]
# the reference worker's tolerance for the trainer equivalence
DENSE_TOL = dict(rtol=1e-5, atol=1e-6)


def launch(nworkers, command, env=None, cpu_devices=2, timeout=60):
    """Run the launcher in a session of its own; on timeout every
    process of that session is killed and the test fails."""
    full = dict(os.environ)
    full.pop("MXNET_FAULT_INJECT", None)
    # the workers' arrays are tiny: one thread each keeps them off the
    # cores of the tests running beside them
    full["OMP_NUM_THREADS"] = "1"
    full.update(env or {})
    args = LAUNCH + ["-n", str(nworkers)]
    if cpu_devices:
        args += ["--cpu-devices", str(cpu_devices)]
    proc = subprocess.Popen(args + command, cwd=ROOT, env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("launch %s timed out after %ds" % (command, timeout))
    return proc.returncode, out, err


def results(stdout):
    """rank -> the worker's RESULT json."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("RESULT "):
            r = json.loads(line[len("RESULT "):])
            out[r["rank"]] = r
    return out


@pytest.fixture(scope="module")
def main_run():
    rc, out, err = launch(2, [sys.executable, WORKER],
                          env={"TEST_CASE": "main"})
    assert rc == 0, (out, err[-4000:])
    res = results(out)
    assert sorted(res) == [0, 1], (out, err[-4000:])
    return res


# ---------------------------------------------------------------------------
# the kvstore across processes (reference tests/dist_worker.py)
# ---------------------------------------------------------------------------
def test_dist_sync_exact_sums(main_run):
    for r in (0, 1):
        res = main_run[r]
        assert (res["nw"], res["nloc"], res["type"]) == (2, 2, "dist_sync")
        assert res["push_pull"] == [0.0, 0.0]
        assert res["pushpull_list"] == [0.0] * 10
        assert res["store_after_list"] == 0.0


def test_backend_rule_picks_gloo_for_cpu_contexts(main_run):
    for r in (0, 1):
        assert main_run[r]["backend"] == main_run[r]["dist_backend"] == \
            "gloo"


def test_dist_async_accepted(main_run):
    for r in (0, 1):
        assert main_run[r]["async"] == {"type": "dist_async", "err": 0.0}


def test_p3store_equal_to_dist_sync(main_run):
    for r in (0, 1):
        assert main_run[r]["p3_equal"] is True
        assert main_run[r]["p3_fresh"] == 0.0


# ---------------------------------------------------------------------------
# the Trainer over dist_sync (reference tests/dist_trainer_worker.py)
# ---------------------------------------------------------------------------
def _reference_dense(total, steps):
    """The reference's single-process run on the concatenated batch."""
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    net.weight.set_data(mx.nd.array(
        np.arange(12, dtype=np.float32).reshape(3, 4) / 10))
    net.bias.set_data(mx.nd.zeros((3,)))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = mx.gluon.loss.L2Loss()
    X, Y = w.dense_batch(total * steps)
    for s in range(steps):
        x = mx.nd.array(X[s * total:(s + 1) * total])
        y = mx.nd.array(Y[s * total:(s + 1) * total])
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(total)
    return net.weight.data().asnumpy(), net.bias.data().asnumpy()


def test_trainer_ranks_equal_bit_for_bit(main_run):
    assert main_run[0]["trainer"]["digest"] == \
        main_run[1]["trainer"]["digest"]
    assert main_run[0]["trainer"]["replicas_equal"]
    assert main_run[1]["trainer"]["replicas_equal"]


def test_trainer_matches_reference_concatenated_batch(main_run):
    w_ref, b_ref = _reference_dense(4, 3)
    got = main_run[0]["trainer"]
    np.testing.assert_allclose(np.array(got["weight"], np.float32), w_ref,
                               **DENSE_TOL)
    np.testing.assert_allclose(np.array(got["bias"], np.float32), b_ref,
                               **DENSE_TOL)


def test_commwatch_records_the_cross_process_allreduce(main_run):
    for r in (0, 1):
        rows = main_run[r]["commwatch"]
        assert len(rows) == 1
        row = rows[0]
        # 3 steps, the weight (12) and bias (3) f32 gradients each
        assert (row["op"], row["axis"], row["ops"], row["bytes"]) == \
            ("allreduce", "kv.dcn", 3.0, 3 * 15 * 4)
        assert row["exposed_s"] > 0 and row["busbw"] > 0
        assert main_run[r]["kv_calls"] == {
            'mx_kvstore_calls_total{verb="pushpull_list"}': 3.0}


# ---------------------------------------------------------------------------
# the group's small services
# ---------------------------------------------------------------------------
def test_allgather_floats(main_run):
    for r in (0, 1):
        assert main_run[r]["allgather"] == [[0.0, 10.0], [1.0, 11.0]]


def test_fleet_snapshot_two_ranks(main_run):
    views = [main_run[r]["fleet"] for r in (0, 1)]
    assert [v["rank"] for v in views] == [0, 1]
    for v in views:
        assert v["nw"] == 2 and v["slowest"] == 1
        assert v["steps"] == [6.0, 6.0]
        assert v["comm_bytes"] == [180.0, 180.0]


def test_fleet_kv_rides_the_group_store(main_run):
    for r in (0, 1):
        assert main_run[r]["fleet_kv"] == [["mx/test/r0", "v0"],
                                           ["mx/test/r1", "v1"]]


# ---------------------------------------------------------------------------
# the vote and the watchdogs across processes
# ---------------------------------------------------------------------------
def test_finite_vote_names_rank_1_on_every_rank(main_run):
    for r in (0, 1):
        msg = main_run[r]["vote"]
        assert "originating rank(s) [1]" in msg, msg
        assert "this is rank %d/2" % r in msg


def test_kv_hang_raises_within_its_deadline(main_run):
    for r in (0, 1):
        hang = main_run[r]["kv_hang"]
        assert "timed out" in hang["error"] and "pushpull" in hang["error"]
        # 2 attempts of 0.5 s and the backoff between them
        assert 1.0 <= hang["seconds"] < 5.0


def test_barrier_with_a_dead_rank_raises_within_its_deadline(main_run):
    dead = main_run[0]["dead_barrier"]
    assert dead["error"] is not None and "rank 0" in dead["error"]
    assert dead["seconds"] < 5.0 + 2.0


# ---------------------------------------------------------------------------
# the launcher and the rendezvous contract
# ---------------------------------------------------------------------------
def test_num_servers_rejected():
    out = subprocess.run(LAUNCH + ["-n", "1", "-s", "1", "echo", "hi"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=30)
    assert out.returncode != 0
    assert "parameter-server" in out.stderr


def test_launcher_stops_the_group_when_a_worker_fails():
    code = ("import os, sys, time\n"
            "if os.environ['DMLC_WORKER_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    rc, _, _ = launch(2, [sys.executable, "-c", code], cpu_devices=0,
                      timeout=40)
    assert rc == 3
    assert time.monotonic() - t0 < 30


def test_launcher_sets_the_dmlc_environment():
    code = ("import json, os\n"
            "print('ENV', json.dumps({k: os.environ[k] for k in ("
            "'DMLC_ROLE', 'DMLC_NUM_WORKER', 'DMLC_WORKER_ID', "
            "'DMLC_NUM_SERVER', 'MXNET_DIST_CPU_DEVICES')}))\n")
    rc, out, _ = launch(2, [sys.executable, "-c", code], cpu_devices=3,
                        timeout=30)
    assert rc == 0
    envs = sorted((json.loads(line[4:]) for line in out.splitlines()
                   if line.startswith("ENV ")),
                  key=lambda e: e["DMLC_WORKER_ID"])
    assert envs == [{"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": "2",
                     "DMLC_WORKER_ID": str(i), "DMLC_NUM_SERVER": "0",
                     "MXNET_DIST_CPU_DEVICES": "3"} for i in (0, 1)]


@pytest.fixture
def _dmlc_env(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("MXNET_FAULT_INJECT", raising=False)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    pt.faultinject.reset()
    yield monkeypatch
    pt.faultinject.reset()
    assert not pt.dist.is_initialized()


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_server_role_refused_before_rendezvous(_dmlc_env, lib):
    _dmlc_env.setenv("DMLC_ROLE", "server")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="DMLC_ROLE='server'"):
        lib.dist.initialize()
    assert time.monotonic() - t0 < 1.0


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_bad_rank_refused_before_rendezvous(_dmlc_env, lib):
    _dmlc_env.setenv("DMLC_WORKER_ID", "2")
    t0 = time.monotonic()
    with pytest.raises(lib.MXNetError, match="invalid worker rank"):
        lib.dist.initialize()
    assert time.monotonic() - t0 < 1.0


def test_rendezvous_fault_retried_then_fails_within_deadline(_dmlc_env):
    _dmlc_env.setenv("MXNET_FAULT_INJECT", "rendezvous:1")
    _dmlc_env.setenv("MXNET_DIST_INIT_TIMEOUT", "1.5")
    _dmlc_env.setenv("MXNET_DIST_INIT_BACKOFF", "0.05")
    t0 = time.monotonic()
    with pytest.raises(pt.MXNetError, match="rendezvous .* failed after"):
        pt.dist.initialize()
    assert time.monotonic() - t0 < 1.5 + 1.0
    assert pt.faultinject.fires("rendezvous") >= 3


def test_rendezvous_retry_budget(_dmlc_env):
    _dmlc_env.setenv("MXNET_FAULT_INJECT", "rendezvous:1")
    _dmlc_env.setenv("MXNET_DIST_INIT_RETRIES", "2")
    _dmlc_env.setenv("MXNET_DIST_INIT_BACKOFF", "0.05")
    with pytest.raises(pt.MXNetError, match="after 2 attempt"):
        pt.dist.initialize()
    assert pt.faultinject.fires("rendezvous") == 2


def test_no_group_is_rank_0_of_1():
    assert (pt.dist.rank(), pt.dist.num_workers(), pt.dist.backend()) == \
        (0, 1, None)
    np.testing.assert_array_equal(pt.dist.allgather_floats([1.0, 2.0]),
                                  [[1.0, 2.0]])
    pt.dist.barrier()          # nothing to wait for


# ---------------------------------------------------------------------------
# the comms watchdogs on a store without a group (reference
# tests/test_guardrails.py's comm-deadline cases, in both packages)
# ---------------------------------------------------------------------------
def _bare_dist_store(lib):
    if lib is mx:
        from mxnet_tpu.kvstore.dist import KVStoreDist, _GlobalReducer
        kv = object.__new__(KVStoreDist)
        kv._reducer = _GlobalReducer()
    else:
        from mxnet_tpu_torch.kvstore.dist import KVStoreDist
        kv = object.__new__(KVStoreDist)
    kv._type = "dist_sync"
    return kv


@pytest.fixture
def _faults(monkeypatch):
    for var in pt.config.VARS:
        monkeypatch.delenv(var, raising=False)
    for lib in (mx, pt):
        lib.faultinject.reset()
    yield monkeypatch
    for lib in (mx, pt):
        lib.faultinject.reset()


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_kv_barrier_explicit_timeout_wins_over_env(_faults, lib):
    _faults.setenv("MXNET_BARRIER_TIMEOUT", "0")
    lib.faultinject.set_fault("barrier", 1.0, max_fires=1)
    t0 = time.monotonic()
    with pytest.raises(lib.MXNetError, match="timed out"):
        _bare_dist_store(lib).barrier(timeout=0.3)
    assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_kv_barrier_env_default_still_guards(_faults, lib):
    _faults.setenv("MXNET_BARRIER_TIMEOUT", "0.3")
    lib.faultinject.set_fault("barrier", 1.0, max_fires=1)
    with pytest.raises(lib.MXNetError, match="timed out"):
        _bare_dist_store(lib).barrier()


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_kv_comm_deadline_bounded_retry_recovers(_faults, lib):
    _faults.setenv("MXNET_KVSTORE_TIMEOUT", "0.3")
    lib.faultinject.set_fault("kv_hang", 1.0, max_fires=1)
    assert _bare_dist_store(lib)._comm_call("push",
                                            lambda: "reduced") == "reduced"
    assert lib.faultinject.fires("kv_hang") == 1


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_kv_comm_deadline_exhausted_raises(_faults, lib):
    _faults.setenv("MXNET_KVSTORE_TIMEOUT", "0.25")
    _faults.setenv("MXNET_KVSTORE_RETRIES", "1")
    lib.faultinject.set_fault("kv_hang", 1.0)
    events = []
    unsub = lib.guardrails.on_event(events.append)
    try:
        with pytest.raises(lib.MXNetError, match="pushpull"):
            _bare_dist_store(lib)._comm_call("pushpull", lambda: None)
    finally:
        unsub()
    assert any(ev["kind"] == "watchdog" and ev["where"] == "kvstore"
               for ev in events)


@pytest.mark.parametrize("lib", [mx, pt], ids=["ref", "port"])
def test_kv_comm_deadline_off_is_passthrough(_faults, lib):
    assert _bare_dist_store(lib)._comm_call("pull", lambda: 41 + 1) == 42
