"""``ShardedTrainStep`` over a mesh that spans two processes, against the
reference's ``tests/test_dist.py::test_sharded_train_step_multiprocess``
(``tests/dist_sharded_worker.py``'s net).

Two ranks x two CPU contexts (``--cpu-devices 2``, gloo), started by the
port's launcher in a session of their own under a 60 s timeout
(``tests/test_torch_dist.py``'s ``launch``); no process group opens in
the pytest process. Each rank passes its local rows; the losses and
parameters are bit for bit the same on both ranks, and within rtol 1e-5
of the reference's one-process step over 4 devices on the same global
batch.
"""
import os
import sys

import numpy as np
import pytest

import jax

import mxnet_tpu as mx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_parallel_worker as w  # noqa: E402
from test_torch_dist import launch, results  # noqa: E402

WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("par") / "states.npz")
    rc, out, err = launch(2, [sys.executable, WORKER],
                          env={"PARALLEL_STATES": path,
                               "MXNET_TELEMETRY": "1"})
    assert rc == 0, (out, err[-4000:])
    res = results(out)
    assert sorted(res) == [0, 1], (out, err[-4000:])
    return res, path


def _reference():
    net = w.dense_net(mx)
    mesh = mx.parallel.make_mesh(mx.parallel.MeshConfig(dp=4),
                                 devices=jax.devices()[:4])
    step = mx.parallel.ShardedTrainStep(
        net, mx.gluon.loss.L2Loss(), mesh, lr=0.1,
        data_specs=[mx.parallel.P("dp"), mx.parallel.P("dp")])
    losses = []
    for s in range(w.STEPS):
        x, y = w.batch(4, s)
        losses.append(float(step.step(mx.nd.array(x), mx.nd.array(y))))
    return losses, {k: np.asarray(jax.device_get(v))
                    for k, v in step.params.items()}


def test_mesh_spans_both_processes(run):
    res, _ = run
    for r in (0, 1):
        assert res[r]["ndev"] == 4 and res[r]["nloc"] == 2
        assert res[r]["procs"] == [0, 1] and res[r]["backend"] == "gloo"


def test_ranks_equal_bit_for_bit(run):
    res, _ = run
    assert res[0]["losses"] == res[1]["losses"]
    assert all(np.isfinite(float(v)) for v in res[0]["losses"])
    assert res[0]["params"] == res[1]["params"]


def test_against_the_reference_one_process_step(run):
    res, _ = run
    losses, params = _reference()
    np.testing.assert_allclose([float(v) for v in res[0]["losses"]], losses,
                               rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(np.asarray(res[0]["params"][k],
                                              np.float32), v, rtol=1e-5,
                                   atol=1e-6)


def test_cross_process_allreduce_recorded_and_states_saved(run):
    res, path = run
    for r in (0, 1):
        rows = {(c["op"], c["axis"]): c for c in res[r]["comm"]}
        assert rows[("allreduce", "dp")]["bytes"] > 0
    blob = np.load(path)
    assert int(blob["t"]) == w.STEPS and blob["rng"].shape[0] == 4
    for k, v in res[0]["params"].items():
        np.testing.assert_array_equal(blob["p:" + k],
                                      np.asarray(v, np.float32))
