"""Worker of ``tests/test_torch_parallel_dist.py``: ``ShardedTrainStep``
over a mesh that spans the processes (the counterpart of the reference's
``tests/dist_sharded_worker.py``).

Started by ``python -m mxnet_tpu_torch.tools.launch -n 2 --cpu-devices 2``
(gloo over CPU contexts). The mesh is ``make_mesh()`` over every
process's contexts; each process passes its local rows of the global
batch (row i lives on mesh device i). Each rank hands its losses,
parameters and commwatch rows to ``torch_dist_worker.emit``, and saves
the step's states into ``PARALLEL_STATES`` (rank 0 writes).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
from torch_dist_worker import emit  # noqa: E402

STEPS = 3


def dense_net(lib, ctx=None):
    """The reference worker's Dense(4), its weights fixed from seed 0."""
    net = lib.gluon.nn.Dense(4, in_units=8, prefix="dense0_")
    net.initialize(**({"ctx": ctx} if ctx is not None else {}))
    rngp = np.random.RandomState(0)
    net.weight.set_data(lib.nd.array(rngp.rand(4, 8).astype(np.float32),
                                     **({"ctx": ctx} if ctx else {})))
    net.bias.set_data(lib.nd.array(np.zeros(4, np.float32),
                                   **({"ctx": ctx} if ctx else {})))
    return net


def batch(ndev, step):
    rng = np.random.RandomState(7 + step)
    return (rng.rand(ndev, 8).astype(np.float32),
            rng.rand(ndev, 4).astype(np.float32))


def main():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist
    from mxnet_tpu_torch.parallel import P, ShardedTrainStep, make_mesh
    dist.initialize()
    rank = dist.rank()
    mesh = make_mesh()
    ndev = mesh.size
    nloc = len(mesh.local_devices())
    net = dense_net(mx, mx.cpu())
    step = ShardedTrainStep(net, mx.gluon.loss.L2Loss(), mesh, lr=0.1,
                            data_specs=[P("dp"), P("dp")])
    lo = rank * nloc
    losses = []
    for s in range(STEPS):
        x, y = batch(ndev, s)
        loss = step.step(mx.nd.array(x[lo:lo + nloc], ctx=mx.cpu()),
                         mx.nd.array(y[lo:lo + nloc], ctx=mx.cpu()))
        losses.append(float(loss.asnumpy()))
    step.save_states(os.environ["PARALLEL_STATES"])
    out = {"rank": rank, "ndev": ndev, "nloc": nloc,
           "procs": mesh.process_indices, "backend": dist.backend(),
           "losses": [repr(v) for v in losses],
           "params": {k: v.asnumpy().tolist()
                      for k, v in step.params.items()},
           "comm": [{k: r[k] for k in ("op", "axis", "ops", "bytes")}
                    for r in mx.commwatch.report()]}
    emit(out)


if __name__ == "__main__":
    main()
