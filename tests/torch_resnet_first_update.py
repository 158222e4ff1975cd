"""The first SGD update of resnet50_v1 at its MSRAPrelu initialization,
in both packages on the CPU: the reference's ``ShardedTrainStep`` and
the port's, in bf16 and f32, with the layout pass on and off, from the
same weights and batch. Prints each run's loss and the relative L2
distance between every two runs' updates (the masters' change).

Not collected by pytest (about a minute a call). Run from the repo's
root::

    JAX_PLATFORMS=cpu python tests/torch_resnet_first_update.py normal 1

``normal`` draws N(0, 1) images, ``uniform`` [0, 1) ones; the images
are rounded to bf16 for every run; 8 images at 64 x 64.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as pt  # noqa: E402
from mxnet_tpu import parallel as rpar  # noqa: E402
from mxnet_tpu_torch import parallel as ppar  # noqa: E402

BATCH, SIDE = 8, 64
SGD = dict(lr=0.1, momentum=0.9)


def _ref_masters(step):
    """The reference step's masters in the documented layouts."""
    out = {}
    for k, v in step.params.items():
        v = np.asarray(jax.device_get(v)).astype(np.float32)
        perm = step._param_transforms.get(k)
        if perm is not None:
            v = np.transpose(v, np.argsort(perm))
        out[k] = v
    return out


def _run(lib, arrays, x, y, dtype, layout):
    os.environ["MXNET_LAYOUT_OPT"] = "1" if layout else "0"
    if lib == "ref":
        net = mx.gluon.model_zoo.vision.resnet50_v1(prefix="resnet50_")
        net.initialize(init=mx.initializer.MSRAPrelu())
        net(mx.nd.zeros((1, 3, SIDE, SIDE)))
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(arrays[k]))
        step = rpar.ShardedTrainStep(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            rpar.make_mesh(rpar.MeshConfig(dp=1),
                           devices=jax.devices()[:1]), dtype=dtype, **SGD)
        loss = float(np.asarray(step.step(mx.nd.array(x), mx.nd.array(y))))
        return loss, _ref_masters(step)
    ctx = pt.cpu()
    net = pt.gluon.model_zoo.vision.resnet50_v1(prefix="resnet50_")
    net.initialize(init=pt.init.MSRAPrelu(), ctx=ctx)
    net(pt.nd.zeros((1, 3, SIDE, SIDE), ctx=ctx))
    pt.params_from_numpy(net, arrays, ctx=ctx)
    step = ppar.ShardedTrainStep(
        net, pt.gluon.loss.SoftmaxCrossEntropyLoss(),
        ppar.make_mesh(ppar.MeshConfig(dp=1), devices=[ctx]), dtype=dtype,
        data_specs=[ppar.P(), ppar.P()], **SGD)
    loss = float(step.step(pt.nd.array(x, ctx=ctx),
                           pt.nd.array(y, ctx=ctx)).asnumpy())
    return loss, {k: v.tensor().float().numpy()
                  for k, v in step.params.items()}


def main(kind, seed):
    mx.random.seed(seed)
    net = mx.gluon.model_zoo.vision.resnet50_v1(prefix="resnet50_")
    net.initialize(init=mx.initializer.MSRAPrelu())
    net(mx.nd.zeros((1, 3, SIDE, SIDE)))
    arrays = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    rng = np.random.RandomState(seed)
    x = (rng.randn if kind == "normal" else rng.rand)(BATCH, 3, SIDE, SIDE)
    x = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    x = x.float().numpy()
    y = rng.randint(0, 1000, (BATCH,)).astype(np.float32)
    runs = {}
    for lib in ("ref", "port"):
        for dtype in ("bfloat16", None):
            for layout in (True, False):
                name = "%s_%s_%s" % (lib, "bf16" if dtype else "f32",
                                     "on" if layout else "off")
                runs[name] = _run(lib, arrays, x, y, dtype, layout)
                print("%-14s loss %r" % (name, runs[name][0]), flush=True)
    keys = [k for k in arrays if all(k in m for _, m in runs.values())]

    def rel(a, b):
        num = den = 0.0
        for k in keys:
            da = runs[a][1][k] - arrays[k]
            db = runs[b][1][k] - arrays[k]
            num += float(((da - db).astype(np.float64) ** 2).sum())
            den += float((db.astype(np.float64) ** 2).sum())
        return (num / den) ** 0.5
    print("relative L2 of the row's update from the column's (%s batch, "
          "seed %d, %d parameters):" % (kind, seed, len(keys)))
    print(" " * 14 + "".join("%14s" % b for b in runs))
    for a in runs:
        print("%-14s" % a + "".join("%14.4g" % rel(a, b) for b in runs))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "normal",
         int(sys.argv[2]) if len(sys.argv) > 2 else 1)
