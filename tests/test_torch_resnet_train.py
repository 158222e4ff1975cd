"""A Gluon ResNet training step in the port against the reference's:
ResNetV1 with one bottleneck (or basic) block per stage, batch 4 at
16x16, SoftmaxCrossEntropyLoss, SGD at momentum 0.9, in f32 and in bf16
(``cast``, BatchNorm kept in f32). Held: the eval and train forwards,
the loss, every parameter gradient, the moving statistics after a step,
and the weights after two SGD steps.

Tolerances, relative L2 per array, each about twice the largest reading
over two weight draws (the reference's MSRAPrelu draw is seeded). f32:
outputs, loss and moving statistics within 1e-5, gradients and each
weight's change over two SGD steps within 2e-4 (the reference's XLA
convolutions and reductions add in another order than torch's;
readings up to 1.4e-6 and 6.1e-5). bf16: outputs, loss and moving
statistics within 2e-2 (readings up to 4.9e-3), gradients within 0.25
and the change over two steps within 0.6 (readings up to 0.11 and 0.31:
one-ulp flips in a bf16 activation move every later layer, and the
second step's gradient is taken at weights that differ by the bf16
rounding of the first update); a dropped or misplaced term moves the
arrays it touches by order 1. An array whose norm is rounding noise is
held
against 0.1 of the median array norm; in bf16 the biases of the
bottleneck convolutions in front of a BatchNorm are left out, since
their gradient is zero but for rounding (the BatchNorm removes any
shift) and in bf16 that rounding is of the order of the other
gradients (the f32 case holds them).
"""
import re

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as pt

from test_torch_resnet import _rel, small_resnets

BOUND = {"float32": {"out": 1e-5, "grads": 2e-4, "delta": 2e-4},
         "bfloat16": {"out": 2e-2, "grads": 0.25, "delta": 0.6}}
_CANCELLED = re.compile(r"conv2_d\d+_bias$")


@pytest.fixture(autouse=True)
def _config_unset(monkeypatch):
    """Unset every variable the port's config declares, and the
    reference's aggregation width: other test files of the suite set
    some (MXNET_ZERO, ...) in os.environ without restoring them, and the
    port's Trainer refuses what they turn on."""
    for var in list(pt.config.VARS) + ["MXNET_OPTIMIZER_AGGREGATION_SIZE"]:
        monkeypatch.delenv(var, raising=False)


def _held(got, want, bound, dtype, what):
    med = np.median([np.linalg.norm(np.asarray(w, np.float64))
                     for w in want.values()])
    for n in want:
        if dtype == "bfloat16" and _CANCELLED.search(n):
            continue
        err = _rel(got[n], want[n], floor=0.1 * med)
        assert err <= bound, (what, n, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
def test_small_resnet_training_step_matches_reference(kind, dtype,
                                                      monkeypatch):
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 16, 16).astype(np.float32)
    y = np.array([1, 2, 3, 4], np.float32)
    ref, port, arrays = small_resnets(kind)
    assert sorted(port.collect_params()) == sorted(arrays)
    if dtype == "bfloat16":
        ref.cast("bfloat16")
        port.cast("bfloat16")
        # the reference's aggregated SGD turns bf16 weights into f32
        # (ROADMAP.md queue 3), after which its bf16 convolutions fail:
        # take its per-tensor update, which keeps them bf16
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "1")
    runs = []
    for lib, net in ((pt, port), (mx, ref)):
        ctx = lib.cpu()
        xs = lib.nd.array(x, ctx=ctx).astype(dtype)
        ys = lib.nd.array(y, ctx=ctx)
        params = net.collect_params()
        r = {}
        if dtype == "float32":
            r["eval"] = net(xs).asnumpy()
        loss_fn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
        with lib.autograd.record():
            out = net(xs)
            loss = loss_fn(out, ys)
        loss.backward()
        r["train"], r["loss"] = out.asnumpy(), loss.asnumpy()
        r["grads"] = {n: p.grad().asnumpy() for n, p in params.items()
                      if p.grad_req != "null"}
        r["stats"] = {n: p.data().asnumpy() for n, p in params.items()
                      if p.grad_req == "null"}
        trainer = lib.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                                    "momentum": 0.9})
        w0 = {n: p.data().asnumpy() for n, p in params.items()
              if p.grad_req != "null"}
        for _ in range(2):
            with lib.autograd.record():
                loss = loss_fn(net(xs), ys)
            loss.backward()
            trainer.step(4)
        r["delta"] = {n: params[n].data().asnumpy() - w0[n] for n in w0}
        runs.append(r)
    got, want = runs
    bound = BOUND[dtype]
    for k in ("eval", "train", "loss"):
        if k in want:
            assert _rel(got[k], want[k]) <= bound["out"], k
    assert sorted(got["stats"]) == sorted(want["stats"])
    assert all(n.endswith(("running_mean", "running_var"))
               for n in got["stats"])
    for n in want["stats"]:
        assert _rel(got["stats"][n], want["stats"][n]) <= bound["out"], n
    _held(got["grads"], want["grads"], bound["grads"], dtype, "gradients")
    _held(got["delta"], want["delta"], bound["delta"], dtype,
          "two SGD steps")
