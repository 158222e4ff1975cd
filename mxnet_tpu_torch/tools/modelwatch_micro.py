#!/usr/bin/env python
"""Modelwatch micro-bench: the disabled path's overhead and one host
read a step (counterpart of ``tools/modelwatch_micro.py``).

1. **Disabled path <5%**: with MXNET_MODELWATCH unset, the Trainer step
   pays only the lazy ``Trainer.modelwatch`` resolution and a few
   is-None checks. Interleaved round-robin trials of ``off`` (modelwatch
   disabled) against ``stripped`` (the property replaced by a constant
   None: the Trainer before modelwatch), per-round paired ratios,
   median.

2. **One host read a step with modelwatch on**: a spy on
   ``NDArray.asnumpy`` and ``torch.Tensor.cpu`` counts the reads from
   the device each step makes. With modelwatch enabled the packed
   statistics read is the step's only one: exactly 1.00 a step, with a
   GradGuard (the read is shared, the guard's budget) and without one.

Usage: python -m mxnet_tpu_torch.tools.modelwatch_micro [--steps 120]
           [--repeats 5] [--threshold 0.05] [--width 64] [--cpu]
Exit code 0 = overhead within threshold AND read counts exact.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from mxnet_tpu_torch.tools.telemetry_micro import paired_median

WARMUP = 3


def build(ctx, width=64, layers=6):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    mx.random.seed(0)
    np.random.seed(0)
    net = nn.HybridSequential()
    for _ in range(layers):
        net.add(nn.Dense(width, activation="relu", in_units=width))
    net.initialize(mx.initializer.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01}, kvstore=None)
    return net, trainer


def run_loop(net, trainer, steps, ctx, batch=32, width=64):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    loss_fn = gluon.loss.L2Loss()
    X = nd.array(np.random.rand(batch, width).astype(np.float32), ctx=ctx)
    Y = nd.array(np.random.rand(batch, width).astype(np.float32), ctx=ctx)
    for _ in range(WARMUP):
        with autograd.record():
            loss = loss_fn(net(X), Y)
        loss.backward()
        trainer.step(batch)
    mx.nd.waitall()
    t0 = time.perf_counter()
    for _ in range(steps):
        with autograd.record():
            loss = loss_fn(net(X), Y)
        loss.backward()
        trainer.step(batch)
    mx.nd.waitall()
    return time.perf_counter() - t0


def bench_overhead(args, ctx) -> float:
    """off against stripped, interleaved rounds, paired-median ratio."""
    import mxnet_tpu_torch.gluon.trainer as tmod
    from mxnet_tpu_torch import telemetry
    os.environ.pop("MXNET_MODELWATCH", None)
    telemetry.refresh()
    orig_prop = tmod.Trainer.modelwatch

    def run_off():
        net, tr = build(ctx, args.width)
        return run_loop(net, tr, args.steps, ctx, width=args.width)

    def run_stripped():
        tmod.Trainer.modelwatch = property(lambda self: None)
        try:
            net, tr = build(ctx, args.width)
            return run_loop(net, tr, args.steps, ctx, width=args.width)
        finally:
            tmod.Trainer.modelwatch = orig_prop

    offs, strips = [], []
    run_off()                               # library warm-up round
    for _ in range(max(1, args.repeats)):
        strips.append(run_stripped())       # interleaved round-robin
        offs.append(run_off())
    over = paired_median(offs, strips) - 1
    print("steps=%d repeats=%d" % (args.steps, args.repeats))
    print("%-10s %12s" % ("variant", "ms/step"))
    print("%-10s %12.3f" % ("stripped", min(strips) / args.steps * 1e3))
    print("%-10s %12.3f" % ("off", min(offs) / args.steps * 1e3))
    print("modelwatch disabled-path overhead: %+.1f%% "
          "(paired median of %d rounds)" % (over * 100, args.repeats))
    return over


def bench_syncs(args, ctx):
    """Reads from the device a step with modelwatch on, with and without
    a GradGuard sharing the read."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.guardrails import GradGuard
    os.environ["MXNET_TELEMETRY"] = "1"
    os.environ["MXNET_MODELWATCH"] = "1"
    telemetry.refresh()

    counter = [0]
    orig_np, orig_cpu = mx.nd.NDArray.asnumpy, torch.Tensor.cpu

    def spy_np(self):
        counter[0] += 1
        return orig_np(self)

    def spy_cpu(self, *a, **k):
        counter[0] += 1
        return orig_cpu(self, *a, **k)

    results = {}
    try:
        for label, guard in (("mw only", None),
                             ("mw + guard", GradGuard(nonfinite="skip_step",
                                                      clip_norm=1e9))):
            net, tr = build(ctx, args.width)
            if guard is not None:
                tr.grad_guard = guard
            run_loop(net, tr, 2, ctx, width=args.width)
            mw0 = tr.modelwatch.samples
            mx.nd.NDArray.asnumpy, torch.Tensor.cpu = spy_np, spy_cpu
            counter[0] = 0
            try:
                run_loop(net, tr, args.steps, ctx, width=args.width)
            finally:
                mx.nd.NDArray.asnumpy, torch.Tensor.cpu = orig_np, orig_cpu
            total = args.steps + WARMUP      # run_loop's warm-up steps too
            results[label] = (counter[0] / total,
                              tr.modelwatch.samples - mw0 - total)
    finally:
        os.environ.pop("MXNET_MODELWATCH", None)
        os.environ.pop("MXNET_TELEMETRY", None)
        telemetry.refresh()

    print("\nreads/step with modelwatch fully enabled:")
    for label, (syncs, dsample) in results.items():
        print("  %-12s %.2f read(s)/step (every step sampled: %s)"
              % (label, syncs, dsample == 0))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="max fractional disabled-path overhead; <=0 "
                         "reports without asserting")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    for var in ("MXNET_TELEMETRY", "MXNET_MODELWATCH"):
        os.environ.pop(var, None)
    import mxnet_tpu_torch as mx
    ctx = mx.cpu() if args.cpu else mx.gpu()

    over = bench_overhead(args, ctx)
    syncs = bench_syncs(args, ctx)

    fail = []
    if args.threshold > 0 and over > args.threshold:
        fail.append("disabled-path overhead %.1f%% exceeds %.0f%%"
                    % (over * 100, args.threshold * 100))
    for label, (per_step, dsample) in syncs.items():
        if abs(per_step - 1.0) > 1e-9:
            fail.append("%s: %.2f reads/step (must be exactly 1)"
                        % (label, per_step))
        if dsample != 0:
            fail.append("%s: %d steps missed sampling" % (label, dsample))
    if fail:
        for f in fail:
            print("FAIL: %s" % f)
        return 1
    print("MODELWATCH_MICRO_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
