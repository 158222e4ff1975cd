#!/usr/bin/env python
"""Compile-watch overhead and steady-state gates (counterpart of
``tools/compile_micro.py``).

The port's compile-watch sits at its capture sites only: a hybridized
block's CachedOp, the fused backward and step. Its eager ops run
torch's kernels as they are and compile nothing, so the reference's
eager-dispatch gate has no counterpart (a gap kept on purpose: there is
no eager program to watch). Two assertions:

1. **Disabled-path overhead <5%** on calls of a hybridized block, whose
   CachedOp checks the gate on each call. Variants, interleaved
   round-robin with paired-median scoring:

     stripped   ``compilewatch.enabled`` replaced by a constant False
                (the code before the watch)
     disabled   the default: MXNET_TELEMETRY off, one gate check a call
     enabled    MXNET_TELEMETRY=1: signature lookup and hit accounting

2. **Zero steady-state recompiles** on the Gluon hybridize() + Trainer
   step: after ``--warmup`` steps every program cache is warm, and
   ``--steps`` more steps add no recompile, no recapture and no new
   program.

Usage: python -m mxnet_tpu_torch.tools.compile_micro [--ops 300]
           [--repeats 5] [--threshold 0.05] [--steps 5] [--warmup 3]
           [--skip-steady] [--cpu]
Exit 0 = both gates pass.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from mxnet_tpu_torch.tools.telemetry_micro import paired_median


def build_block(ctx):
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=4), nn.Dense(4,
                                                                 in_units=8))
    net.initialize(mx.initializer.Xavier(), ctx=ctx)
    net.hybridize()
    x = nd.array(np.ones((4, 4), np.float32), ctx=ctx)
    return net, x


def bench_once(ops: int, net, x) -> float:
    """Seconds for ``ops`` calls of the hybridized block (no recording):
    the CachedOp's dispatch and its gate are the measured path."""
    t0 = time.perf_counter()
    for _ in range(ops):
        out = net(x)
    out.wait_to_read()
    return time.perf_counter() - t0


def overhead_gate(args, ctx) -> int:
    os.environ.pop("MXNET_TELEMETRY", None)
    from mxnet_tpu_torch import compilewatch, telemetry
    telemetry.refresh()
    net, x = build_block(ctx)
    bench_once(max(20, args.ops // 4), net, x)     # warm every cache
    real = compilewatch.enabled

    def run_stripped():
        compilewatch.enabled = lambda: False
        try:
            return bench_once(args.ops, net, x)
        finally:
            compilewatch.enabled = real

    def run_disabled():
        telemetry.refresh()
        assert not telemetry.enabled()
        return bench_once(args.ops, net, x)

    def run_enabled():
        telemetry.enable(True)
        try:
            return bench_once(args.ops, net, x)
        finally:
            telemetry.refresh()

    variants = (("stripped", run_stripped), ("disabled", run_disabled),
                ("enabled", run_enabled))
    trials = {name: [] for name, _ in variants}
    for _ in range(max(1, args.repeats)):
        for name, run in variants:              # interleaved round-robin
            trials[name].append(run())
    results = {name: min(ts) for name, ts in trials.items()}

    base = results["stripped"]
    print("capture-site micro: %d hybridized calls x %d interleaved "
          "repeats (min)" % (args.ops, args.repeats))
    print("%-10s %12s %14s %12s" % ("variant", "total ms", "us/call",
                                    "vs stripped"))
    for name in ("stripped", "disabled", "enabled"):
        dt = results[name]
        print("%-10s %12.2f %14.2f %+11.1f%%"
              % (name, dt * 1e3, dt / args.ops * 1e6,
                 100.0 * (dt / base - 1)))
    overhead = paired_median(trials["disabled"], trials["stripped"]) - 1
    print("disabled-path overhead: %.1f%% median of %d paired rounds "
          "(threshold %s)"
          % (overhead * 100, len(trials["disabled"]),
             "%.0f%%" % (args.threshold * 100) if args.threshold > 0
             else "off"))
    if args.threshold > 0 and overhead > args.threshold:
        print("FAIL: disabled compile-watch costs more than %.0f%% on a "
              "hybridized call" % (args.threshold * 100))
        return 1
    return 0


def steady_state_gate(args, ctx) -> int:
    """The hybridized trainer step adds no program after warm-up (the
    compile_report workload)."""
    os.environ["MXNET_TELEMETRY"] = "1"
    from mxnet_tpu_torch import compilewatch, telemetry
    from mxnet_tpu_torch.tools.compile_report import build_step
    telemetry.refresh()
    step = build_step(batch=8, hidden=32, ctx=ctx)
    for _ in range(max(1, args.warmup)):
        loss = step()
    loss.wait_to_read()
    before = len(compilewatch.programs())
    for _ in range(max(1, args.steps)):
        loss = step()
    loss.wait_to_read()
    steady = compilewatch.programs()[before:]
    recompiles = [r for r in steady if r["kind"] == "recompile"]
    print("hybridize steady state: %d compiles / %d recompiles over %d "
          "post-warmup steps" % (len(steady), len(recompiles), args.steps))
    os.environ.pop("MXNET_TELEMETRY", None)
    telemetry.refresh()
    if recompiles:
        for r in recompiles:
            print("FAIL: steady-state recompile of %s: %s"
                  % (r["fn"], r["changed"]))
        return 1
    if steady:
        print("FAIL: %d program(s) still compiling after %d warmup steps: "
              "%s" % (len(steady), args.warmup,
                      sorted({r["fn"] for r in steady})))
        return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ops", type=int, default=300)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="max fractional overhead of the disabled path "
                         "vs stripped; <=0 reports without asserting")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--skip-steady", action="store_true",
                    help="overhead gate only")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import mxnet_tpu_torch as mx
    ctx = mx.cpu() if args.cpu else mx.gpu()
    rc = overhead_gate(args, ctx)
    if not args.skip_steady:
        rc = rc or steady_state_gate(args, ctx)
    if rc == 0:
        print("COMPILE_MICRO_OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
