#!/usr/bin/env python
"""Run a workload under compile-watch and print the per-program table
(counterpart of ``tools/compile_report.py``).

The port's programs are the CUDA graphs its capture sites build (a
hybridized block's CachedOp, the fused backward and step): for every
watched site one row with compiles, recompiles, capture seconds, FLOPs
and the graph's memory (``compilewatch.report``; the CPU runs each
program eagerly and captures no graph, so it has no graph bytes).

Workload: the Gluon hybridize() + Trainer loop, scaled down so the
report runs anywhere: ``--warmup`` steps fill every program cache, then
``--steps`` steady steps must add ZERO recompiles and ZERO recaptures
(the gate; a recompile names the argument whose shape, dtype or stride
changed).

Usage: python -m mxnet_tpu_torch.tools.compile_report [--batch 16]
           [--steps 5] [--warmup 3] [--hidden 64] [--json] [--no-gate]
           [--cpu]
Exit 0 = steady state clean (or --no-gate).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_step(batch: int, hidden: int, ctx=None):
    """One hybridized Dense x 3 + SoftmaxCrossEntropy + SGD-momentum step
    on ``ctx`` (the card by default)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon import nn

    ctx = ctx if ctx is not None else mx.gpu()
    net = nn.HybridSequential()
    net.add(nn.Dense(hidden, activation="relu"),
            nn.Dense(hidden, activation="relu"), nn.Dense(10))
    net.initialize(init=mx.initializer.Xavier(), ctx=ctx)
    net(nd.ones((2, 32), ctx=ctx))         # resolve deferred shapes
    net.hybridize(static_alloc=True, static_shape=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loss_fn.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05, "momentum": 0.9})
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(batch, 32).astype(np.float32), ctx=ctx)
    y = nd.array(rng.randint(0, 10, (batch,)).astype(np.float32), ctx=ctx)

    def step():
        with autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        loss.backward()
        trainer.step(batch)
        return loss

    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5,
                    help="steady-state steps (must not recompile)")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--json", action="store_true",
                    help="emit the aggregate rows as JSON instead")
    ap.add_argument("--no-gate", action="store_true",
                    help="report only; don't fail on steady-state "
                         "recompiles / missing cost figures")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    os.environ["MXNET_TELEMETRY"] = "1"
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compilewatch, telemetry
    telemetry.refresh()
    assert telemetry.enabled()
    compilewatch.reset()

    step = build_step(args.batch, args.hidden,
                      mx.cpu() if args.cpu else mx.gpu())
    for _ in range(max(1, args.warmup)):
        loss = step()
    loss.wait_to_read()

    warm = len(compilewatch.programs())
    warm_recompiles = sum(1 for r in compilewatch.programs()
                          if r["kind"] == "recompile")
    for _ in range(max(1, args.steps)):
        loss = step()
    loss.wait_to_read()
    steady = compilewatch.programs()[warm:]

    rows = compilewatch.report()
    steady_rec = [r for r in steady if r["kind"] == "recompile"]
    steady_recap = [r for r in steady if r["kind"] == "recapture"]
    if args.json:
        print(json.dumps({"rows": rows, "steady_recompiles": len(steady_rec),
                          "steady_recaptures": len(steady_recap),
                          "warmup_programs": warm}, default=str))
    else:
        print("compile report: %d warmup + %d steady steps, batch=%d"
              % (args.warmup, args.steps, args.batch))
        print(compilewatch.render_report(rows))
        if warm_recompiles:
            print("\nwarmup recompile attribution:")
            for r in compilewatch.recompile_log():
                print("  %-20s %s" % (r["fn"], r["changed"]))

    problems = []
    if steady_rec:
        problems.append(
            "%d steady-state recompile(s): %s"
            % (len(steady_rec),
               "; ".join("%s %s" % (r["fn"], r["changed"])
                         for r in steady_rec)))
    if steady_recap:
        problems.append("%d steady-state recapture(s): %s"
                        % (len(steady_recap),
                           sorted({r["fn"] for r in steady_recap})))
    steady_fresh = [r for r in steady
                    if r["kind"] not in ("recompile", "recapture")]
    if steady_fresh:
        problems.append(
            "%d program(s) still compiling after warmup (grow "
            "--warmup or chase the shapes): %s"
            % (len(steady_fresh), sorted({r["fn"] for r in steady_fresh})))
    total_flops = sum(r["flops"] or 0 for r in rows)
    total_bytes = sum(sum(r["bytes"].values()) for r in rows)
    if not args.json:
        print("\ntotal: %d programs, %.3fs warming up and capturing, %s "
              "flops, %s graph bytes"
              % (sum(r["compiles"] for r in rows),
                 sum(r["compile_seconds"] for r in rows),
                 compilewatch._fmt_count(total_flops),
                 compilewatch._fmt_count(total_bytes)
                 if not args.cpu else "-"))
    # every program counts its FLOPs; only the card captures a graph and
    # so has graph memory to report
    if total_flops <= 0:
        problems.append("no program reported FLOPs")
    if not args.cpu and total_bytes <= 0:
        problems.append("no program reported graph memory")

    if problems and not args.no_gate:
        for p in problems:
            print("FAIL: %s" % p)
        return 1
    print("COMPILE_REPORT_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
