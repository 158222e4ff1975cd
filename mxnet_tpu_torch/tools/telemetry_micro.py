#!/usr/bin/env python
"""Telemetry overhead micro-bench on the engine's push path (counterpart
of ``tools/telemetry_micro.py``).

With ``MXNET_TELEMETRY`` unset a push pays only the gate check that
``engine.push_async`` makes. This tool measures the native engine's
push + wait throughput three ways:

  stripped   the instrumentation bypassed (``engine._tele_live``
             replaced by a constant False: the code before telemetry)
  disabled   the default: MXNET_TELEMETRY off, each push pays the gate
  enabled    MXNET_TELEMETRY=1: timestamps, two histogram observations
             and the gauges an op

Trials are interleaved round-robin (machine noise dwarfs a
sub-microsecond gate when the variants run in separate blocks) and each
variant scores its best (min) trial; the overhead is the median of the
per-round paired ratios disabled/stripped, which must stay within
--threshold (default 5%).

Usage: python -m mxnet_tpu_torch.tools.telemetry_micro [--ops 3000]
           [--repeats 5] [--threshold 0.05]
Exit code 0 = overhead within threshold.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def bench_once(ops: int) -> float:
    """Seconds for ``ops`` no-op pushes + one wait_for_all on a fresh
    native engine in naive (synchronous) mode: every push runs its op
    inline, so the measurement sees the whole instrumented dispatch
    without worker-thread contention."""
    from mxnet_tpu_torch.engine import NativeDependencyEngine
    e = NativeDependencyEngine(num_workers=1, naive=True)
    try:
        v = e.new_var()
        fn = _noop
        t0 = time.perf_counter()
        for _ in range(ops):
            e.push_async(fn, write_vars=(v,), label="micro_op")
        e.wait_for_all()
        return time.perf_counter() - t0
    finally:
        e.close()


def _noop():
    pass


def paired_median(num, den) -> float:
    ratios = sorted(n / d for n, d in zip(num, den))
    mid = len(ratios) // 2
    return ratios[mid] if len(ratios) % 2 else \
        (ratios[mid - 1] + ratios[mid]) / 2.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ops", type=int, default=3000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="max fractional overhead of the disabled path "
                         "vs stripped; <=0 reports without asserting")
    args = ap.parse_args(argv)

    os.environ.pop("MXNET_TELEMETRY", None)
    from mxnet_tpu_torch import engine, telemetry

    real_live = engine._tele_live

    def run_stripped():
        engine._tele_live = lambda: False
        try:
            return bench_once(args.ops)
        finally:
            engine._tele_live = real_live

    def run_disabled():
        telemetry.refresh()
        assert not telemetry.enabled()
        return bench_once(args.ops)

    def run_enabled():
        telemetry.enable(True)
        try:
            return bench_once(args.ops)
        finally:
            telemetry.refresh()
            telemetry.reset()

    variants = (("stripped", run_stripped), ("disabled", run_disabled),
                ("enabled", run_enabled))
    # the warm-up builds and loads the native library outside the timing
    bench_once(max(100, args.ops // 10))
    trials = {name: [] for name, _ in variants}
    for _ in range(max(1, args.repeats)):
        for name, run in variants:          # interleaved round-robin
            trials[name].append(run())
    results = {name: min(ts) for name, ts in trials.items()}

    base = results["stripped"]
    print("\nengine micro: %d ops x %d interleaved repeats (min)"
          % (args.ops, args.repeats))
    print("%-10s %12s %14s %12s" % ("variant", "total ms", "us/op",
                                    "vs stripped"))
    for name in ("stripped", "disabled", "enabled"):
        dt = results[name]
        print("%-10s %12.2f %14.2f %+11.1f%%"
              % (name, dt * 1e3, dt / args.ops * 1e6,
                 100.0 * (dt / base - 1)))

    # pair each round's disabled trial with the same round's stripped
    # trial: a load spike inflates both halves of its round and cancels
    overhead = paired_median(trials["disabled"], trials["stripped"]) - 1
    print("\ndisabled-path overhead: %.1f%% median of %d paired rounds "
          "(threshold %s)"
          % (overhead * 100, len(trials["disabled"]),
             "%.0f%%" % (args.threshold * 100) if args.threshold > 0
             else "off"))
    if args.threshold > 0 and overhead > args.threshold:
        print("FAIL: disabled telemetry costs more than %.0f%% on the "
              "engine push path" % (args.threshold * 100))
        return 1
    print("TELEMETRY_MICRO_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
