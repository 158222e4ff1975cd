#!/usr/bin/env python
"""Performance-trajectory command line over the port's perfwatch store
(counterpart of ``tools/perfwatch.py``).

Commands (cmd defaults to ``report``):

  ingest FILES...   Ingest bench artifacts (files or globs) into the
                    MXNET_PERF_DB / --db store: raw bench-JSON lines,
                    tool stdout captures, or run wrappers
                    (``{"n", "cmd", "rc", "tail", "parsed"}``).
                    Idempotent: each record dedupes on a content
                    fingerprint.
  report [FILES...] Render the verdicted trend table: every
                    (device_kind, metric) series with its rolling-median
                    baseline, MAD-scored verdict (regressed / improved /
                    flat) and the change point where the last level
                    shift began. With no store configured, an ephemeral
                    one is built from FILES.
  micro             The paired-median seam gate: the MXNET_PERFWATCH=0
                    ingestion seam against the seam stripped out, on the
                    bench emit loop (interleaved round-robin trials,
                    median of per-round paired ratios), below
                    --threshold.

Flags: ``--gate`` exits nonzero on any confirmed regression, naming the
metric; ``--export-autotune-corpus [DIR]`` joins stored records that
carry an autotune table into per-device_kind (features, measured-time)
corpus files in the MXNET_AUTOTUNE_CACHE shape; ``--fleet`` publishes
(after ingest) or merges (before report) the latest envelopes through
the fleet KV.

Usage: python -m mxnet_tpu_torch.tools.perfwatch [report|ingest|micro]
           [files...] [--db DIR] [--gate] [--metric M]
           [--export-autotune-corpus [DIR]] [--fleet] [--json]
Exit code 0 = no confirmed regression (and micro within threshold).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time



def _expand(paths):
    out = []
    for p in paths:
        hits = sorted(glob.glob(p))
        out.extend(hits if hits else [p])
    return out


def _render(rows, root):
    kinds = sorted({r["device_kind"] for r in rows})
    print("perf trajectory: %s (%d series, %d device kind%s)"
          % (root, len(rows), len(kinds),
             "" if len(kinds) == 1 else "s"))
    print("%-11s %-52s %3s %12s %12s %8s %10s %s"
          % ("device", "metric", "n", "latest", "baseline",
             "delta", "verdict", "shift"))
    for r in rows:
        base = "%12.4g" % r["baseline"] if r["baseline"] is not None \
            else "%12s" % "-"
        shift = ""
        cp = r.get("change_point")
        if cp:
            shift = "%s@%s %+.1f%%" % (cp["kind"], cp["at"],
                                       cp["delta_rel"] * 100)
        print("%-11s %-52s %3d %12.4g %s %+7.1f%% %10s %s"
              % (r["device_kind"], r["metric"][:52], r["n"],
                 r["latest"], base, r["delta_rel"] * 100,
                 r["verdict"], shift))
    for r in rows:
        if r["verdict"] != "flat":
            tail = ", ".join(
                "%s %.4g" % (lab, v) for lab, v in
                list(zip(r["rounds"], r["values"]))[-8:])
            print("  %s %s (score %.1f MAD, tol %.0f%%): %s"
                  % (r["verdict"].upper(), r["metric"],
                     r["score"], r["tol"] * 100, tail))


def _micro(args):
    """Paired-median seam gate: the MXNET_PERFWATCH=0 seam against the
    seam stripped out, on the bench emit loop; enabled (a temporary
    store) is informational."""
    os.environ["MXNET_PERFWATCH"] = "0"
    os.environ.pop("MXNET_PERF_DB", None)
    from mxnet_tpu_torch import perfwatch
    from mxnet_tpu_torch.tools import bench_json
    perfwatch.refresh()

    devnull = open(os.devnull, "w")
    tmpdb = tempfile.mkdtemp(prefix="perfwatch_micro_")

    def record(i):
        return {"metric": "perfwatch_micro_probe",
                "value": 1000.0 + i, "unit": "images/sec",
                "vs_baseline": 1.0 + i * 1e-6,
                "env": {"device_kind": "micro", "git_rev": None,
                        "flags": {}}}

    def emit_loop(iters):
        t0 = time.perf_counter()
        for i in range(iters):
            bench_json.emit(record(i), source="micro",
                            stream=devnull)
        return time.perf_counter() - t0

    real_seam = perfwatch.maybe_record

    def run_stripped():
        perfwatch.maybe_record = lambda rec, source="": None
        try:
            return emit_loop(args.iters)
        finally:
            perfwatch.maybe_record = real_seam

    def run_disabled():
        os.environ["MXNET_PERFWATCH"] = "0"
        perfwatch.refresh()
        assert not perfwatch.enabled()
        return emit_loop(args.iters)

    def run_enabled():
        os.environ["MXNET_PERFWATCH"] = "1"
        os.environ["MXNET_PERF_DB"] = tmpdb
        perfwatch.refresh()
        try:
            return emit_loop(args.iters)
        finally:
            os.environ["MXNET_PERFWATCH"] = "0"
            os.environ.pop("MXNET_PERF_DB", None)
            perfwatch.refresh()

    try:
        variants = (("stripped", run_stripped),
                    ("disabled", run_disabled),
                    ("enabled", run_enabled))
        emit_loop(max(5, args.iters // 5))      # warmup outside timing
        trials = {name: [] for name, _ in variants}
        for _ in range(max(1, args.repeats)):
            for name, run in variants:          # interleaved round-robin
                trials[name].append(run())
        results = {name: min(ts) for name, ts in trials.items()}
    finally:
        devnull.close()
        shutil.rmtree(tmpdb, ignore_errors=True)

    base = results["stripped"]
    print("\nperfwatch micro: %d emits x %d interleaved repeats (min)"
          % (args.iters, args.repeats))
    print("%-10s %12s %16s %12s" % ("variant", "total ms", "us/emit",
                                    "vs stripped"))
    for name in ("stripped", "disabled", "enabled"):
        dt = results[name]
        print("%-10s %12.2f %16.2f %+11.1f%%"
              % (name, dt * 1e3, dt / args.iters * 1e6,
                 100.0 * (dt / base - 1)))
    ratios = sorted(d / s for d, s in zip(trials["disabled"],
                                          trials["stripped"]))
    mid = len(ratios) // 2
    median = ratios[mid] if len(ratios) % 2 else \
        (ratios[mid - 1] + ratios[mid]) / 2.0
    overhead = median - 1
    print("\ndisabled-seam overhead: %.1f%% median of %d paired "
          "rounds (threshold %.0f%%)"
          % (overhead * 100, len(ratios), args.threshold * 100))
    if args.json:
        bench_json.emit(
            {"metric": "perfwatch_micro_disabled_overhead",
             "value": round(median, 4), "unit": "disabled/stripped",
             "iters": args.iters, "repeats": args.repeats,
             "enabled_ratio": round(results["enabled"] / base, 4)},
            source="perfwatch_micro")
    if overhead > args.threshold:
        print("FAIL: disabled perfwatch seam costs more than %.0f%% "
              "on the bench emit loop" % (args.threshold * 100))
        return 1
    print("PERFWATCH_MICRO_OK")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cmd", nargs="?", default="report",
                    choices=("report", "ingest", "micro"))
    ap.add_argument("paths", nargs="*",
                    help="bench artifacts (files or globs) to ingest")
    ap.add_argument("--db", default=None,
                    help="store root (default: MXNET_PERF_DB; report "
                         "falls back to an ephemeral store over FILES)")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero on any confirmed regression")
    ap.add_argument("--metric", default=None,
                    help="restrict report/gate to one headline metric")
    ap.add_argument("--device-kind", default=None,
                    help="restrict report/gate to one device kind")
    ap.add_argument("--export-autotune-corpus", nargs="?", const="",
                    default=None, metavar="DIR", dest="corpus",
                    help="write per-device_kind (features, "
                         "measured-time) corpus files (autotune-cache "
                         "shaped) from stored records with an autotune "
                         "table")
    ap.add_argument("--fleet", action="store_true",
                    help="publish (after ingest) / merge (before "
                         "report) latest envelopes via the fleet KV")
    ap.add_argument("--json", action="store_true",
                    help="also emit machine-readable output")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--threshold", type=float, default=0.05)
    args = ap.parse_intermixed_args(argv)

    if args.cmd == "micro":
        return _micro(args)

    from mxnet_tpu_torch import perfwatch

    ephemeral = None
    db = perfwatch.open_db(args.db)
    if db is None:
        if args.cmd == "ingest":
            print("FAIL: ingest needs a store — set MXNET_PERF_DB "
                  "or pass --db")
            return 2
        ephemeral = tempfile.mkdtemp(prefix="perfwatch_report_")
        db = perfwatch.PerfDB(ephemeral)

    try:
        paths = _expand(args.paths) if args.paths else []
        added = 0
        for p in paths:
            try:
                fps = db.ingest_file(p)
            except (OSError, ValueError) as e:
                print("WARN: cannot ingest %s (%s: %s)"
                      % (p, type(e).__name__, e))
                continue
            added += len(fps)
            if args.cmd == "ingest":
                print("ingested %-40s %d new record%s"
                      % (os.path.basename(p), len(fps),
                         "" if len(fps) == 1 else "s"))
        if args.cmd == "ingest":
            print("perfwatch: %d new record%s in %s"
                  % (added, "" if added == 1 else "s", db.root))
            if args.fleet:
                n = perfwatch.publish_fleet(db)
                print("perfwatch: published %d series to fleet KV" % n)

        rc = 0
        if args.cmd == "report" or args.gate:
            if args.fleet:
                merged = perfwatch.merge_fleet(db)
                print("perfwatch: merged %d fleet record%s"
                      % (merged, "" if merged == 1 else "s"))
            rows = perfwatch.scan(db, device_kind=args.device_kind,
                                  metric=args.metric)
            if args.cmd == "report":
                if rows:
                    _render(rows, "(ephemeral) %d artifacts"
                            % len(paths) if ephemeral else db.root)
                else:
                    print("perf trajectory: empty store (%s)"
                          % db.root)
            if args.json:
                print(json.dumps([{k: v for k, v in r.items()
                                   if k not in ("values", "rounds")}
                                  for r in rows]))
            regressed = [r for r in rows if r["verdict"] == "regressed"]
            if args.gate:
                for r in regressed:
                    print("PERFWATCH REGRESSION: %s on %s — latest "
                          "%.4g vs baseline %.4g (%+.1f%%, %.1f MAD, "
                          "tol %.0f%%)"
                          % (r["metric"], r["device_kind"],
                             r["latest"], r["baseline"],
                             r["delta_rel"] * 100, r["score"],
                             r["tol"] * 100))
                if regressed:
                    print("FAIL: %d confirmed regression%s"
                          % (len(regressed),
                             "" if len(regressed) == 1 else "s"))
                    rc = 1
                else:
                    print("PERFWATCH_GATE_OK (%d series flat or "
                          "improved)" % len(rows))

        if args.corpus is not None:
            out_dir = args.corpus or None
            exported = perfwatch.export_autotune_corpus(
                db, out_dir=out_dir)
            if not exported:
                print("perfwatch: no records with an autotune table in "
                      "the store — nothing to export")
            for kind, (path, n) in sorted(exported.items()):
                print("perfwatch: exported %d corpus entr%s for %s "
                      "-> %s" % (n, "y" if n == 1 else "ies", kind,
                                 path))
        return rc
    finally:
        if ephemeral is not None:
            shutil.rmtree(ephemeral, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
