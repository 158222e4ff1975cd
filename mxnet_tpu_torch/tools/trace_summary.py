#!/usr/bin/env python
"""Aggregate a chrome-trace JSON (the port's ``profiler.dump`` output)
into per-label and per-category time totals (counterpart of
``tools/trace_summary.py``): where a run spent its time without opening
chrome://tracing.

Reads complete events (``ph == "X"``); instant and counter events are
counted but carry no duration. Output: one row per event name with
count / total / mean / max duration, sorted by total, plus a
per-category rollup (engine / step / comm / io / checkpoint / compile /
user, and ``device::kernel`` events of a ``profile_device=True`` run).
``compile`` spans (compilewatch's ``compile::<fn>`` events: the capture
sites' warm-ups and captures) get their own breakdown, per-fn compiles,
recompiles and FLOPs from the span args, and a compile-vs-everything
line. ``comm`` spans (commwatch's ``comm::<op>``) get a collective
table: per-(op, axis) count, bytes, bandwidth and the exposed versus
overlapped split. ``modelwatch`` events (``modelwatch::sample``) get a
training-dynamics table: per-layer samples, mean/max grad norm, mean
update-to-weight ratio and anomalies, plus the last gradient-noise-scale
reading. Distributed-trace spans (``tracing.TraceStore.chrome``,
grouped by the ``trace`` id in their args) get a per-trace critical-path
table, slowest first.

Usage: python -m mxnet_tpu_torch.tools.trace_summary profile.json
           [--top 30] [--by name|category|both]
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

# the span categories tracing.py emits; other categories sharing a
# `trace` arg (tagged engine ops) ride along into the same per-trace
# bucket
_TRACE_CATS = {"fleet", "attempt", "hedge", "wire", "replica",
               "assembly", "sched", "engine", "serve"}


def summarize(events):
    """(per_name, per_cat): name/category -> dict(count, total_us,
    max_us) over complete ("X") events."""
    per_name = defaultdict(lambda: {"count": 0, "total_us": 0.0,
                                    "max_us": 0.0, "cat": ""})
    per_cat = defaultdict(lambda: {"count": 0, "total_us": 0.0,
                                   "max_us": 0.0})
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0))
        cat = e.get("cat", "?")
        row = per_name[e.get("name", "?")]
        row["count"] += 1
        row["total_us"] += dur
        row["max_us"] = max(row["max_us"], dur)
        row["cat"] = cat
        crow = per_cat[cat]
        crow["count"] += 1
        crow["total_us"] += dur
        crow["max_us"] = max(crow["max_us"], dur)
    return dict(per_name), dict(per_cat)


def summarize_compile(events):
    """Per-fn rollup of compilewatch's ``compile`` spans: count,
    recompiles, total duration, FLOPs (from the span args)."""
    rows = defaultdict(lambda: {"count": 0, "recompiles": 0,
                                "total_us": 0.0, "flops": 0.0})
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "compile":
            continue
        name = e.get("name", "?")
        if name.startswith("compile::"):
            name = name[len("compile::"):]
        row = rows[name]
        row["count"] += 1
        row["total_us"] += float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if args.get("kind") == "recompile":
            row["recompiles"] += 1
        if isinstance(args.get("flops"), (int, float)):
            row["flops"] += args["flops"]
    return dict(rows)


def render_compile(rows, total_us_all):
    out = []
    items = sorted(rows.items(), key=lambda kv: -kv[1]["total_us"])
    width = max([len("compiled fn")] + [len(k) for k, _ in items]) + 2
    out.append("%-*s %9s %10s %12s %12s"
               % (width, "compiled fn", "compiles", "recompiles",
                  "total", "flops"))
    total = 0.0
    for k, r in items:
        total += r["total_us"]
        out.append("%-*s %9d %10d %12s %12s"
                   % (width, k, r["count"], r["recompiles"],
                      _fmt_us(r["total_us"]),
                      ("%.3g" % r["flops"]) if r["flops"] else "-"))
    rest = max(0.0, total_us_all - total)
    share = 100.0 * total / total_us_all if total_us_all else 0.0
    out.append("compile time %s vs everything else %s (%.1f%% of "
               "traced time)" % (_fmt_us(total), _fmt_us(rest), share))
    return "\n".join(out)


def summarize_comm(events):
    """Per-(op, axis) rollup of commwatch's ``comm`` spans: count,
    bytes, duration split exposed/overlapped (from the span args)."""
    rows = defaultdict(lambda: {"count": 0, "bytes": 0.0,
                                "total_us": 0.0, "exposed_us": 0.0,
                                "overlapped_us": 0.0})
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "comm":
            continue
        name = e.get("name", "?")
        if name.startswith("comm::"):
            name = name[len("comm::"):]
        args = e.get("args") or {}
        row = rows[(name, str(args.get("axis", "?")))]
        dur = float(e.get("dur", 0.0))
        row["count"] += 1
        row["total_us"] += dur
        if isinstance(args.get("bytes"), (int, float)):
            row["bytes"] += args["bytes"]
        key = "exposed_us" if args.get("exposed") else "overlapped_us"
        row[key] += dur
    return dict(rows)


def _fmt_b(v: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if v >= div:
            return "%.2f%s" % (v / div, unit)
    return "%.0fB" % v


def render_comm(rows):
    out = []
    items = sorted(rows.items(), key=lambda kv: -kv[1]["total_us"])
    out.append("%-16s %-10s %8s %10s %12s %11s %12s %12s"
               % ("collective", "axis", "count", "bytes", "total",
                  "bandwidth", "exposed", "overlapped"))
    for (op, axis), r in items:
        bw = (r["bytes"] / (r["total_us"] / 1e6)
              if r["total_us"] > 0 else 0.0)
        out.append("%-16s %-10s %8d %10s %12s %9s/s %12s %12s"
                   % (op, axis, r["count"], _fmt_b(r["bytes"]),
                      _fmt_us(r["total_us"]), _fmt_b(bw),
                      _fmt_us(r["exposed_us"]),
                      _fmt_us(r["overlapped_us"])))
    return "\n".join(out)


def summarize_modelwatch(events):
    """Per-layer rollup of modelwatch's ``modelwatch::sample`` events:
    sample count, mean/max grad norm, mean update ratio, anomaly
    count; plus the last noise-scale reading (run-level)."""
    rows = defaultdict(lambda: {"samples": 0, "g_sum": 0.0,
                                "g_max": 0.0, "r_sum": 0.0,
                                "r_n": 0, "anomalies": 0})
    noise = None
    for e in events:
        if e.get("cat") != "modelwatch":
            continue
        args = e.get("args") or {}
        for name, st in (args.get("layers") or {}).items():
            row = rows[name]
            row["samples"] += 1
            g = st.get("g")
            if isinstance(g, (int, float)):
                row["g_sum"] += g
                row["g_max"] = max(row["g_max"], g)
            r = st.get("r")
            if isinstance(r, (int, float)):
                row["r_sum"] += r
                row["r_n"] += 1
        for name in (args.get("anomalies") or ()):
            rows[name]["anomalies"] += 1
        if isinstance(args.get("noise_scale"), (int, float)):
            noise = args["noise_scale"]
    return dict(rows), noise


def render_modelwatch(rows, noise):
    out = []
    items = sorted(rows.items(), key=lambda kv: -kv[1]["g_max"])
    width = max([len("layer")] + [len(k) for k, _ in items]) + 2
    out.append("%-*s %8s %12s %12s %12s %10s"
               % (width, "layer", "samples", "grad_mean", "grad_max",
                  "upd_ratio", "anomalies"))
    for name, r in items:
        n = max(1, r["samples"])
        ratio = ("%.3g" % (r["r_sum"] / r["r_n"])) if r["r_n"] else "-"
        out.append("%-*s %8d %12.4g %12.4g %12s %10d"
                   % (width, name, r["samples"], r["g_sum"] / n,
                      r["g_max"], ratio, r["anomalies"]))
    if noise is not None:
        out.append("gradient noise scale (last reading): %.4g "
                   "(suggested global batch ~%d)"
                   % (noise, max(1, int(round(noise)))))
    return "\n".join(out)


def summarize_traces(events):
    """Distributed-trace spans grouped by the trace id in their args
    (the tracing.TraceStore.chrome export shape): {tid: [span, ...]}
    with each span reduced to the (cat, dur, args) triple
    tracing.critical_path consumes."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _TRACE_CATS:
            continue
        args = e.get("args") or {}
        tid = args.get("trace")
        if not tid:
            continue
        by_tid[str(tid)].append({"cat": e.get("cat"),
                                 "dur": float(e.get("dur", 0.0)),
                                 "args": args})
    return dict(by_tid)


def render_traces(by_tid, limit=10):
    """One critical-path table per trace, slowest first (the
    tracing.render_critical_path format, single source of truth for
    the phase attribution)."""
    try:
        from mxnet_tpu_torch import tracing
    except Exception as e:            # stdlib-only environments still
        return ("distributed traces: %d in file (breakdown needs "
                "mxnet_tpu_torch importable: %s)" % (len(by_tid), e))
    ranked = sorted(((tracing.critical_path(spans), tid)
                     for tid, spans in by_tid.items()),
                    key=lambda r: -r[0]["total_us"])
    out = ["distributed traces: %d in file (slowest %d shown)"
           % (len(ranked), min(limit, len(ranked)))]
    for bd, tid in ranked[:limit]:
        out.append("")
        out.append(tracing.render_critical_path(bd, tid))
    if len(ranked) > limit:
        out.append("(... %d more traces)" % (len(ranked) - limit))
    return "\n".join(out)


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return "%.2fs" % (us / 1e6)
    if us >= 1e3:
        return "%.2fms" % (us / 1e3)
    return "%.0fus" % us


def render(rows, key_header, top=0):
    out = []
    items = sorted(rows.items(), key=lambda kv: -kv[1]["total_us"])
    if top:
        dropped = len(items) - top
        items = items[:top]
    else:
        dropped = 0
    width = max([len(key_header)] + [len(k) for k, _ in items]) + 2
    out.append("%-*s %8s %12s %12s %12s" % (width, key_header, "count",
                                            "total", "mean", "max"))
    for k, r in items:
        mean = r["total_us"] / max(1, r["count"])
        out.append("%-*s %8d %12s %12s %12s"
                   % (width, k, r["count"], _fmt_us(r["total_us"]),
                      _fmt_us(mean), _fmt_us(r["max_us"])))
    if dropped > 0:
        out.append("(... %d more rows; raise --top to see them)"
                   % dropped)
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="chrome-trace JSON (profiler.dump)")
    ap.add_argument("--top", type=int, default=30,
                    help="max per-name rows (0 = all)")
    ap.add_argument("--by", choices=("name", "category", "both"),
                    default="both")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    per_name, per_cat = summarize(events)
    if not per_name:
        print("no complete ('X') events in %s" % args.trace)
        return 1
    if args.by in ("category", "both"):
        print(render(per_cat, "category"))
    if args.by == "both":
        print()
    if args.by in ("name", "both"):
        print(render(per_name, "event", top=args.top))
    compile_rows = summarize_compile(events)
    if compile_rows:
        total_all = sum(r["total_us"] for r in per_cat.values())
        print()
        print(render_compile(compile_rows, total_all))
    comm_rows = summarize_comm(events)
    if comm_rows:
        print()
        print(render_comm(comm_rows))
    mw_rows, noise = summarize_modelwatch(events)
    if mw_rows:
        print()
        print(render_modelwatch(mw_rows, noise))
    trace_rows = summarize_traces(events)
    if trace_rows:
        print()
        print(render_traces(trace_rows, limit=args.top or 10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
