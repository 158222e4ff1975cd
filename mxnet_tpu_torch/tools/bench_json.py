#!/usr/bin/env python
"""The bench-JSON record schema, the port's own copy (counterpart of
``tools/bench_json.py``): one emit and validate helper for every tool
that measures something.

A tool ends its run by printing exactly one JSON object on one stdout
line, shaped::

    {"metric": <snake_case str>,     # headline series name
     "value":  <finite number>,      # the headline measurement
     "unit":   <non-empty str>,      # "ms", "images/sec", ...
     ...}                            # any extra JSON-serializable
                                     # context (sub-metrics, tables)

:func:`emit` (a) validates the record, so a malformed one fails the tool
loudly instead of poisoning a series, (b) stamps the environment
fingerprint (device kind, git revision, ``MXNET_*`` variables) that the
store partitions on, and (c) hands the record to
``mxnet_tpu_torch.perfwatch.maybe_record``, inert unless
``MXNET_PERF_DB`` names a store.

:func:`last_json_line` is the rule that reads a record back from a
tool's stdout: the last line that parses as a JSON object.

Run as a script, it validates the last record of its standard input:
``some_tool --json | python -m mxnet_tpu_torch.tools.bench_json``.
"""
from __future__ import annotations

import json
import math
import re
import sys
from typing import Any, Dict, List, Optional

__all__ = ["REQUIRED", "validate", "check", "emit", "last_json_line"]

REQUIRED = ("metric", "value", "unit")

_METRIC_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def validate(record: Any) -> List[str]:
    """All the ways ``record`` violates the bench-JSON schema
    (empty list = valid)."""
    if not isinstance(record, dict):
        return ["record is %s, not a dict" % type(record).__name__]
    problems = []
    metric = record.get("metric")
    if not isinstance(metric, str) or not _METRIC_RE.match(metric):
        problems.append("metric %r is not a snake_case identifier"
                        % (metric,))
    value = record.get("value")
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        problems.append("value %r is not a number" % (value,))
    elif not math.isfinite(value):
        problems.append("value %r is not finite" % (value,))
    unit = record.get("unit")
    if not isinstance(unit, str) or not unit:
        problems.append("unit %r is not a non-empty string" % (unit,))
    for k in record:
        if not isinstance(k, str):
            problems.append("non-string key %r" % (k,))
    env = record.get("env")
    if env is not None:
        if not isinstance(env, dict) or \
                not isinstance(env.get("device_kind"), str):
            problems.append("env %r lacks a device_kind string"
                            % (env,))
    try:
        json.dumps(record)
    except (TypeError, ValueError) as e:
        problems.append("not JSON-serializable: %s" % e)
    return problems


def check(record: Any) -> Dict[str, Any]:
    """Raise ValueError (naming every problem) unless ``record`` is
    schema-valid; returns it for chaining."""
    problems = validate(record)
    if problems:
        raise ValueError("bench-JSON schema violation: "
                         + "; ".join(problems))
    return record


def emit(record: Dict[str, Any], *, source: str = "",
         stream=None) -> Dict[str, Any]:
    """Validate, fingerprint, record, and print one bench-JSON line.

    The record is printed on its own stdout line AFTER being stamped
    with the perfwatch environment fingerprint and offered to the
    trajectory store, both best-effort: the tool must still report when
    the observability layer is unavailable. Returns the (enriched)
    record."""
    check(record)
    if "env" not in record:
        try:
            from mxnet_tpu_torch import perfwatch
            record["env"] = perfwatch.environment_fingerprint()
        except Exception:
            pass
    try:
        from mxnet_tpu_torch import perfwatch
        perfwatch.maybe_record(record, source=source)
    except Exception:
        pass
    print(json.dumps(record), file=stream or sys.stdout)
    return record


def last_json_line(text: str) -> Optional[Dict[str, Any]]:
    """The last stdout line that parses as a JSON object (warnings or
    stray prints between records do not confuse it, but a tool must
    keep its record on ONE line)."""
    out = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                out = obj
    return out


if __name__ == "__main__":
    # validator mode: pipe tool stdout (or a record) through it
    rec = last_json_line(sys.stdin.read())
    if rec is None:
        print("bench_json: no JSON object line found")
        sys.exit(1)
    probs = validate(rec)
    for p in probs:
        print("bench_json: %s" % p)
    print("bench_json: %s (metric=%s)"
          % ("INVALID" if probs else "OK", rec.get("metric")))
    sys.exit(1 if probs else 0)
