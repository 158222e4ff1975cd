"""Performance-trajectory store and statistical regression detection
(counterpart of ``mxnet_tpu/perfwatch.py``).

Every tool that measures something ends with one bench-JSON record
(``mxnet_tpu_torch/tools/bench_json.py``: ``{"metric", "value", "unit",
...}``). This module keeps those records over time and says whether the
latest one moved:

**Store.** An append-only series per ``(device_kind, metric)``
(:class:`PerfDB`): one JSONL file per headline metric under
``MXNET_PERF_DB/<device_kind>/``, published by tmp + rename so a reader
never sees a torn file. Each stored envelope carries the raw record and
an environment fingerprint (device kind, git revision, the ``MXNET_*``
variables), so only like-for-like runs compare: the device kind is
``torch.cuda.get_device_name()`` on the card and ``"cpu"`` on the CPU,
and a record that carries its own fingerprint (a TPU record keeps its
TPU kind) never joins another kind's series. Ingest is idempotent on a
content fingerprint.

**Detection.** Three-way verdicts per series (:func:`judge_series`): the
baseline is the median of the preceding window and the deviation score
is MAD-scaled (median absolute deviation x 1.4826), with a relative
tolerance floor so a flat series with near-zero MAD does not alarm on
noise. A regression must clear both the MAD score
(``MXNET_PERFWATCH_MAD_K``) and the tolerance (``MXNET_PERFWATCH_TOL``,
per-metric ``MXNET_PERFWATCH_TOL_OVERRIDES``). :func:`change_point` names
the round or commit where a level shift began. Confirmed regressions
count into ``mx_perf_regressions_total{metric}`` and show in the
telemetry heartbeat's ``perf=`` section.

**Corpus.** :func:`export_autotune_corpus` joins stored kernel records
(measured times beside the autotune table they ran under) into per-kind
files in the ``MXNET_AUTOTUNE_CACHE`` shape, so ``autotune.py`` loads them
as they are.

**Fleet.** :func:`publish_fleet` / :func:`merge_fleet` move the latest
envelope of each series through the fleet KV (``dist.fleet_kv``).

The emit-time seam (:func:`maybe_record`, called by ``bench_json.emit``)
is one cached boolean (``MXNET_PERFWATCH``; :func:`refresh` after a
change, chained from ``telemetry.refresh()``) and records only when
``MXNET_PERF_DB`` names a store. ``mxnet_tpu_torch/tools/perfwatch.py
micro`` measures the disabled seam on the emit loop.
"""
from __future__ import annotations

import glob as _glob
import hashlib
import json
import logging
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PerfDB", "db_path", "enabled", "refresh", "maybe_record",
           "environment_fingerprint", "metric_direction",
           "judge_series", "change_point", "scan",
           "export_autotune_corpus", "publish_fleet", "merge_fleet",
           "open_db"]

_LOG = logging.getLogger("mxnet_tpu_torch.perfwatch")

_LOCK = threading.RLock()
_STATE = {"on": None}           # cached MXNET_PERFWATCH gate

SCHEMA_VERSION = 1
FLEET_PREFIX = "mx/perf/"

# raw-record scalar fields that are run configuration, not measurements
_CONFIG_FIELDS = frozenset((
    "n", "rc", "batch", "seq", "steps", "ndev", "dcn", "repeats",
    "warmup", "iters", "keys", "ops", "requests", "round",
    "bus_ratio_bound", "threshold", "warmup_programs"))

# dict-valued raw-record fields worth expanding into sub-series
# (two levels: kernels.<name>.<field>) — everything else dict-shaped
# (comm_bandwidth, tenants, buckets, autotune_table) stays in the
# envelope for ad-hoc queries but does not grow its own trajectory
_EXPAND_FIELDS = frozenset(("kernels",))


# ---------------------------------------------------------------------------
# gates / config
# ---------------------------------------------------------------------------
def enabled() -> bool:
    """Cached MXNET_PERFWATCH gate (the bench-emit hot seam; call
    :func:`refresh` after changing the env mid-process)."""
    on = _STATE["on"]
    if on is None:
        try:
            from .config import get as _cfg
            on = bool(_cfg("MXNET_PERFWATCH"))
        except Exception:
            on = False
        _STATE["on"] = on
    return on


def refresh() -> None:
    """Drop the cached gate so the next check re-reads the env
    (chained from ``telemetry.refresh()``)."""
    _STATE["on"] = None


def db_path() -> str:
    """Live MXNET_PERF_DB read (empty = no store configured)."""
    from .config import get as _cfg
    return str(_cfg("MXNET_PERF_DB") or "")


def _tolerance(metric: str) -> float:
    """Relative tolerance for ``metric``: MXNET_PERFWATCH_TOL with
    per-metric overrides from MXNET_PERFWATCH_TOL_OVERRIDES
    ('metric=tol,metric=tol'; the longest matching prefix wins so
    'resnet50=0.1' also covers the record's sub-series)."""
    from .config import get as _cfg
    tol = float(_cfg("MXNET_PERFWATCH_TOL"))
    raw = str(_cfg("MXNET_PERFWATCH_TOL_OVERRIDES") or "")
    best = -1
    for part in raw.split(","):
        name, sep, val = part.strip().partition("=")
        if not sep or not name:
            continue
        if metric.startswith(name) and len(name) > best:
            try:
                tol = float(val)
                best = len(name)
            except ValueError:
                _LOG.warning("perfwatch: bad tolerance override %r "
                             "— ignored", part)
    return tol


# ---------------------------------------------------------------------------
# environment fingerprint
# ---------------------------------------------------------------------------
def _device_kind() -> str:
    """The card's name on the card, ``"cpu"`` without one."""
    from .autotune import _device_kind as kind
    return kind()


def _git_rev() -> Optional[str]:
    """Current commit (short) read straight from .git — no subprocess
    on the emit path; best-effort None outside a checkout."""
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        gitdir = os.path.join(root, ".git")
        with open(os.path.join(gitdir, "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref:"):
            return head[:12] or None
        ref = head.split(None, 1)[1]
        reffile = os.path.join(gitdir, *ref.split("/"))
        if os.path.exists(reffile):
            with open(reffile) as f:
                return f.read().strip()[:12] or None
        packed = os.path.join(gitdir, "packed-refs")
        if os.path.exists(packed):
            with open(packed) as f:
                for line in f:
                    line = line.strip()
                    if line.endswith(" " + ref):
                        return line.split()[0][:12]
    except OSError:
        pass
    return None


def environment_fingerprint() -> Dict[str, Any]:
    """``{"device_kind", "git_rev", "flags"}`` — the like-for-like
    comparison key. Flags are the full MXNET_* snapshot
    (config.environ_snapshot) minus the perfwatch store's own knobs, so
    pointing MXNET_PERF_DB somewhere else does not fork the series."""
    from . import config
    flags = {k: v for k, v in
             config.environ_snapshot(("MXNET_",)).items()
             if not k.startswith(("MXNET_PERF_DB", "MXNET_PERFWATCH"))}
    return {"device_kind": _device_kind(), "git_rev": _git_rev(),
            "flags": flags}


# ---------------------------------------------------------------------------
# metric direction — which way is "worse"
# ---------------------------------------------------------------------------
_HIGHER_UNIT_TOKENS = ("s", "sec", "second")
_LOWER_UNITS = ("ms", "seconds", "bytes", "ratio")
_HIGHER_NAMES = ("throughput", "img_s", "_per_s", "per_sec", "qps",
                 "mfu", "goodput", "vs_baseline", "samples_s",
                 "tokens_per_s", "tflops")
_LOWER_NAMES = ("_ms", "_seconds", "_bytes", "latency", "miss",
                "recompile", "anomal", "error", "ratio", "overhead",
                "divergence", "rel_err", "dropped", "failed")


def metric_direction(name: str, unit: str = "") -> int:
    """+1 = higher is better (throughput), -1 = lower is better
    (latency/ratio/bytes), 0 = unknown (tracked and reported, but a
    direction-less series never gates)."""
    u = (unit or "").lower()
    n = (name or "").lower()
    # rate units: a "/s" or "/sec" component ("images/sec/chip",
    # "req/s") — tokenized, so "disabled/stripped" is not a rate
    if "/" in u and any(t in _HIGHER_UNIT_TOKENS
                        for t in re.split(r"[/_ ]", u)):
        return 1
    if any(m in u for m in _LOWER_UNITS):
        return -1
    if "/" in u:                 # a/b comparison ratios (candidate/twin)
        return -1
    if any(m in n for m in _HIGHER_NAMES):
        return 1
    if any(m in n for m in _LOWER_NAMES):
        return -1
    return 0


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------
def _fingerprint(metric: str, rnd, record: dict) -> str:
    blob = json.dumps({"metric": metric, "round": rnd,
                       "record": record}, sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def _safe_name(metric: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", metric)


class PerfDB:
    """Append-only per-(device_kind, metric) JSONL trajectory store.

    Layout: ``<root>/<device_kind>/<metric>.jsonl``, one envelope per
    line. Writes re-publish the whole (small) file via tmp+rename so
    a concurrent reader never sees a torn line; rows are never
    mutated. Ingest dedupes on the envelope content fingerprint."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._lock = threading.RLock()
        self._cache: Dict[str, List[dict]] = {}

    # -- paths ----------------------------------------------------------
    def _file(self, device_kind: str, metric: str) -> str:
        return os.path.join(self.root, _safe_name(device_kind),
                            _safe_name(metric) + ".jsonl")

    def device_kinds(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def metrics(self, device_kind: str) -> List[str]:
        d = os.path.join(self.root, _safe_name(device_kind))
        if not os.path.isdir(d):
            return []
        return sorted(f[:-6] for f in os.listdir(d)
                      if f.endswith(".jsonl"))

    # -- read -----------------------------------------------------------
    def _load(self, path: str) -> List[dict]:
        with self._lock:
            rows = self._cache.get(path)
            if rows is not None:
                return rows
            rows = []
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        for line in f:
                            line = line.strip()
                            if not line:
                                continue
                            try:
                                rows.append(json.loads(line))
                            except ValueError:
                                _LOG.warning(
                                    "perfwatch: torn row in %s — "
                                    "skipped", path)
                except OSError as e:
                    _LOG.warning("perfwatch: unreadable %s (%s) — "
                                 "treated as empty", path, e)
            self._cache[path] = rows
            return rows

    def records(self, device_kind: str, metric: str) -> List[dict]:
        """Envelopes for one headline metric, trajectory order
        (round when stamped, else ingest order)."""
        rows = list(self._load(self._file(device_kind, metric)))
        rows.sort(key=lambda r: (r.get("round") is None,
                                 r.get("round") or 0,
                                 r.get("ingested_at") or 0.0))
        return rows

    # -- write ----------------------------------------------------------
    def ingest(self, record: dict, *, source: str = "",
               round: Optional[int] = None,
               env: Optional[dict] = None) -> Optional[str]:
        """Store one bench-JSON record; returns its fingerprint, or
        None when an identical record is already stored (idempotent
        re-ingest). The envelope is stamped with ``env`` (the
        record's embedded fingerprint wins over the caller's, which
        wins over the live environment)."""
        if not isinstance(record, dict) or "metric" not in record:
            raise ValueError("perfwatch: not a bench-JSON record: %r"
                             % (record,))
        metric = str(record["metric"])
        stamp = record.get("env") if isinstance(record.get("env"),
                                                dict) else None
        stamp = stamp or env or environment_fingerprint()
        kind = str(stamp.get("device_kind") or "unknown")
        fp = _fingerprint(metric, round, record)
        path = self._file(kind, metric)
        with self._lock:
            rows = self._load(path)
            if any(r.get("fp") == fp for r in rows):
                return None
            envelope = {"v": SCHEMA_VERSION, "fp": fp,
                        "metric": metric,
                        "value": record.get("value"),
                        "unit": record.get("unit"),
                        "round": round, "source": source,
                        "ingested_at": time.time(), "env": stamp,
                        "record": record}
            rows.append(envelope)
            self._publish(path, rows)
        try:
            from . import telemetry
            telemetry.counter("mx_perf_ingested_total").inc()
        except Exception:
            pass
        return fp

    def _publish(self, path: str, rows: List[dict]) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            for r in rows:
                f.write(json.dumps(r, sort_keys=True) + "\n")
        os.replace(tmp, path)     # atomic publish

    # -- file ingest ----------------------------------------------------
    def ingest_file(self, path: str) -> List[str]:
        """Ingest one artifact file: a run wrapper
        (``BENCH_r*.json``: ``{"n", "cmd", "rc", "tail", "parsed"}``),
        a raw bench-JSON object, or line-oriented text/JSONL with
        embedded bench-JSON lines. Returns the NEW fingerprints."""
        with open(path) as f:
            text = f.read()
        source = os.path.basename(path)
        added: List[str] = []
        obj = None
        try:
            obj = json.loads(text)
        except ValueError:
            pass
        if isinstance(obj, dict):
            rnd = obj.get("n") if isinstance(obj.get("n"), int) else \
                _round_from_name(source)
            if isinstance(obj.get("parsed"), dict) and \
                    "metric" in obj["parsed"]:
                fp = self.ingest(obj["parsed"], source=source,
                                 round=rnd)
                return [fp] if fp else []
            if "metric" in obj:
                fp = self.ingest(obj, source=source, round=rnd)
                return [fp] if fp else []
            text = obj.get("tail") or ""     # wrapper without parsed
        rnd = _round_from_name(source)
        for line in text.splitlines():       # stdout capture / JSONL
            line = line.strip()
            if not (line.startswith("{") and line.endswith("}")):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "metric" in rec:
                body = rec.get("record") if "fp" in rec and \
                    isinstance(rec.get("record"), dict) else rec
                fp = self.ingest(body, source=source,
                                 round=rec.get("round", rnd),
                                 env=rec.get("env") if "fp" in rec
                                 else None)
                if fp:
                    added.append(fp)
        return added

    def ingest_glob(self, pattern: str) -> Dict[str, List[str]]:
        out = {}
        for path in sorted(_glob.glob(pattern)):
            try:
                out[path] = self.ingest_file(path)
            except (OSError, ValueError) as e:
                _LOG.warning("perfwatch: cannot ingest %s (%s: %s)",
                             path, type(e).__name__, e)
                out[path] = []
        return out

    # -- series extraction ---------------------------------------------
    def series(self, device_kind: str, metric: str) -> \
            Dict[str, List[Tuple[Any, dict]]]:
        """All numeric trajectories derived from one headline metric's
        records: the headline itself plus scalar raw-record fields
        (``metric.field``) and the whitelisted dict expansions
        (``metric.kernels.<name>.<field>``), each as
        ``[(value, envelope), ...]`` in trajectory order."""
        out: Dict[str, List[Tuple[Any, dict]]] = {}

        def add(name, value, envlp):
            if isinstance(value, bool) or \
                    not isinstance(value, (int, float)):
                return
            out.setdefault(name, []).append((float(value), envlp))

        for envlp in self.records(device_kind, metric):
            rec = envlp.get("record") or {}
            add(metric, rec.get("value"), envlp)
            for k, v in sorted(rec.items()):
                if k in ("metric", "value", "unit", "env") or \
                        k in _CONFIG_FIELDS:
                    continue
                if isinstance(v, dict) and k in _EXPAND_FIELDS:
                    for k2, row in sorted(v.items()):
                        if not isinstance(row, dict):
                            continue
                        for k3, v3 in sorted(row.items()):
                            add(".".join((metric, k, k2, k3)), v3,
                                envlp)
                else:
                    add("%s.%s" % (metric, k), v, envlp)
        return out


def _round_from_name(name: str) -> Optional[int]:
    m = re.search(r"_r(\d+)", name)
    return int(m.group(1)) if m else None


def open_db(path: Optional[str] = None) -> Optional[PerfDB]:
    """The configured store (explicit path wins over MXNET_PERF_DB);
    None when neither names one."""
    p = path or db_path()
    return PerfDB(p) if p else None


# ---------------------------------------------------------------------------
# the emit-time ingestion seam (bench_json.emit calls this)
# ---------------------------------------------------------------------------
def maybe_record(record: dict, *, source: str = "") -> Optional[str]:
    """Store a just-emitted bench record when the perfwatch gate is on
    AND MXNET_PERF_DB names a store; inert (one cached-bool check)
    otherwise. Never raises: the trajectory layer must not take down
    the benchmark it observes."""
    if not enabled():
        return None
    try:
        db = open_db()
        if db is None:
            return None
        return db.ingest(record, source=source)
    except Exception as e:
        _LOG.warning("perfwatch: record failed (%s: %s) — ignored",
                     type(e).__name__, e)
        return None


# ---------------------------------------------------------------------------
# statistics — rolling-median baseline, MAD score, change point
# ---------------------------------------------------------------------------
def _median(xs: List[float]) -> float:
    s = sorted(xs)
    m = len(s) // 2
    return s[m] if len(s) % 2 else (s[m - 1] + s[m]) / 2.0


def _mad(xs: List[float], center: Optional[float] = None) -> float:
    """Scaled median absolute deviation (x1.4826 — consistent with
    sigma under normal noise)."""
    if not xs:
        return 0.0
    c = _median(xs) if center is None else center
    return 1.4826 * _median([abs(x - c) for x in xs])


def judge_series(values: List[float], direction: int, *,
                 metric: str = "", tol: Optional[float] = None,
                 k: Optional[float] = None,
                 window: Optional[int] = None) -> dict:
    """Three-way verdict for the LATEST point of one trajectory.

    Baseline = median of the preceding ``window`` points; score =
    deviation / scaled-MAD of that window. ``regressed`` (or
    ``improved``) requires BOTH score > k AND relative deviation >
    tol — the tolerance floors the alarm when the history is so flat
    that any wiggle is many MADs. Fewer than 3 points, or an unknown
    direction, is always ``flat`` (never enough evidence to gate)."""
    from .config import get as _cfg
    if tol is None:
        tol = _tolerance(metric) if metric else \
            float(_cfg("MXNET_PERFWATCH_TOL"))
    if k is None:
        k = float(_cfg("MXNET_PERFWATCH_MAD_K"))
    if window is None:
        window = int(_cfg("MXNET_PERFWATCH_WINDOW"))
    out = {"n": len(values), "verdict": "flat", "baseline": None,
           "latest": values[-1] if values else None, "score": 0.0,
           "delta_rel": 0.0, "direction": direction,
           "tol": tol, "mad_k": k}
    if len(values) < 3 or direction == 0:
        return out
    prev = values[:-1][-max(2, window):]
    base = _median(prev)
    mad = _mad(prev, base)
    latest = values[-1]
    delta = latest - base
    out["baseline"] = base
    out["delta_rel"] = delta / abs(base) if base else 0.0
    # score in MADs, floored by the tolerance band so a zero-MAD flat
    # history cannot produce infinite scores on sub-tolerance noise
    noise = max(mad, tol * abs(base) / max(k, 1e-9))
    out["score"] = abs(delta) / noise if noise else 0.0
    significant = out["score"] > k and \
        abs(out["delta_rel"]) > tol
    if significant:
        bad = (delta < 0) if direction > 0 else (delta > 0)
        out["verdict"] = "regressed" if bad else "improved"
    return out


def change_point(values: List[float], direction: int = 0, *,
                 tol: Optional[float] = None,
                 k: Optional[float] = None) -> Optional[dict]:
    """Locate the single most likely level shift in a trajectory: the
    split maximizing |median(after) - median(before)|, reported only
    when that gap clears the same MAD/tolerance bar as a verdict.
    Returns ``{"index", "before", "after", "delta_rel", "kind"}`` —
    ``index`` is the first point of the new level — or None."""
    from .config import get as _cfg
    if len(values) < 4:
        return None
    if tol is None:
        tol = float(_cfg("MXNET_PERFWATCH_TOL"))
    if k is None:
        k = float(_cfg("MXNET_PERFWATCH_MAD_K"))
    best = None
    for s in range(1, len(values)):
        med_l = _median(values[:s])
        med_r = _median(values[s:])
        gap = med_r - med_l
        # residuals around the fitted two-level model: the tiebreak
        # between equal-gap splits AND the noise estimate below (the
        # whole-series MAD would count the shift itself as noise)
        resid = [v - med_l for v in values[:s]] + \
            [v - med_r for v in values[s:]]
        cost = sum(abs(r) for r in resid)
        if best is None or abs(gap) > abs(best[1]) + 1e-12 or \
                (abs(gap) > abs(best[1]) - 1e-12 and cost < best[4]):
            best = (s, gap, med_l, med_r, cost, resid)
    s, gap, med_l, med_r, _cost, resid = best
    mad = _mad(resid, 0.0)
    if abs(gap) <= max(k * mad, tol * abs(med_l)):
        return None
    if direction == 0:
        kind = "shift"
    else:
        kind = "improvement" if gap * direction > 0 else "regression"
    return {"index": s, "before": med_l, "after": med_r,
            "delta_rel": gap / abs(med_l) if med_l else 0.0,
            "kind": kind}


# ---------------------------------------------------------------------------
# the scan — every series, verdicted
# ---------------------------------------------------------------------------
def _round_label(envlp: dict) -> str:
    rnd = envlp.get("round")
    if rnd is not None:
        return "r%02d" % rnd
    rev = (envlp.get("env") or {}).get("git_rev")
    return rev or (envlp.get("source") or "?")


def scan(db: PerfDB, device_kind: Optional[str] = None,
         metric: Optional[str] = None) -> List[dict]:
    """Verdict every trajectory in the store (optionally filtered):
    one row per series with the latest-point verdict, the MAD score,
    and the localized change point (labelled with the round/commit
    where the level shift began). Confirmed regressions increment
    ``mx_perf_regressions_total{metric}``."""
    rows = []
    kinds = [device_kind] if device_kind else db.device_kinds()
    for kind in kinds:
        for m in db.metrics(kind):
            if metric and m != metric:
                continue
            for name, points in sorted(db.series(kind, m).items()):
                values = [v for v, _ in points]
                last_env = points[-1][1]
                unit = last_env.get("unit") if name == m else ""
                direction = metric_direction(name, unit or "")
                verdict = judge_series(values, direction, metric=name)
                cp = change_point(values, direction,
                                  tol=verdict["tol"],
                                  k=verdict["mad_k"])
                if cp is not None:
                    cp = dict(cp, at=_round_label(
                        points[cp["index"]][1]))
                rows.append({"device_kind": kind, "metric": name,
                             "unit": unit or "",
                             "rounds": [_round_label(e)
                                        for _, e in points],
                             "values": values,
                             "change_point": cp, **verdict})
    regressed = [r for r in rows if r["verdict"] == "regressed"]
    if regressed:
        try:
            from . import telemetry
            for r in regressed:
                telemetry.counter("mx_perf_regressions_total",
                                  metric=r["metric"]).inc()
        except Exception:
            pass
    return rows


# ---------------------------------------------------------------------------
# autotune training corpus
# ---------------------------------------------------------------------------
def _parse_entry_key(ek: str) -> Tuple[str, str, Dict[str, Any]]:
    """``device|kernel|k=v,...`` -> (device_kind, kernel, features)."""
    parts = ek.split("|")
    if len(parts) != 3:
        return "", ek, {}
    feats: Dict[str, Any] = {}
    for item in parts[2].split(","):
        name, sep, val = item.partition("=")
        if not sep:
            continue
        try:
            feats[name] = int(val)
        except ValueError:
            try:
                feats[name] = float(val)
            except ValueError:
                feats[name] = val
    return parts[0], parts[1], feats


def export_autotune_corpus(db: PerfDB,
                           out_dir: Optional[str] = None) -> \
        Dict[str, Tuple[str, int]]:
    """Join every stored record that carries an ``autotune_table`` (the
    tuned entries it ran under, beside its ``kernels`` rows of measured
    times) into per-device_kind (features, measured-time) corpus files.

    Each output file is in the exact ``MXNET_AUTOTUNE_CACHE`` shape —
    ``{entry_key: {"params": ..., "mode": ..., "score": ...}}`` —
    with the training extras (``features`` parsed from the entry-key
    shape signature, ``measured_ms`` joined from the matching
    kernel-vs-twin row, ``round``/``source_fp`` provenance) riding as
    extra keys that autotune's loader and validators ignore, so a
    corpus file doubles as a seedable tuning cache. Returns
    ``{device_kind: (path, n_entries)}``."""
    out_dir = out_dir or os.path.join(db.root, "autotune_corpus")
    exported: Dict[str, Tuple[str, int]] = {}
    for kind in db.device_kinds():
        corpus: Dict[str, dict] = {}
        for m in db.metrics(kind):
            for envlp in db.records(kind, m):
                rec = envlp.get("record") or {}
                table = rec.get("autotune_table")
                if not isinstance(table, dict) or not table:
                    continue
                kernels = rec.get("kernels") or {}
                for ek, params in sorted(table.items()):
                    if not isinstance(params, dict):
                        continue
                    ek_kind, kernel, feats = _parse_entry_key(ek)
                    measured = None
                    for row_name, row in kernels.items():
                        if isinstance(row, dict) and \
                                row_name in kernel:
                            measured = row.get("candidate_ms")
                            break
                    corpus[ek] = {
                        "params": dict(params),
                        "mode": str(rec.get("autotune") or "measure"),
                        "score": 0.0,
                        "kernel": kernel,
                        "device_kind": ek_kind or kind,
                        "features": feats,
                        "measured_ms": measured,
                        "round": envlp.get("round"),
                        "source_fp": envlp.get("fp"),
                    }
        if not corpus:
            continue
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, _safe_name(kind) + ".json")
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(corpus, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        exported[kind] = (path, len(corpus))
    return exported


# ---------------------------------------------------------------------------
# fleet sharing over the dist coordination KV
# ---------------------------------------------------------------------------
def publish_fleet(db: PerfDB, kv=None) -> int:
    """Publish the latest envelope of every (device_kind, metric)
    trajectory to the fleet KV under ``mx/perf/<kind>/<metric>`` —
    the same coordination-service store fleet snapshots and serving
    leases ride (dist.fleet_kv). Returns the key count."""
    from . import dist
    kv = kv if kv is not None else dist.fleet_kv()
    n = 0
    for kind in db.device_kinds():
        for m in db.metrics(kind):
            rows = db.records(kind, m)
            if not rows:
                continue
            kv.set("%s%s/%s" % (FLEET_PREFIX, _safe_name(kind),
                                _safe_name(m)),
                   json.dumps(rows[-1], sort_keys=True))
            n += 1
    return n


def merge_fleet(db: PerfDB, kv=None) -> int:
    """Ingest every fleet-published envelope into the local store
    (idempotent — fingerprints dedupe). Returns newly added rows."""
    from . import dist
    kv = kv if kv is not None else dist.fleet_kv()
    added = 0
    for _key, raw in sorted(kv.dir_get(FLEET_PREFIX).items()):
        try:
            envlp = json.loads(raw)
        except ValueError:
            continue
        rec = envlp.get("record")
        if not isinstance(rec, dict) or "metric" not in rec:
            continue
        if db.ingest(rec, source=envlp.get("source") or "fleet",
                     round=envlp.get("round"),
                     env=envlp.get("env")):
            added += 1
    return added
