"""Per-tenant serving telemetry and SLO configuration (counterpart of
``mxnet_tpu/serve/tenancy.py``).

Every tenant's experience is visible on its own: one noisy tenant's
queue does not hide inside an aggregate p99. The series ride the
telemetry registry (:mod:`mxnet_tpu_torch.telemetry`), so they ship
through ``snapshot()``, ``render_prometheus()`` and the heartbeat:

- ``mx_serve_requests_total{tenant,code}``: outcomes (``ok``,
  ``overload``, ``timeout``, ``drain``, ``error``);
- ``mx_serve_latency_seconds{tenant}``: end-to-end request latency;
- ``mx_serve_queue_seconds{tenant}``: the wait for batch admission;
- ``mx_serve_queue_depth{tenant}``: live queued requests;
- ``mx_serve_tokens_total{tenant}`` and ``mx_serve_tokens_per_s``:
  goodput in tokens (the caller's count, else padded elements);
- ``mx_serve_slo_violations_total{tenant}``: completions past the
  tenant's deadline.

:class:`TenantConfig` is a tenant's admission and SLO contract:
``weight`` drives the scheduler's weighted-fair assembly,
``deadline_ms`` bounds the queue time (past it a request is shed with a
typed :class:`OverloadError`), and ``queue_cap`` bounds the backlog
(a submit beyond it fails at once).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional

from ..base import MXNetError
from .. import telemetry

__all__ = ["TenantConfig", "OverloadError", "record_request",
           "set_queue_depth", "slo_report", "render_slo_report",
           "to_wire_error", "from_wire_error", "http_status"]

CODES = ("ok", "overload", "timeout", "drain", "error")

# HTTP mapping of the typed wire contract (serve/frontend.py): shed
# codes carry retryability semantics — 429 'come back later', 503
# 'this replica is leaving', 504 'your deadline passed'. Anything
# untyped is a plain 500.
HTTP_STATUS = {"overload": 429, "timeout": 504, "drain": 503,
               "error": 500}
RETRYABLE_CODES = ("overload", "drain")   # shed BEFORE execution


class OverloadError(MXNetError):
    """Typed admission failure: the request was shed, not served.
    ``code`` says why — 'overload' (queue cap), 'timeout' (deadline
    passed while queued), 'drain' (engine shut down before the request
    ran). Clients retry elsewhere/later; they never hang."""

    def __init__(self, message: str, code: str = "overload",
                 tenant: str = ""):
        super().__init__(message)
        self.code = code
        self.tenant = tenant


def to_wire_error(exc: Exception) -> dict:
    """Serialize an exception as the typed wire error the fleet speaks:
    ``{"code", "message", "tenant"}`` — code is the OverloadError code
    for sheds, 'error' for everything else. Clients never parse
    exception reprs."""
    if isinstance(exc, OverloadError):
        return {"code": exc.code if exc.code in CODES else "error",
                "message": str(exc), "tenant": exc.tenant}
    return {"code": "error",
            "message": "%s: %s" % (type(exc).__name__, exc),
            "tenant": ""}


def from_wire_error(err: dict) -> MXNetError:
    """Rehydrate a typed wire error — sheds come back as OverloadError
    with the original code so retry ladders and HTTP mapping work on
    the far side of the wire too."""
    code = err.get("code", "error")
    message = err.get("message", "remote error")
    if code in CODES and code not in ("ok", "error"):
        return OverloadError(message, code=code,
                             tenant=err.get("tenant", ""))
    return MXNetError(message)


def http_status(code: str) -> int:
    return HTTP_STATUS.get(code, 500)


class TenantConfig:
    """Admission + SLO contract for one tenant."""

    __slots__ = ("name", "weight", "deadline_ms", "queue_cap")

    def __init__(self, name: str, weight: float = 1.0,
                 deadline_ms: float = 0.0, queue_cap: int = 256):
        if weight <= 0:
            raise MXNetError("TenantConfig %r: weight must be > 0"
                             % name)
        self.name = name
        self.weight = float(weight)
        self.deadline_ms = float(deadline_ms)   # 0 = no deadline
        self.queue_cap = int(queue_cap)

    def __repr__(self):
        return ("TenantConfig(%r, weight=%g, deadline_ms=%g, "
                "queue_cap=%d)" % (self.name, self.weight,
                                   self.deadline_ms, self.queue_cap))


# ---------------------------------------------------------------------------
# token-rate tracking (per tenant, process-wide): tokens_total is the
# counter of record; the per-second gauge is derived from a short
# sliding window so the heartbeat shows the CURRENT rate, not the
# lifetime average
# ---------------------------------------------------------------------------
_RATE_LOCK = threading.Lock()
_RATE: Dict[str, list] = {}          # tenant -> [t0, tokens_in_window]
_RATE_WINDOW_S = 10.0


def _note_tokens(tenant: str, tokens: float):
    now = time.perf_counter()
    with _RATE_LOCK:
        rec = _RATE.get(tenant)
        if rec is None or now - rec[0] > _RATE_WINDOW_S:
            rec = _RATE[tenant] = [now, 0.0]
        rec[1] += tokens
        dt = now - rec[0]
        rate = rec[1] / dt if dt > 1e-3 else 0.0
    telemetry.gauge("mx_serve_tokens_per_s", tenant=tenant).set(rate)


def record_request(tenant: str, code: str, latency_s: float = 0.0,
                   queue_s: float = 0.0, tokens: float = 0.0,
                   deadline_ms: float = 0.0):
    """Account one finished (or shed) request. Never raises; no-op
    with telemetry off — serving itself does not depend on the
    registry."""
    try:
        if not telemetry.enabled():
            return
        telemetry.counter("mx_serve_requests_total", tenant=tenant,
                          code=code).inc()
        if code == "ok":
            telemetry.histogram("mx_serve_latency_seconds",
                                tenant=tenant).observe(latency_s)
            telemetry.histogram("mx_serve_queue_seconds",
                                tenant=tenant).observe(queue_s)
            if tokens:
                telemetry.counter("mx_serve_tokens_total",
                                  tenant=tenant).inc(tokens)
                _note_tokens(tenant, tokens)
            if deadline_ms > 0 and latency_s * 1e3 > deadline_ms:
                telemetry.counter("mx_serve_slo_violations_total",
                                  tenant=tenant).inc()
    except Exception:
        pass


def set_queue_depth(tenant: str, depth: int):
    try:
        if telemetry.enabled():
            telemetry.gauge("mx_serve_queue_depth",
                            tenant=tenant).set(depth)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# SLO report: the per-tenant table
# ---------------------------------------------------------------------------
def slo_report(tenants: Optional[Iterable[TenantConfig]] = None) -> list:
    """Per-tenant rows from the live registry: requests by code,
    p50/p99 latency, queue p99, tokens/s, SLO violations. `tenants`
    supplies deadlines for the report (else deadline 0). Sorted
    slowest-first by p99 so row 0 NAMES the slowest tenant."""
    cfg = {t.name: t for t in (tenants or [])}
    snap = telemetry.snapshot()
    rows: Dict[str, dict] = {}

    def row(tenant: str) -> dict:
        r = rows.get(tenant)
        if r is None:
            t = cfg.get(tenant)
            r = rows[tenant] = {
                "tenant": tenant, "requests": 0,
                "by_code": {c: 0 for c in CODES},
                "p50_ms": 0.0, "p99_ms": 0.0, "queue_p99_ms": 0.0,
                "tokens_per_s": 0.0, "slo_violations": 0,
                "deadline_ms": t.deadline_ms if t else 0.0}
        return r

    labels_of = telemetry.parse_metric_key

    for key, val in snap["counters"].items():
        name, labels = labels_of(key)
        tn = labels.get("tenant")
        if tn is None:
            continue
        if name == "mx_serve_requests_total":
            r = row(tn)
            r["requests"] += int(val)
            r["by_code"][labels.get("code", "error")] = \
                r["by_code"].get(labels.get("code", "error"), 0) + int(val)
        elif name == "mx_serve_slo_violations_total":
            row(tn)["slo_violations"] = int(val)
    for key, summ in snap["histograms"].items():
        name, labels = labels_of(key)
        tn = labels.get("tenant")
        if tn is None:
            continue
        if name == "mx_serve_latency_seconds":
            r = row(tn)
            r["p50_ms"] = summ["p50"] * 1e3
            r["p99_ms"] = summ["p99"] * 1e3
        elif name == "mx_serve_queue_seconds":
            row(tn)["queue_p99_ms"] = summ["p99"] * 1e3
    for key, val in snap["gauges"].items():
        name, labels = labels_of(key)
        if name == "mx_serve_tokens_per_s" and labels.get("tenant"):
            row(labels["tenant"])["tokens_per_s"] = val
    return sorted(rows.values(), key=lambda r: -r["p99_ms"])


def render_slo_report(rows: Optional[list] = None,
                      tenants: Optional[Iterable[TenantConfig]] = None
                      ) -> str:
    rows = slo_report(tenants) if rows is None else rows
    out = ["%-12s %8s %6s %6s %8s %8s %10s %9s %8s"
           % ("tenant", "requests", "ok", "shed", "p50_ms", "p99_ms",
              "queue_p99", "tokens/s", "slo_viol")]
    for r in rows:
        shed = sum(r["by_code"].get(c, 0)
                   for c in ("overload", "timeout", "drain"))
        out.append("%-12s %8d %6d %6d %8.2f %8.2f %10.2f %9.1f %8d"
                   % (r["tenant"], r["requests"], r["by_code"]["ok"],
                      shed, r["p50_ms"], r["p99_ms"], r["queue_p99_ms"],
                      r["tokens_per_s"], r["slo_violations"]))
    return "\n".join(out)
