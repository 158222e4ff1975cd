"""Serving (counterpart of ``mxnet_tpu/serve/``), one pipeline::

    Frontend (HTTP) -> Router -> replica processes (ReplicaServer) ->
    Scheduler: per-tenant queues, weighted-fair continuous batching on
    the dependency engine -> InferenceSession: padded shape buckets, a
    captured CUDA graph a bucket -> per-tenant SLO telemetry (tenancy)

In one process::

    sess = net.serve_session(ids, types, seq_axis=1, max_batch=8,
                             max_seq=128).warmup()
    sched = serve.Scheduler(sess, tenants=[
        serve.TenantConfig("free", weight=1, deadline_ms=200),
        serve.TenantConfig("paid", weight=4)])
    out = sched.submit(ids_np, types_np, tenant="paid").result()
    sched.close()                       # graceful drain

Across processes: ``ReplicaManager(n, factory="module:callable",
spec={...}).start()`` spawns replicas (on the card unless the spec says
``"ctx": "cpu"``), ``Router(manager.kv, tenants=...)`` routes to them,
and ``Frontend(router).serve_in_thread()`` serves HTTP.
"""
from .bucketing import BucketLadder, parse_bucket_spec, pow2_ladder
from .session import InferenceSession
from .scheduler import Scheduler, ServeFuture
from .tenancy import (OverloadError, TenantConfig, record_request,
                      slo_report, render_slo_report)
from .fleet import (FleetFuture, ReplicaManager, ReplicaServer, Router,
                    replica_main)
from .frontend import Frontend

__all__ = ["BucketLadder", "parse_bucket_spec", "pow2_ladder",
           "InferenceSession", "Scheduler", "ServeFuture",
           "OverloadError", "TenantConfig", "record_request",
           "slo_report", "render_slo_report",
           "FleetFuture", "ReplicaManager", "ReplicaServer", "Router",
           "replica_main", "Frontend"]
