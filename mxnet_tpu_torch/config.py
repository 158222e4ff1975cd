"""Declared runtime configuration of the port (counterpart of
``mxnet_tpu/config.py``).

Only the variables the ported modules read are declared here. They keep
the reference's names and meanings, so one environment drives both
packages. Reads are live: every :func:`get` consults the environment.

The reference's kernel switches (``MXNET_PALLAS_LAYERNORM``,
``MXNET_FLASH_ATTENTION``, ``MXNET_PALLAS_EPILOGUE``) have no counterpart:
the port decides kernel or plain version by the tensor's device and the
kernel's domain alone. The compute-path switches of the convolution
family keep theirs: ``MXNET_LAYOUT_OPT`` runs a hybridized block's 2-D
convolutions of tensor-core data (16-bit, or f32 under TF32)
channels-last (:mod:`mxnet_tpu_torch.symbol.layout_opt`),
and ``MXNET_CONV_S2D`` computes the 7x7/s2/p3 stem over at most four
channels as a 4x4 stride-1 convolution of its 2x2 space-to-depth input
(``ops/nn.py`` ``_stem_s2d_conv``), the same sums in another order, in
either layout.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["Var", "VARS", "define", "get", "getenv_raw", "setenv",
           "describe"]

_FALSY = ("0", "false", "off", "no", "")


@dataclass(frozen=True)
class Var:
    name: str
    type: type
    default: Any
    doc: str

    def parse(self, raw: Optional[str]):
        if raw is None:
            return self.default
        if self.type is bool:
            return raw.lower() not in _FALSY
        if self.type is int:
            return int(raw)
        if self.type is float:
            return float(raw)
        return raw


VARS: Dict[str, Var] = {}


def define(name: str, type: type, default: Any, doc: str) -> Var:
    v = Var(name, type, default, doc)
    VARS[name] = v
    return v


def get(name: str):
    """Typed live read of a declared variable."""
    var = VARS.get(name)
    if var is None:
        raise KeyError("undeclared config variable %r — declare it in "
                       "mxnet_tpu_torch/config.py" % name)
    return var.parse(os.environ.get(name))


def getenv_raw(name: str, default=None):
    """A raw read of an undeclared variable (``mx.util.getenv``)."""
    return os.environ.get(name, default)


def setenv(name: str, value: str):
    """``mx.util.setenv``."""
    os.environ[name] = value


def environ_snapshot(prefixes: tuple) -> Dict[str, str]:
    """Sorted {name: value} of every environment variable starting with
    one of ``prefixes``."""
    return {k: os.environ[k] for k in sorted(os.environ)
            if k.startswith(prefixes)}


def apply_overrides(env: Optional[Dict[str, str]]) -> None:
    """Write ``env`` into the environment: a spawned serving replica
    applies its spec's overrides (fault sites, tracing) before anything
    reads them."""
    for k, v in (env or {}).items():
        os.environ[str(k)] = str(v)


def describe() -> str:
    """A markdown table of every declared variable."""
    rows = ["| variable | type | default | description |",
            "|---|---|---|---|"]
    for v in sorted(VARS.values(), key=lambda v: v.name):
        rows.append("| `%s` | %s | `%r` | %s |"
                    % (v.name, v.type.__name__, v.default, v.doc))
    return "\n".join(rows)


define("MXNET_ENGINE_TYPE", str, "",
       "'NaiveEngine' runs every op synchronously: a native-engine push "
       "executes at the push, and every registry op and new array on the "
       "card synchronises its stream, so a fault surfaces at the op that "
       "caused it (engine.py). Default: the native threaded dependency "
       "engine (csrc/engine.cc).")
define("MXNET_CPU_WORKER_NTHREADS", int, 2,
       "Worker threads of the native dependency engine.")
define("MXNET_CUSTOM_OP_NUM_THREADS", int, 0,
       "Workers executing Python custom ops on the native engine; 0 "
       "inherits MXNET_CPU_WORKER_NTHREADS.")
define("MXNET_ENGINE_WATCHDOG", float, 0.0,
       "Native dependency-engine wait watchdog in seconds: a "
       "wait_for_var/wait_for_all past the deadline raises MXNetError "
       "listing every pending op's label and enqueue site instead of "
       "hanging (0 disables).")
define("MXNET_LAYOUT_OPT", bool, True,
       "NHWC layout pass on hybridized conv graphs (symbol/layout_opt.py): "
       "a CachedOp's 2-D ungrouped convolutions of 16-bit data (or f32 "
       "while cuDNN may use TF32) run channels-last, its "
       "outputs leave contiguous NCHW, and a conv bias whose only consumer "
       "is a BatchNorm gets a gradient of exactly zero. Read when a call "
       "selects its graph, and part of the signature.")
define("MXNET_SHARDED_AUTO_LAYOUT", bool, True,
       "Accepted, and changes nothing on the card: the reference lets XLA "
       "pick ShardedTrainStep's parameter layouts when every mesh device is "
       "a TPU. The port's counterpart is the layout pass's hoisted weights "
       "(parallel/sharded.py): a conv weight used only channels-last is "
       "stored channels-last.")
define("MXNET_CONV_S2D", bool, True,
       "Rewrite 7x7/s2/p3 convolutions over at most 4 channels (the "
       "ResNet stem) as 4x4 stride-1 convolutions of the 2x2 "
       "space-to-depth input (ops/nn.py _stem_s2d_conv). Part of a "
       "CachedOp's signature.")
define("MXNET_SERVE_BUCKETS", str, "",
       "Shape-bucket ladder for InferenceSession (serve/bucketing.py): "
       "'b1,b2,...' batch buckets, optionally ';s1,s2,...' sequence "
       "buckets. Empty = a power-of-two ladder up to max_batch/max_seq.")
define("MXNET_SERVE_MAX_WAIT_MS", float, 5.0,
       "Continuous-batching assembly deadline in milliseconds "
       "(serve/scheduler.py): once the first request of a batch waits, "
       "the scheduler admits more for at most this long before it "
       "dispatches the batch. 0 dispatches at once.")
define("MXNET_SERVE_INFLIGHT", int, 2,
       "Serve batches in flight on the dependency engine at once "
       "(serve/scheduler.py); assembly blocks past this, so backpressure "
       "lands in the tenant queues. At 1 batches run on the batcher's "
       "thread, bypassing the engine.")
define("MXNET_SERVE_DRAIN_S", float, 5.0,
       "Graceful-drain deadline in seconds for Scheduler.close(): queued "
       "requests are served for this long, the rest fail with "
       "OverloadError(code='drain').")
define("MXNET_SERVE_FLEET_KV", str, "",
       "Fleet coordination KV address 'host:port' (serve/fleet.py): "
       "replicas publish liveness leases there and routers watch them; a "
       "dist.KVServer, started by ReplicaManager. Empty: an in-process "
       "store (single-process use).")
define("MXNET_SERVE_FLEET_HEARTBEAT_S", float, 0.5,
       "Replica lease period in seconds: each replica re-publishes its "
       "lease and health snapshot at this period, and routers poll the "
       "lease directory at the same period.")
define("MXNET_SERVE_FLEET_MISS_K", int, 3,
       "A replica whose lease is older than MISS_K * HEARTBEAT_S is dead: "
       "no new work lands on it and its in-flight requests are "
       "resubmitted.")
define("MXNET_SERVE_FLEET_RETRIES", int, 2,
       "Retries of a routed request on a different replica: transport "
       "failures and dead replicas retry only idempotent requests, typed "
       "overload/drain sheds always; never past the deadline.")
define("MXNET_SERVE_FLEET_BREAKER_FAILS", int, 3,
       "Consecutive failures before a replica's circuit breaker opens.")
define("MXNET_SERVE_FLEET_BREAKER_MS", float, 200.0,
       "Base open time of the circuit breaker in milliseconds; doubles "
       "on each re-open (capped at 64x) before a half-open probe.")
define("MXNET_SERVE_FLEET_CONC", int, 16,
       "Router.submit's driving threads (Router.infer drives on the "
       "caller's thread).")
define("MXNET_SERVE_FLEET_TIMEOUT_S", float, 30.0,
       "Deadline in seconds of a routed request whose tenant declares no "
       "deadline_ms; retries and hedges all charge against it.")
define("MXNET_SERVE_HEDGE_MS", float, 0.0,
       "Hedged-request delay in milliseconds (Router): an idempotent "
       "request still running after this long is duplicated on another "
       "replica, the first completion wins and the other is counted in "
       "mx_fleet_hedges_total. 0: off; negative: the fleet's observed "
       "p99.")
define("MXNET_TRACE", bool, False,
       "Distributed request tracing (tracing.py): a TraceContext minted "
       "at the serving edge rides the wire into each replica, so router "
       "attempts, scheduler queue/batch spans and engine execute spans "
       "assemble into one trace per sampled request. Read once and "
       "cached: call tracing.refresh() (or telemetry.refresh()) after a "
       "change. Off, wire frames carry no trace bytes.")
define("MXNET_TRACE_SAMPLE", float, 0.01,
       "Head-sampling rate in [0, 1]: decided once where a trace is "
       "minted and carried in the context; replicas never re-decide.")
define("MXNET_TRACE_RING", int, 2048,
       "Per-process bound on buffered spans; overflow evicts the oldest "
       "and counts it (the heartbeat's trace= dropped).")
define("MXNET_TRACE_EXEMPLARS", int, 4,
       "The N slowest assembled traces each TraceStore keeps whole, for "
       "telemetry.crash_bundle()'s traces.json; 0 keeps none.")
define("MXNET_OPTIMIZER_AGGREGATION_SIZE", int, 4096,
       "Multi-tensor update width (the optimizer's aggregate_num): "
       "update_multi takes its parameters in chunks of this many, one "
       "multi-tensor op a chunk (0 or less: one chunk). At 1 the Trainer "
       "updates each parameter alone and arms no fused SGD step.")
define("MXNET_FUSED_BACKWARD", bool, True,
       "On, a backward() whose tape holds only hybridized blocks' nodes "
       "runs as one captured graph over all of them (cached_op.py), and "
       "an armed Trainer may defer it to step(). Off, each CachedOp call "
       "is one graph for its forward and one for its backward, with no "
       "deferral across CachedOps.")
define("MXNET_TRAINER_FUSED_UPDATE", bool, True,
       "A Trainer whose optimizer is plain SGD, after its first step, "
       "defers each eligible backward() and runs it with the SGD update "
       "appended as one captured graph (gluon/trainer.py); the results "
       "equal the separate update bit for bit. Needs "
       "MXNET_FUSED_BACKWARD.")
define("MXNET_SCAN_STEPS", int, 1,
       "K-step whole-loop compilation (scan.py): above 1 an armed "
       "Trainer (MXNET_TRAINER_FUSED_UPDATE) buffers K consecutive "
       "steps of hybridized calls, their forwards deferred, and retires "
       "them as one function: on the card one captured graph of K "
       "forwards, backwards and SGD updates. Bit for bit with K = 1.")
define("MXNET_ZERO", bool, False,
       "ZeRO weight-update sharding for the data-parallel Trainer "
       "(gluon/zero.py): the gradients are reduce-scattered over the "
       "replica contexts, each replica keeps a 1/N fragment of every "
       "parameter's optimizer state (allocated sharded, never whole) and "
       "updates only that fragment, and the new weights are all-gathered "
       "back. Engages when the Trainer is eligible (2 or more distinct "
       "replica contexts, an in-process kvstore, dense grad_req='write' "
       "parameters, SGD with or without momentum, or Adam); otherwise the "
       "replicated path runs, after one warning naming the reason.")
define("MXNET_ZERO_DCN", int, 0,
       "With MXNET_ZERO: treat the replicas as a dcn x ici hierarchy of "
       "this many slices (must divide the replica count; 0 or 1 is "
       "flat). The reduce-scatter runs RS(ici) then RS(dcn), the "
       "all-gather AG(dcn) then AG(ici), and fragment ownership follows "
       "the permutation (p % n_ici) * n_dcn + p // n_ici.")
define("MXNET_ZERO_MIN_SIZE", int, 0,
       "With MXNET_ZERO: stay replicated when the trained parameters hold "
       "fewer elements than this; 0 shards whenever eligible.")
define("MXNET_DIST_INIT_TIMEOUT", float, 300.0,
       "Overall deadline in seconds of the dist.initialize() rendezvous: "
       "failed attempts retry with exponential backoff until it elapses, "
       "then MXNetError.")
define("MXNET_DIST_INIT_BACKOFF", float, 1.0,
       "First rendezvous retry backoff in seconds; doubles an attempt, "
       "capped at 30 s.")
define("MXNET_DIST_INIT_RETRIES", int, 0,
       "Most rendezvous attempts of dist.initialize() (0: unlimited until "
       "MXNET_DIST_INIT_TIMEOUT).")
define("MXNET_BARRIER_TIMEOUT", float, 600.0,
       "dist.barrier() watchdog in seconds: MXNetError naming this rank "
       "instead of waiting forever on a dead one (0 disables).")
define("MXNET_KVSTORE_TIMEOUT", float, 0.0,
       "Per-call deadline in seconds of the dist kvstore's push, pull and "
       "pushpull collectives: a timed-out call is retried "
       "(MXNET_KVSTORE_RETRIES), then raises MXNetError naming the call "
       "and the rank (0 disables).")
define("MXNET_KVSTORE_RETRIES", int, 1,
       "Retries of a timed-out dist kvstore call before MXNetError.")
define("MXNET_KVSTORE_QUANTIZE", str, "off",
       "Quantized gradient wire (parallel/quantize.py): 'int8' or 'fp8' "
       "sends each replica's gradient blockwise quantized (one f32 absmax "
       "scale per MXNET_KVSTORE_QUANTIZE_BLOCK elements), sums the "
       "received blocks in f32 on each shard's owner and all-gathers the "
       "re-quantized sum; every quantize site's rounding error is carried "
       "into the next step (error feedback). Wired through the kvstore's "
       "grouped reduce and ZeRO's reduce-scatter and all-gather; 'off' "
       "keeps every path the plain f32 one.")
define("MXNET_KVSTORE_QUANTIZE_TIER", str, "dcn",
       "Which hops of a staged dcn x ici quantized sync carry the 1-byte "
       "payload: 'dcn' only the cross-slice hop, 'all' every hop. A flat "
       "sync is quantized under either.")
define("MXNET_KVSTORE_QUANTIZE_BLOCK", int, 256,
       "Elements per absmax scale block of MXNET_KVSTORE_QUANTIZE; a "
       "non-finite gradient poisons only its own block.")
define("MXNET_KVSTORE_QUANTIZE_STOCHASTIC", bool, False,
       "Stochastic rounding for the int8 quantizer (the dither drawn from "
       "a generator on each replica's device, seeded a step); fp8 rounds "
       "to nearest even.")
define("MXNET_KVSTORE_BIGARRAY_BOUND", int, 1 << 19,
       "Arrays larger than this many elements are cut into row slices "
       "pushed tail first by the P3 store (kvstore/dist.py "
       "P3StoreDist).")
define("MXNET_COMMWATCH", bool, True,
       "Collective-communication accounting (commwatch.py; needs "
       "MXNET_TELEMETRY=1): every kvstore reduce records its op, axis, "
       "participants and payload bytes into the mx_comm_* counters and "
       "histograms, with algorithm and bus bandwidth and the exposed "
       "seconds. Off, nothing is recorded.")
define("DMLC_ROLE", str, "worker",
       "Process role in a launched job; only 'worker' exists here.")
define("DMLC_PS_ROOT_URI", str, "127.0.0.1",
       "Rendezvous host: rank 0 serves the process group's store there.")
define("DMLC_PS_ROOT_PORT", int, 9091, "Rendezvous port.")
define("DMLC_NUM_WORKER", int, 1, "World size.")
define("DMLC_NUM_SERVER", int, 0,
       "Server count, accepted for launcher parity; must be 0 (there are "
       "no parameter-server processes).")
define("DMLC_WORKER_ID", int, 0, "This worker's rank.")
define("MXNET_FAULT_INJECT", str, "",
       "Fault-injection spec 'site:prob[:max_fires],...' (e.g. "
       "'nan_grad:1:1'); the sites are listed in faultinject.py.")
define("MXNET_FAULT_INJECT_SEED", int, 0,
       "Seed of the fault-injection probability draws (deterministic "
       "chaos runs).")
define("MXNET_GUARD_NONFINITE", str, "off",
       "Non-finite gradient policy of guardrails.GradGuard at "
       "Trainer.step: 'off' (no check), 'raise' (MXNetError naming the "
       "offending parameters), 'skip_step' (drop the update, count it), "
       "'zero' (zero the bad gradients and proceed).")
define("MXNET_GUARD_CLIP_NORM", float, 0.0,
       "Global-gradient-norm clip threshold of GradGuard, on the norm "
       "after rescale_grad (the same single reduction as the finiteness "
       "check); 0 disables clipping.")
define("MXNET_GUARD_LOSS_SPIKE", float, 0.0,
       "Loss-spike factor: GradGuard.observe_loss emits a 'loss_spike' "
       "event when a loss exceeds factor x the rolling mean (0 "
       "disables).")
define("MXNET_GUARD_LOSS_WINDOW", int, 50,
       "Rolling window (observations) of the loss-spike detector.")
define("MXNET_GUARD_COMM_VOTE", bool, False,
       "Pre-allreduce finiteness vote of the dist kvstore "
       "(kvstore/dist.py): each rank's all-finite bit rides a one-hot "
       "all-reduce before the gradients', so a non-finite gradient raises "
       "NonFiniteGradientError on every rank naming the rank(s) it came "
       "from, before it reaches the global model (one host read and one "
       "small all-reduce per guarded call).")
define("MXNET_MODELWATCH", bool, False,
       "Training-dynamics observability (modelwatch.py; needs "
       "MXNET_TELEMETRY=1): per-layer gradient, parameter and update-ratio "
       "gauges (mx_layer_*), a rolling z-score that names an exploding or "
       "dead layer through the guard event stream, computed by extending "
       "the guard's one reduction, so a watched step still costs one host "
       "read.")
define("MXNET_MODELWATCH_EVERY", int, 1,
       "Sample the modelwatch statistics every N optimizer steps (1 = every "
       "step); the other steps run the plain guard reduction.")
define("MXNET_MODELWATCH_ZWARN", float, 6.0,
       "Rolling z-score threshold of modelwatch's exploding-layer detector "
       "(0 disables detection; the gauges still export).")
define("MXNET_NOISE_SCALE", bool, True,
       "With MXNET_MODELWATCH on a data-parallel step of two or more "
       "replicas: the gradient noise scale from the per-replica norms. One "
       "device has no such estimate, so the gauge stays absent.")
define("MXNET_TELEMETRY", bool, False,
       "Master switch of the telemetry registry (telemetry.py): engine op "
       "spans and latency histograms, the per-step phase breakdown, guard, "
       "fault and checkpoint counters, compile accounting. The read is "
       "cached: call telemetry.refresh() after changing it.")
define("MXNET_TELEMETRY_HEARTBEAT", float, 0.0,
       "Period in seconds of the heartbeat line on the "
       "'mxnet_tpu_torch.telemetry' logger (0 disables; needs "
       "MXNET_TELEMETRY=1).")
define("MXNET_COMPILE_WARN_N", int, 5,
       "Recompile-storm guard (compilewatch.py; needs MXNET_TELEMETRY=1): "
       "once one watched program site takes more than N new signatures "
       "after its first, warn with the signature diffs (0 disables).")
define("MXNET_COMPILE_STRICT", bool, False,
       "Raise MXNetError instead of warning past MXNET_COMPILE_WARN_N.")
define("MXNET_STRAGGLER_WARN", float, 0.0,
       "Fleet straggler threshold as relative per-step skew ((slowest - "
       "median) / median over the ranks' mean step time): when "
       "telemetry.fleet_snapshot() merges a view whose skew exceeds it, "
       "it warns naming the slowest rank and whether communication or "
       "compute makes it slow, and counts mx_straggler_events_total"
       "{rank,phase}. 0 disables.")
define("MXNET_FLEET_SNAPSHOT_PERIOD", int, 0,
       "Merge the fleet view every N optimizer steps from mark_step (0 "
       "disables).")
define("MXNET_PEAK_FLOPS", float, 0.0,
       "Peak FLOP/s the mx_mfu gauge divides by. 0 = the card's published "
       "bf16 dense rate by torch.cuda.get_device_name(); on a device not "
       "in that table mx_mfu is not exported.")
define("MXNET_CRASH_BUNDLE_DIR", str, "",
       "Directory for crash postmortem bundles (telemetry.crash_bundle): a "
       "raising guard, an engine op error or a watchdog writes the "
       "modelwatch ring, the snapshot, the chrome trace, the compilewatch "
       "table and the environment into one atomically published "
       "subdirectory. Empty disables.")
define("MXNET_CKPT_KEEP", int, 0,
       "Checkpoint retention window per prefix (model.save_checkpoint): "
       "keep the newest N manifest entries and delete the pruned files (0 "
       "keeps all; save_checkpoint's max_keep overrides).")
define("MXNET_ELASTIC", bool, False,
       "Elastic training (elastic.py): Estimator.fit polls for a "
       "preemption notice (elastic.request_preemption, the slice_preempt "
       "fault site, SIGTERM with MXNET_ELASTIC_SIGTERM, or the notice key "
       "mx/elastic/preempt on the process group's store) and moves the "
       "live run onto the surviving contexts through Trainer.reshard_to "
       "(parallel/reshard.py); a failed move, or fewer survivors than "
       "MXNET_ELASTIC_MIN_DEVICES, restores the newest checkpoint "
       "instead.")
define("MXNET_ELASTIC_POLL", int, 1,
       "With MXNET_ELASTIC: poll for a preemption notice every this many "
       "Trainer steps.")
define("MXNET_ELASTIC_BLOCK", int, 4 << 20,
       "Staged block in bytes of parallel/reshard.py's moves: no device "
       "holds more than its destination shard plus one block in flight.")
define("MXNET_ELASTIC_MIN_DEVICES", int, 1,
       "With MXNET_ELASTIC: the smallest survivor set a live reshard "
       "targets; fewer survivors restore the newest checkpoint.")
define("MXNET_ELASTIC_SIGTERM", bool, False,
       "With MXNET_ELASTIC: install a SIGTERM handler that raises the "
       "preemption notice (the front half of the contexts survives). Off "
       "by default, so importing the library never takes the signal.")
define("MXNET_CHUNKED_CE", bool, True,
       "BERTMLMLoss(mode='auto') runs the chunked LM-head cross entropy "
       "(_contrib_chunked_lm_head_ce: an online softmax over vocab "
       "chunks, so the (positions, vocab) logits never exist whole); off, "
       "the dense Dense + log_softmax + pick composition.")
define("MXNET_CHUNKED_CE_CHUNK", int, 4096,
       "Vocab chunk of _contrib_chunked_lm_head_ce when the caller passes "
       "none (the vocab is padded to whole chunks with -1e30 bias "
       "logits).")
define("MXNET_AUTOTUNE", str, "off",
       "Launch-plan auto-tuner mode (autotune.py): 'off' (default) keeps "
       "every hand-picked plan — the kernels' grids, the attention head "
       "block, the CE chunk — exactly as without the tuner, and never "
       "reads the table; 'cost' picks, for each (card, kernel, shape), the "
       "candidate plan the card can launch with the lowest roofline "
       "max(FLOPs / peak rate, bytes / HBM rate) over its analytic "
       "figures (ties keep the default, listed first); 'measure' "
       "additionally times the best candidates against the default in "
       "interleaved paired rounds with CUDA events, and keeps one only "
       "when its paired-median ratio is below 1. Any other string reads "
       "as 'off'.")
define("MXNET_AUTOTUNE_CACHE", str, "",
       "JSON file persisting the autotune table across processes, keyed "
       "'card|kernel|shape'. Empty keeps the decisions in the process. An "
       "entry that fails its kernel's validation (stale or hand-edited) "
       "is ignored with a warning and the default plan runs.")
define("MXNET_PERF_DB", str, "",
       "Root directory of the performance-trajectory store (perfwatch.py): "
       "one JSONL file per (device kind, metric), published atomically "
       "(tmp + rename). When set, every bench-JSON record emitted through "
       "mxnet_tpu_torch/tools/bench_json.py is stored with an environment "
       "fingerprint; mxnet_tpu_torch/tools/perfwatch.py ingests, reports "
       "and gates over it. Empty: no store.")
define("MXNET_PERFWATCH", bool, True,
       "Switch of the bench-emit ingestion seam (perfwatch.maybe_record): "
       "recording engages only when this is on and MXNET_PERF_DB names a "
       "store. The read is cached: call perfwatch.refresh() (or "
       "telemetry.refresh(), which chains) after changing it.")
define("MXNET_PERFWATCH_TOL", float, 0.05,
       "Relative tolerance of perfwatch verdicts: the latest point must "
       "differ from the rolling-median baseline by more than this "
       "fraction (and clear the MAD score bar) to read regressed or "
       "improved.")
define("MXNET_PERFWATCH_TOL_OVERRIDES", str, "",
       "Per-metric tolerances, 'metric=tol,metric=tol'; a name matches "
       "itself and its derived sub-series by prefix, the longest match "
       "winning over MXNET_PERFWATCH_TOL.")
define("MXNET_PERFWATCH_MAD_K", float, 3.0,
       "MAD-score bar of perfwatch verdicts and change points: the "
       "deviation from the baseline must exceed this many scaled MADs "
       "(1.4826 x the median absolute deviation of the window).")
define("MXNET_PERFWATCH_WINDOW", int, 8,
       "Rolling window of perfwatch baselines: the latest point is judged "
       "against the median and MAD of up to this many preceding points of "
       "its (device kind, metric) series.")
define("MXNET_DATALOADER_RESTARTS", int, 2,
       "Restart budget for dead DataLoader worker processes per epoch "
       "(gluon/data/dataloader.py); once it is spent the loader warns and "
       "loads the rest of the epoch in-process.")
define("MXNET_PREFETCH_DEPTH", int, 2,
       "DataLoader read-ahead (gluon/data/dataloader.py): up to this many "
       "upcoming batches are made on the host and staged onto the card by "
       "non-blocking copies from pinned memory while the consumer "
       "computes; 0 makes each batch on the loader's context when it is "
       "asked for.")
