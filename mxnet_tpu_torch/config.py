"""Declared runtime configuration of the port (counterpart of
``mxnet_tpu/config.py``).

Only the variables the ported modules read are declared here. They keep
the reference's names and meanings, so one environment drives both
packages. Reads are live: every :func:`get` consults the environment.

The reference's kernel switches (``MXNET_PALLAS_LAYERNORM``,
``MXNET_FLASH_ATTENTION``, ``MXNET_PALLAS_EPILOGUE``) have no counterpart:
the port decides kernel or plain version by the tensor's device and the
kernel's domain alone. Nor has ``MXNET_CONV_S2D``: the reference's
space-to-depth rewrite of the 7x7/s2 ResNet stem is the same math
re-expressed for the TPU's matrix unit, and the port leaves the choice
of convolution algorithm to cuDNN.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["Var", "VARS", "define", "get"]

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


define("MXNET_SERVE_BUCKETS", str, "",
       "Shape-bucket ladder for InferenceSession (serve/bucketing.py): "
       "'b1,b2,...' batch buckets, optionally ';s1,s2,...' sequence "
       "buckets. Empty = a power-of-two ladder up to max_batch/max_seq.")
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
       "ZeRO weight-update sharding; on, the Trainer raises (ROADMAP.md "
       "queue 1, item 11).")
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
       "Pre-allreduce finiteness vote of the dist kvstore; on, the "
       "Trainer raises (ROADMAP.md queue 1, item 11).")
define("MXNET_MODELWATCH", bool, False,
       "Training-dynamics statistics; on, the Trainer raises (ROADMAP.md "
       "queue 1, item 13).")
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
       "Kernel auto-tuner mode; 'off' keeps every hand-picked constant "
       "(the CE chunk above). Anything else raises where a tuned choice "
       "would be read (ROADMAP.md queue 1, item 15).")
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
