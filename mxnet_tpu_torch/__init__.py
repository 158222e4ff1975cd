"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``, for one
NVIDIA H100.

The port keeps the reference package's module names and public names,
and runs on the card by default: ``current_context()`` is ``gpu(0)``,
and building or serving on a machine without CUDA raises
:class:`MXNetError` unless the caller passes ``ctx=mx.cpu()``. Every
kernel the reference wrote in Pallas for the TPU becomes a kernel
written by hand for Hopper (``csrc/``, built at first use). The first
slice serves BERT through :class:`serve.InferenceSession` with the
LayerNorm, packed self-attention, bias+GeLU and bias+residual forward
kernels; the second trains it through ``autograd.record()``,
``backward()`` and ``gluon.Trainer`` with the LayerNorm, attention and
bias+GeLU backward kernels and the dropout kernel; the third trains
ResNet-50 v1 and brings the fused bottleneck stages with their dual
BN-backward kernel. The fourth opens the user-extension surface:
``rtc.CudaModule`` compiles a user's CUDA C at runtime for the card
(the reference's Pallas ``rtc`` launcher), used inside
``operator.CustomOp`` (``nd.Custom``/``F.Custom``) and
``autograd.Function``, with ``autograd.grad``, ``gluon.data`` and
``metric``, in the Gluon MNIST MLP. The ninth trains BERT-base as the
reference's flagship configuration does: the chunked LM-head cross
entropy (``BERTMLMLoss``'s default), ``contrib.amp`` with its loss
scaler, multi-precision master weights, LAMB's phase ops, Adam/AdamW
and ``lr_scheduler``. The eleventh brings the reference's whole NDArray
surface and ``gluon.rnn``, and trains upstream MXNet's PTB
word-language model (a tied 2-layer LSTM) with ``gluon.utils.
clip_global_norm``. The fifteenth brings the ImageNet input path:
``recordio``, ``io`` (``ImageRecordIter`` on the native decode/augment
pipeline of ``csrc/io.cc``, built with g++ at first use), ``image`` and
the record datasets, and ``python -m mxnet_tpu_torch.tools.im2rec``.
The twentieth brings the runtime services: ``telemetry`` (the metrics
registry, step phases, MFU and goodput, the heartbeat, crash bundles),
``profiler`` (chrome traces with the card's kernels from
``torch.profiler``), ``compilewatch`` (every captured graph as a
program), ``modelwatch`` (per-layer training dynamics in the guard's one
host read), ``model`` (asynchronous crash-safe checkpoints),
``gluon.contrib.estimator``, ``monitor`` and ``callback``. The
twenty-second trains data-parallel through ``kvstore``: ``local``,
``device`` and ``nccl`` across a process's contexts, ``dist_sync``,
``dist_async``, ``p3store_dist`` and ``horovod`` across processes
launched by ``python -m mxnet_tpu_torch.tools.launch`` (``dist``'s
process group on NCCL or gloo), with ``commwatch``'s accounting of
every reduce. The twenty-third brings ``parallel``: meshes, the
collectives and ``shard_map``, and the SPMD ``ShardedTrainStep`` (one
captured program a step, global-batch BatchNorm, sharded parameters).

Usage mirrors the reference::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    net = bert_12_768_12(dropout=0.0)
    net.initialize()
    net.cast("bfloat16")
    sess = net.serve_session(ids, token_types, seq_axis=1)
    outs = sess.infer(ids_np, token_types_np)

    mx.contrib.amp.init(target_dtype="bfloat16")
    mlm = BERTMLMLoss(vocab_size=30522, units=768)     # chunked head
    sched = mx.lr_scheduler.PolyScheduler(max_update=1000, base_lr=1e-3,
                                          warmup_steps=100)
    trainer = mx.gluon.Trainer(params, "lamb", {"learning_rate": 1e-3,
                                                "lr_scheduler": sched})
    with mx.autograd.record():
        loss = mlm(net(ids, token_types)[0], labels).mean()
    loss.backward()
    trainer.step(batch_size)

    mod = mx.rtc.CudaModule(cuda_source, plain={"relu": relu_plain})
    y = mod.get_kernel("relu").launch([x])

    it = mx.io.ImageRecordIter(path_imgrec="train.rec",
                               path_imgidx="train.idx",
                               data_shape=(3, 224, 224), batch_size=128,
                               shuffle=True, rand_crop=True,
                               rand_mirror=True, resize=256,
                               preprocess_threads=4)
    for batch in it:               # batch.data[0] on the card, NCHW f32
        ...
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from . import profiler
from . import telemetry
from .context import Context, cpu, cpu_pinned, current_context, gpu, num_gpus
from . import ndarray
from .ndarray import waitall
from . import ndarray as nd
from .ndarray import NDArray
from . import autograd
from . import random
from . import initializer
from . import initializer as init
from . import optimizer
from .optimizer import Optimizer
from . import lr_scheduler
from . import kvstore
from . import kvstore as kv
from .kvstore import KVStore
from . import gluon
from . import serve
from . import operator
from . import rtc
from . import metric
from . import guardrails
from .guardrails import GradGuard
from . import faultinject
from . import scan
from . import contrib
from . import recordio
from . import native
from . import engine
from . import io
from . import image
from . import compilewatch
from . import commwatch
from . import modelwatch
from . import model
from .model import (save_checkpoint, load_checkpoint,
                    load_latest_checkpoint, wait_checkpoints)
from . import monitor
from .monitor import Monitor
from . import callback
from . import dist
from . import parallel
from .interop import params_from_numpy

# a raising guard, an engine op error or a watchdog writes a crash
# bundle once MXNET_CRASH_BUNDLE_DIR is set
telemetry.install_crash_bundler()
