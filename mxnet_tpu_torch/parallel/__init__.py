"""Meshes, collectives and the SPMD sharded training step (counterpart of
``mxnet_tpu/parallel``).

The Trainer with a kvstore is MXNet's per-device path; this package is
the single-controller path of the reference: a :class:`Mesh` of the
port's contexts, ``shard_map`` and the collectives over its axes, and
:class:`ShardedTrainStep`, which trains a Gluon net over the mesh in one
captured program a step. :mod:`.quantize` is the quantized gradient wire
(the kvstore's and ZeRO's) and :mod:`.reshard` the staged redistribution
elastic training moves state with. :mod:`.pipeline` (the GPipe
schedule), :mod:`.moe` (top-1 experts over one all-to-all each way) and
:mod:`.ring_attention` (ring and Ulysses sequence parallelism) run over
the differentiable ``ring_permute`` and ``all_to_all``.
"""
from .mesh import make_mesh, Mesh, MeshConfig, NamedSharding, P
from .collectives import shard_map
from .sharded import (ShardedTrainStep, shard_params, data_parallel_step,
                      batch_axes)
from . import collectives
from . import moe as moe_mod
from . import pipeline as pipeline_mod
from .moe import moe_apply, make_moe_layer
from .pipeline import pipeline_apply, make_pipeline_step
from . import ring_attention as ring_attention_mod
from .ring_attention import (local_attention, ring_attention,
                             ulysses_attention)
from . import quantize
from . import reshard
