"""Meshes, collectives and the SPMD sharded training step (counterpart of
``mxnet_tpu/parallel``).

The Trainer with a kvstore is MXNet's per-device path; this package is
the single-controller path of the reference: a :class:`Mesh` of the
port's contexts, ``shard_map`` and the collectives over its axes, and
:class:`ShardedTrainStep`, which trains a Gluon net over the mesh in one
captured program a step. The pipeline, mixture-of-experts and
ring-attention layers are not ported yet: their names raise.
"""
from .mesh import make_mesh, Mesh, MeshConfig, NamedSharding, P
from .collectives import shard_map
from .sharded import (ShardedTrainStep, shard_params, data_parallel_step,
                      batch_axes)
from . import collectives


def _third_slice(name):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            "parallel.%s is not ported yet (ROADMAP.md queue 1, item 11, "
            "its third slice: pipeline.py, moe.py, ring_attention.py)"
            % name)
    refused.__name__ = name
    refused.__qualname__ = name
    refused.__doc__ = "Not ported yet: raises NotImplementedError."
    return refused


moe_apply = _third_slice("moe_apply")
make_moe_layer = _third_slice("make_moe_layer")
pipeline_apply = _third_slice("pipeline_apply")
make_pipeline_step = _third_slice("make_pipeline_step")
local_attention = _third_slice("local_attention")
ring_attention = _third_slice("ring_attention")
ulysses_attention = _third_slice("ulysses_attention")
