"""gluon.contrib.nn (counterpart of ``mxnet_tpu/gluon/contrib/nn.py``;
ref: python/mxnet/gluon/contrib/nn/basic_layers.py :: SyncBatchNorm,
HybridConcurrent, Identity).

``SyncBatchNorm`` is ``BatchNorm``, as in the reference: outside a
sharded step it normalizes over the batch its device holds; inside
``parallel.ShardedTrainStep`` every BatchNorm, this one included, takes
its statistics over the whole batch the step's replicas split
(``ops/nn.py`` ``_BNTrainFn``).
"""
from __future__ import annotations

from ..block import HybridBlock
from .. import nn as _nn

__all__ = ["SyncBatchNorm", "HybridConcurrent", "Concurrent", "Identity"]


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device batch normalization (ref: contrib SyncBatchNorm):
    ``BatchNorm`` over axis 1, whose statistics span the replicas of a
    sharded step; ``num_devices`` is kept and not read."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class Identity(HybridBlock):
    """Returns its input (ref: contrib nn.Identity)."""

    def hybrid_forward(self, F, x):
        return x


class HybridConcurrent(HybridBlock):
    """Runs every child on the same input and concatenates the outputs
    along ``axis`` (ref: contrib nn.HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


# the reference's name for the same container
Concurrent = HybridConcurrent
