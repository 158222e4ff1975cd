"""The Horovod kvstore plugin (counterpart of
``mxnet_tpu/kvstore/horovod.py``; ref: python/mxnet/kvstore/horovod.py,
the KVStoreBase plugin that routes the Trainer through hvd.allreduce).

It delegates to ``horovod.torch`` where that imports and raises
MXNetError where it does not, as the reference plugin needs its
package."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .base import KVStoreBase

__all__ = ["Horovod"]


@KVStoreBase.register("horovod")
class Horovod(KVStoreBase):
    def __init__(self, name="horovod"):
        try:
            import horovod.torch as hvd
        except ImportError as e:
            raise MXNetError(
                "kvstore 'horovod' needs the horovod package (horovod."
                "torch), as the reference plugin does") from e
        self._hvd = hvd
        hvd.init()

    @property
    def type(self):
        return "horovod"

    @property
    def rank(self):
        return self._hvd.rank()

    @property
    def num_workers(self):
        return self._hvd.size()

    @staticmethod
    def _write(out, t):
        outs = out if isinstance(out, (list, tuple)) else [out]
        with torch.no_grad():
            for o in outs:
                o.tensor().copy_(t)

    def broadcast(self, key, value, out, priority=0):
        vals = value if isinstance(value, (list, tuple)) else [value]
        res = self._hvd.broadcast(vals[0].tensor().detach(), root_rank=0,
                                  name=str(key))
        self._write(out, res)

    def pushpull(self, key, value, out=None, priority=0):
        vals = value if isinstance(value, (list, tuple)) else [value]
        # the local replicas summed first, then one all-reduce across
        # the processes
        local = vals[0].tensor().detach()
        for v in vals[1:]:
            local = local + v.tensor().detach().to(local.device)
        red = self._hvd.allreduce(local, average=False, name=str(key))
        self._write(out if out is not None else value, red)

    def is_capable(self, capability):
        return {"optimizer": False}.get(capability, False)
