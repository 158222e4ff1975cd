"""The kvstore interface and its registry (counterpart of
``mxnet_tpu/kvstore/base.py``; ref: python/mxnet/kvstore/base.py ::
KVStoreBase.register, the mechanism that lets Horovod plug in)."""
from __future__ import annotations

from typing import Dict, Optional, Type

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """Abstract key-value store interface."""

    kv_registry: Dict[str, Type["KVStoreBase"]] = {}

    @classmethod
    def register(cls, name):
        """Class decorator registering a kvstore implementation under
        ``name`` (bare: under the class's lower-cased name)."""
        if isinstance(name, type):
            klass, name_ = name, name.__name__.lower()
            KVStoreBase.kv_registry[name_] = klass
            return klass

        def _reg(klass):
            KVStoreBase.kv_registry[str(name).lower()] = klass
            return klass
        return _reg

    @classmethod
    def get(cls, name) -> Optional[Type["KVStoreBase"]]:
        return cls.kv_registry.get(str(name).lower())

    OPTIMIZER = "optimizer"

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    def is_capable(self, capability: str) -> bool:
        raise NotImplementedError

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def num_workers(self) -> int:
        raise NotImplementedError
