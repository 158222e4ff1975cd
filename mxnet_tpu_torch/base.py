"""Base error type and dtype names and the named registry of the
PyTorch/CUDA port (counterpart of ``mxnet_tpu/base.py``; ref:
include/mxnet/base.h :: dmlc::Error)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import ml_dtypes
import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "np_dtype", "Registry", "getenv",
           "env_bool", "env_int", "string_types"]

string_types = (str,)


class MXNetError(RuntimeError):
    """Framework error type (ref: include/mxnet/base.h :: dmlc::Error)."""


def getenv(name: str, default: Any = None) -> Any:
    """A raw environment read (ref: dmlc::GetEnv); declared variables
    are read through :func:`mxnet_tpu_torch.config.get`."""
    from .config import getenv_raw
    return getenv_raw(name, default)


def env_bool(name: str, default: bool = False) -> bool:
    from .config import getenv_raw
    v = getenv_raw(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


def env_int(name: str, default: int = 0) -> int:
    from .config import getenv_raw
    v = getenv_raw(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


_BY_NAME = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "uint32": torch.uint32, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype named by an MXNet dtype: a string ('float32',
    'bfloat16', ...), a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    elif getattr(dtype, "__name__", None) == "bfloat16" or \
            getattr(dtype, "name", None) == "bfloat16":
        name = "bfloat16"         # ml_dtypes' scalar type or its dtype
    else:
        name = np.dtype(dtype).name
    out = _BY_NAME.get(name)
    if out is None:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return out


_NP_BY_TORCH = {t: n for n, t in _BY_NAME.items()}


def np_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype, as the reference's
    ``NDArray.dtype`` gives it: bfloat16 is ``ml_dtypes.bfloat16``."""
    name = _NP_BY_TORCH.get(dtype)
    if name is None:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    if name == "bfloat16":
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


class Registry:
    """Named registry of factories (ref: dmlc::Registry /
    MXNET_REGISTER_*); custom ops and metrics register through it."""

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}
        Registry._registries[name] = self

    @classmethod
    def get(cls, name: str) -> "Registry":
        if name not in cls._registries:
            Registry(name)
        return cls._registries[name]

    def register(self, name: Optional[str] = None,
                 override: bool = False) -> Callable:
        def _reg(obj):
            key = (name or obj.__name__).lower()
            if key in self._entries and not override:
                raise ValueError("%s already registered in registry '%s'"
                                 % (key, self.name))
            self._entries[key] = obj
            return obj
        return _reg

    def find(self, name: str):
        return self._entries.get(name.lower())

    def create(self, name: str, *args, **kwargs):
        entry = self.find(name)
        if entry is None:
            raise MXNetError("Cannot find '%s' in registry '%s'. "
                             "Registered: %s"
                             % (name, self.name, sorted(self._entries)))
        return entry(*args, **kwargs)

    def keys(self):
        return list(self._entries)
