"""Contrib packages of the port (counterpart of ``mxnet_tpu/contrib``):
``amp``."""
from . import amp  # noqa: F401
