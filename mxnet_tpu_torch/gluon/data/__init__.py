"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``; ref:
python/mxnet/gluon/data/)."""
from .dataset import *     # noqa: F401,F403
from .sampler import *     # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision       # noqa: F401
