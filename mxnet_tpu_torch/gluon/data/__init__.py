"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``; ref:
python/mxnet/gluon/data/). ``RecordFileDataset`` and the image-decoding
datasets of ``vision`` wait for ``recordio.py`` and an image decoder
(ROADMAP queue 1, item 9, second part)."""
from .dataset import *     # noqa: F401,F403
from .sampler import *     # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision       # noqa: F401
