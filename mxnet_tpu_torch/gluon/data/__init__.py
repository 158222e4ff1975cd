"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``; ref:
python/mxnet/gluon/data/). ``vision`` (MNIST, CIFAR and the image
transforms) and ``RecordFileDataset`` are not ported yet (ROADMAP queue
1, item 9)."""
from .dataset import *     # noqa: F401,F403
from .sampler import *     # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
