"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``; ref:
python/mxnet/gluon/contrib/). ``estimator`` is ROADMAP.md queue 1,
item 13."""
from . import nn  # noqa: F401
