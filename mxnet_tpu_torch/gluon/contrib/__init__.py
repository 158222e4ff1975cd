"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib/``; ref:
python/mxnet/gluon/contrib/): ``nn`` and ``estimator``."""
from . import nn  # noqa: F401
from . import estimator  # noqa: F401
