"""Gluon neural-network layers (counterpart of ``mxnet_tpu/gluon/nn/``)."""
from .basic_layers import *   # noqa: F401,F403
from .conv_layers import *    # noqa: F401,F403
from .activations import *    # noqa: F401,F403
