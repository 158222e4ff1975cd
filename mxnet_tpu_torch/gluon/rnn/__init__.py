"""Gluon recurrent layers and cells (counterpart of
``mxnet_tpu/gluon/rnn/``)."""
from .rnn_layer import *   # noqa: F401,F403
from .rnn_cell import *    # noqa: F401,F403
