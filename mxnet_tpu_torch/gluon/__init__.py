"""Gluon — the imperative/hybrid user API (counterpart of
``mxnet_tpu/gluon/``)."""
from .parameter import Parameter, Constant, ParameterDict
from .block import Block, HybridBlock
from .trainer import Trainer
from . import loss
from . import nn
from . import model_zoo
from . import data
from . import rnn
from . import utils
from . import contrib
