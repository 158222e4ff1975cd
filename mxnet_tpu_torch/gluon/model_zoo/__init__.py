"""Model zoo, the BERT and ResNet families (counterpart of
``mxnet_tpu/gluon/model_zoo/``)."""
from . import bert
from . import vision
from .vision import get_model
