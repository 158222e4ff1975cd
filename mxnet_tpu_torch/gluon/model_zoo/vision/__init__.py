"""Vision model zoo, the ResNet family (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``; ref:
python/mxnet/gluon/model_zoo/vision/__init__.py). AlexNet, VGG,
MobileNet, DenseNet, SqueezeNet and Inception are not ported yet."""
from .resnet import *   # noqa: F401,F403
from .resnet import get_resnet
from . import resnet as _resnet

_models = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name[0].islower() and not name.startswith("get_")}


def get_model(name, **kwargs):
    """Look up a model constructor by name (ref: model_zoo get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s not found. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
