"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``; ref:
python/mxnet/gluon/model_zoo/vision/__init__.py): ResNet, AlexNet, VGG,
MobileNet, DenseNet, SqueezeNet and Inception v3, and ``get_model`` over
the same names as the reference's."""
from .resnet import *       # noqa: F401,F403
from .alexnet import *      # noqa: F401,F403
from .vgg import *          # noqa: F401,F403
from .mobilenet import *    # noqa: F401,F403
from .densenet import *     # noqa: F401,F403
from .squeezenet import *   # noqa: F401,F403
from .inception import *    # noqa: F401,F403

from .resnet import get_resnet                            # noqa: F401
from .vgg import get_vgg                                  # noqa: F401
from .mobilenet import get_mobilenet, get_mobilenet_v2    # noqa: F401
from .densenet import get_densenet                        # noqa: F401
from .squeezenet import get_squeezenet                    # noqa: F401

import sys as _sys

_models = {}


def _register_models():
    for modname in ("resnet", "alexnet", "vgg", "mobilenet", "densenet",
                    "squeezenet", "inception"):
        mod = _sys.modules[__name__ + "." + modname]
        for name in mod.__all__:
            fn = getattr(mod, name)
            if callable(fn) and not name.startswith("get_") \
                    and name[0].islower():
                _models[name] = fn


_register_models()


def get_model(name, **kwargs):
    """Look up a model constructor by name (ref: model_zoo get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s not found. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
