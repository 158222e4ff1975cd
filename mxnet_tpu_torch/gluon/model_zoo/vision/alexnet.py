"""AlexNet (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``; ref:
python/mxnet/gluon/model_zoo/vision/alexnet.py).

The structure is the reference's, block for block; the parameter names
are MXNet 1.x's (see ``AlexNet``), and the shapes equal the
reference's."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """The features are named in AlexNet's own scope, as MXNet 1.x names
    them under the empty prefix (dense0 and dense1, the output dense2).
    The reference enters the features' scope, which counts from 0 again,
    so its features and output both hold ``dense0`` and its
    ``collect_params`` raises (ROADMAP queue 3)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                        padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights unavailable (no network)")
    return AlexNet(**kwargs)
