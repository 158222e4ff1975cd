"""Inception v3 (299 x 299 input) (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; ref:
python/mxnet/gluon/model_zoo/vision/inception.py).

The structure is the reference's, block for block, so parameter names
and shapes equal the reference's for the same prefix and weights carry
by name (``interop.params_from_numpy``)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(channels, **kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    """Parallel branches concatenated on channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        self.branches = branches
        for i, b in enumerate(branches):
            setattr(self, "b%d" % i, b)  # register children

    def hybrid_forward(self, F, x):
        outs = [b(x) for b in self.branches]
        return F.Concat(*outs, dim=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kernel_size, strides, padding, channels = setting
        kw = {"kernel_size": kernel_size}
        if strides is not None:
            kw["strides"] = strides
        if padding is not None:
            kw["padding"] = padding
        out.add(_make_basic_conv(channels, **kw))
    return out


def _make_A(pool_features, prefix):
    return _Branches([
        _make_branch(None, (1, None, None, 64)),
        _make_branch(None, (1, None, None, 48), (5, None, 2, 64)),
        _make_branch(None, (1, None, None, 64), (3, None, 1, 96),
                     (3, None, 1, 96)),
        _make_branch("avg", (1, None, None, pool_features)),
    ], prefix=prefix)


def _make_B(prefix):
    return _Branches([
        _make_branch(None, (3, 2, None, 384)),
        _make_branch(None, (1, None, None, 64), (3, None, 1, 96),
                     (3, 2, None, 96)),
        _make_branch("max"),
    ], prefix=prefix)


def _make_C(channels_7x7, prefix):
    return _Branches([
        _make_branch(None, (1, None, None, 192)),
        _make_branch(None, (1, None, None, channels_7x7),
                     ((1, 7), None, (0, 3), channels_7x7),
                     ((7, 1), None, (3, 0), 192)),
        _make_branch(None, (1, None, None, channels_7x7),
                     ((7, 1), None, (3, 0), channels_7x7),
                     ((1, 7), None, (0, 3), channels_7x7),
                     ((7, 1), None, (3, 0), channels_7x7),
                     ((1, 7), None, (0, 3), 192)),
        _make_branch("avg", (1, None, None, 192)),
    ], prefix=prefix)


def _make_D(prefix):
    return _Branches([
        _make_branch(None, (1, None, None, 192), (3, 2, None, 320)),
        _make_branch(None, (1, None, None, 192),
                     ((1, 7), None, (0, 3), 192),
                     ((7, 1), None, (3, 0), 192), (3, 2, None, 192)),
        _make_branch("max"),
    ], prefix=prefix)


def _make_E(prefix):
    # E's 3x3 branches themselves split into 1x3/3x1 pairs
    class _EBranch(HybridBlock):
        def __init__(self, pre_settings, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.pre = _make_branch(None, *pre_settings) \
                    if pre_settings else None
                self.a = _make_basic_conv(384, kernel_size=(1, 3),
                                          padding=(0, 1))
                self.b = _make_basic_conv(384, kernel_size=(3, 1),
                                          padding=(1, 0))

        def hybrid_forward(self, F, x):
            if self.pre is not None:
                x = self.pre(x)
            return F.Concat(self.a(x), self.b(x), dim=1)

    return _Branches([
        _make_branch(None, (1, None, None, 320)),
        _EBranch([(1, None, None, 384)]),
        _EBranch([(1, None, None, 448), (3, None, 1, 384)]),
        _make_branch("avg", (1, None, None, 192)),
    ], prefix=prefix)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(32, kernel_size=3, strides=2))
            self.features.add(_make_basic_conv(32, kernel_size=3))
            self.features.add(_make_basic_conv(64, kernel_size=3, padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(80, kernel_size=1))
            self.features.add(_make_basic_conv(192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(**kwargs):
    return Inception3(**kwargs)
