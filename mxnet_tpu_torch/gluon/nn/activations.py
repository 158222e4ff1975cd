"""Activation blocks (counterpart of ``mxnet_tpu/gluon/nn/activations.py``;
ref: python/mxnet/gluon/nn/activations.py). Each is the reference's op
call: the ``LeakyReLU`` op's modes, and Swish as x·sigmoid(βx)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish"]


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU({})".format(self._alpha)


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` (one, initialised to
    0.25)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer as init_mod
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
