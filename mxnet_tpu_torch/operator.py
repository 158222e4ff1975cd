"""Custom operators in Python (counterpart of ``mxnet_tpu/operator.py``;
ref: python/mxnet/operator.py :: CustomOp/CustomOpProp/register and
src/operator/custom/custom.cc).

Usage, as in the reference::

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], 1 / (1 + nd.exp(-in_data[0])))
        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @mx.operator.register("sigmoid_custom")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    y = mx.nd.Custom(x, op_type="sigmoid_custom")   # or F.Custom in a block

Execution: the callback runs inline, on the calling thread, which is
the reference's own path when its native engine is absent. The
reference's engine-gated path (the callback pushed to engine workers,
outputs gated until it finishes) waits for the engine port (ROADMAP
queue 1, item 10). The forward runs under ``autograd.pause()``; inside
``record()``, with an input in the graph, the op is one node of torch's
tape (:func:`autograd.record_callback`) whose backward calls the op's
``backward`` under ``pause()``.
"""
from __future__ import annotations

from typing import List

import torch

from . import autograd
from .base import MXNetError, Registry
from .ndarray.ndarray import NDArray, zeros
from .ops import register_ndarray_fn

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop"]

_PROPS = Registry("custom_op")


def _tensor_like(src, like: torch.Tensor) -> torch.Tensor:
    if isinstance(src, NDArray):
        return src.tensor()
    if isinstance(src, torch.Tensor):
        return src
    return torch.as_tensor(src, dtype=like.dtype,
                           device=like.device).expand(like.shape)


class CustomOp:
    """User op body (ref: operator.py :: CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    @staticmethod
    def assign(dst: NDArray, req: str, src):
        """Set ``dst`` from ``src`` by ``req``: write/inplace rebinds it,
        add rebinds it to the sum, null leaves it."""
        if req in ("write", "inplace", None):
            dst._t = _tensor_like(src, dst._t)
        elif req == "add":
            dst._t = dst._t + _tensor_like(src, dst._t)
        elif req != "null":
            raise MXNetError("unknown req %r" % req)


class CustomOpProp:
    """Op metadata and factory (ref: operator.py :: CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Decorator registering a CustomOpProp under ``op_type=reg_name``."""
    def wrap(prop_cls):
        _PROPS.register(reg_name)(prop_cls)
        return prop_cls
    return wrap


def get_prop(name: str):
    return _PROPS.find(name)


def _custom_call(*inputs, op_type=None, **kwargs):
    """``nd.Custom`` / ``F.Custom`` (ref: custom.cc :: CustomOperator)."""
    if op_type is None:
        raise MXNetError("nd.Custom requires op_type=")
    prop_cls = _PROPS.find(op_type)
    if prop_cls is None:
        raise MXNetError("unknown custom op %r (register it with "
                         "mx.operator.register)" % op_type)
    # every kwarg goes to the prop's constructor, as in custom.cc
    prop = prop_cls(**kwargs)
    n_aux = len(prop.list_auxiliary_states())
    if n_aux:
        data_in, aux = list(inputs[:-n_aux]), list(inputs[-n_aux:])
    else:
        data_in, aux = list(inputs), []
    ctx = data_in[0].context if data_in else None
    in_shapes = [list(a.shape) for a in data_in]
    out_shapes = prop.infer_shape(in_shapes)[1]
    in_types = [a.dtype for a in data_in]
    out_types = prop.infer_type(in_types)[1]
    op = prop.create_operator(ctx, in_shapes, in_types)
    is_train = autograd.is_training()
    # the callbacks see the inputs off the tape
    exec_in = [NDArray(a.tensor().detach(), a.context) for a in data_in]

    def run_forward():
        outs = [zeros(tuple(s), ctx=ctx, dtype=t)
                for s, t in zip(out_shapes, out_types)]
        with autograd.pause():
            op.forward(is_train, ["write"] * len(outs), exec_in, outs, aux)
        return [o.tensor() for o in outs]

    def run_backward(grads, outputs):
        with autograd.pause():
            in_grads = [zeros(a.shape, ctx=ctx, dtype=a.dtype)
                        for a in data_in]
            op.backward(["write"] * len(in_grads),
                        [NDArray(g, ctx) for g in grads], exec_in,
                        [NDArray(o.detach(), ctx) for o in outputs],
                        in_grads, aux)
        return [g.tensor() for g in in_grads]

    tensors = autograd.record_callback(data_in, run_forward, run_backward)
    res = [NDArray(t, ctx) for t in tensors]
    return res if len(res) > 1 else res[0]


register_ndarray_fn("Custom", _custom_call)
