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

Execution (ref: custom.cc :: CustomOperator::Push): ``nd.Custom``
pushes the forward callback to the native dependency engine's workers
(:mod:`mxnet_tpu_torch.engine`, ``MXNET_CUSTOM_OP_NUM_THREADS``) and
returns at once. Its outputs, and its aux states, which the callback
mutates, are gated on the op's write var: reading one waits for the
callback, and an exception raised in it re-raises there, at
``wait_to_read`` or ``asnumpy``, not at the call. The inputs that are
not gated are snapshotted at the call, so a later in-place write does
not reach the callback; gated inputs (another custom op's outputs) are
the op's read dependencies, pinned until the read ends, so an in-place
write to one waits for this op first. On the card the worker waits for
an event recorded on the caller's stream at the call, runs the callback
on a stream of its own and synchronises it before the op completes. The
callback writes into output buffers allocated at the call, which are the
returned arrays' tensors. Inside ``record()``, with an input in the
graph, the op is one node of torch's tape over those buffers
(:func:`autograd.record_callback`); its backward calls the op's
``backward`` under ``pause()`` on the calling thread. Inside a
hybridized call (a CachedOp's forward, its capture, a K-step chunk) the
callback runs inline, on the calling thread, as it must for a captured
graph.
"""
from __future__ import annotations

import threading
from typing import List

import torch

from . import autograd
from . import cached_op as _cached_op
from . import engine as _engine
from .base import MXNetError, Registry
from .symbol import layout_opt as _layout_opt
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
    if _cached_op.in_call() or (ctx.device_type == "gpu"
                                and torch.cuda.is_current_stream_capturing()):
        return _custom_inline(op, data_in, aux, ctx, out_shapes, out_types,
                              is_train, kwargs)
    return _custom_gated(op, op_type, data_in, aux, ctx, out_shapes,
                         out_types, is_train)


def _custom_inline(op, data_in, aux, ctx, out_shapes, out_types, is_train,
                   attrs):
    """The callback on the calling thread (a hybridized call)."""
    plan = _layout_opt.active()
    if plan is not None:
        plan.consumed("Custom", attrs, [a.tensor() for a in data_in])
    # the callbacks see the inputs off the tape
    exec_in = [NDArray(a.tensor().detach(), a.context) for a in data_in]

    def run_forward():
        outs = [zeros(tuple(s), ctx=ctx, dtype=t)
                for s, t in zip(out_shapes, out_types)]
        with autograd.pause():
            op.forward(is_train, ["write"] * len(outs), exec_in, outs, aux)
        return [o.tensor() for o in outs]

    tensors = autograd.record_callback(
        data_in, run_forward, _run_backward(op, data_in, exec_in, aux, ctx))
    res = [NDArray(t, ctx) for t in tensors]
    return res if len(res) > 1 else res[0]


def _run_backward(op, data_in, exec_in, aux, ctx):
    def run_backward(grads, outputs):
        with autograd.pause():
            in_grads = [zeros(a.shape, ctx=ctx, dtype=a.dtype)
                        for a in data_in]
            op.backward(["write"] * len(in_grads),
                        [NDArray(g, ctx) for g in grads], exec_in,
                        [NDArray(o.detach(), ctx) for o in outputs],
                        in_grads, aux)
        return [g.tensor() for g in in_grads]
    return run_backward


_STREAMS = threading.local()


def _worker_stream(device: torch.device):
    """This engine worker's own stream on ``device``."""
    streams = getattr(_STREAMS, "by_device", None)
    if streams is None:
        streams = _STREAMS.by_device = {}
    s = streams.get(device.index)
    if s is None:
        s = streams[device.index] = torch.cuda.Stream(device=device)
    return s


def _custom_gated(op, op_type, data_in, aux, ctx, out_shapes, out_types,
                  is_train):
    """The callback pushed to the native engine; returns gated arrays at
    once (ref: operator.py's engine path)."""
    gated = [a._pending is not None and
             isinstance(a._pending[0], _engine.EngineGate) for a in data_in]
    # snapshot the inputs not gated: a write after the call must not
    # change what the callback reads; gated ones are ordered by read deps
    # and read when the op runs
    exec_in = [None if g else NDArray(a.tensor().detach().clone(), a.context)
               for a, g in zip(data_in, gated)]
    bufs = [zeros(tuple(s), ctx=ctx, dtype=t).tensor()
            for s, t in zip(out_shapes, out_types)]
    # aliases with version counters of their own: the worker's writes do
    # not invalidate what the tape saved of the buffers
    writers = [_cached_op._alias(b, False) for b in bufs]
    cb_outs = [NDArray(w, ctx) for w in writers]
    device = data_in[0]._t.device if data_in else None
    ready = None
    if device is not None and device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))

    def run_backward(grads, outputs):
        for o in res:
            o.tensor()
        return _run_backward(op, data_in, exec_in, aux, ctx)(grads, outputs)

    graph_in = [a._t for a in data_in]
    if autograd.is_recording() and any(t.requires_grad for t in graph_in):
        with torch.enable_grad():
            outs = autograd._Callback.apply(lambda: bufs, run_backward,
                                            *graph_in)
    else:
        outs = bufs
    res = [NDArray(t, ctx) for t in outs]
    deps = _engine.read_deps(data_in + aux)
    var, gate = _engine.gate_arrays(res + aux, [None] * (len(res) + len(aux)))
    pinned = _engine.pin_reads(data_in + aux, gate)

    def body():
        # the arrays as they stand now: their producers ran, and a later
        # op's gate on them must not make this one wait on it
        for i, a in enumerate(data_in):
            if exec_in[i] is None:
                exec_in[i] = NDArray(a._t, a.context)
        cb_aux = [NDArray(a._t, a.context) for a in aux]
        with autograd.pause(), torch.no_grad():
            op.forward(is_train, ["write"] * len(cb_outs), exec_in, cb_outs,
                       cb_aux)
            for a, c in zip(aux, cb_aux):
                a._t = c._t
            # a callback that rebound its output: its values into the
            # buffer the caller holds
            for o, w in zip(cb_outs, writers):
                if o._t is not w:
                    w.copy_(o._t)

    def run_forward():
        try:
            if ready is None:
                body()
            else:
                s = _worker_stream(device)
                with torch.cuda.device(device), torch.cuda.stream(s):
                    s.wait_event(ready)
                    body()
                    s.synchronize()
            gate.clear()
        finally:
            _engine.unpin_reads(pinned, gate)

    _engine.push_gated(run_forward, var, read_vars=deps,
                       label="custom_op:%s" % op_type)
    return res if len(res) > 1 else res[0]


register_ndarray_fn("Custom", _custom_call)
