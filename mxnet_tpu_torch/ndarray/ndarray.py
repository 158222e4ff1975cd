"""NDArray — a thin handle over a ``torch.Tensor`` (counterpart of
``mxnet_tpu/ndarray/ndarray.py``; ref: python/mxnet/ndarray/ndarray.py).

The tensor lives on the device of the array's Context. Arithmetic
dispatches through the op registry, as in the reference, so the ops a
forward runs are the registered ones. ``dtype`` is the ``torch.dtype``;
``asnumpy()`` of a bfloat16 array returns float32 values (numpy has no
bfloat16), which are exactly the bfloat16 values.

Autograd (ref: NDArray AGInfo + attach_grad): ``attach_grad`` makes the
tensor a torch leaf that requires grad and gives it a ``.grad`` array;
:func:`mxnet_tpu_torch.autograd.backward` fills it by ``grad_req``.
"""
from __future__ import annotations

import numbers
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, torch_dtype
from ..context import Context, context_of, current_context
from ..ops import Operator, _note, get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "to_tensor",
           "host_tensor"]


class NDArray:
    """A device-resident array."""

    __slots__ = ("_t", "_ctx", "_grad", "_grad_req", "__weakref__")

    # higher than numpy's so ndarray.__add__(NDArray) defers to us
    __array_priority__ = 1000.0

    def __init__(self, tensor: torch.Tensor, ctx: Optional[Context] = None):
        self._t = tensor
        self._ctx = ctx if ctx is not None else context_of(tensor.device)
        self._grad: Optional["NDArray"] = None
        self._grad_req = "null"

    # -- properties --------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._t.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._t.dtype

    @property
    def size(self) -> int:
        return self._t.numel()

    @property
    def ndim(self) -> int:
        return self._t.dim()

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    def tensor(self) -> torch.Tensor:
        """The underlying ``torch.Tensor`` (shared, not copied)."""
        return self._t

    # -- host transfer -----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A copy of the values on the host, bf16 widened to f32 on the
        device that holds them; one host copy on either device."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        elif t.device.type == "cpu":
            t = t.clone()
        return t.cpu().numpy()

    def wait_to_read(self):
        """Block until the values are computed: a no-op on the host, a
        sync of the array's stream on the card."""
        if self._t.is_cuda:
            torch.cuda.current_stream(self._t.device).synchronize()

    def __len__(self):
        if not self._t.dim():
            raise TypeError("len() of unsized object")
        return self._t.shape[0]

    def __getitem__(self, key) -> "NDArray":
        """Basic indexing (ints and slices): a view, recorded inside
        ``autograd.record()``."""
        parts = key if isinstance(key, tuple) else (key,)
        if not all(isinstance(k, (numbers.Integral, slice)) for k in parts):
            raise MXNetError("NDArray index %r: only ints and slices are "
                             "ported" % (key,))
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._t[key], self._ctx)

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    # -- conversion / copies -----------------------------------------------
    def astype(self, dtype, copy=True) -> "NDArray":
        if not copy and torch_dtype(dtype) == self.dtype:
            return self
        return invoke("Cast", [self], {"dtype": dtype})

    def as_in_context(self, ctx: Context) -> "NDArray":
        ctx = Context(ctx)
        if ctx == self._ctx:
            return self
        return NDArray(self._t.to(ctx.torch_device, copy=True), ctx)

    # -- autograd ----------------------------------------------------------
    @property
    def grad(self) -> Optional["NDArray"]:
        autograd.flush_all_pending()
        return self._grad

    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make this array a variable with a zero ``.grad`` of its
        shape and dtype."""
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._t.detach()), self._ctx)],
            grad_req)

    def detach(self) -> "NDArray":
        return NDArray(self._t.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def zero_grad(self):
        if self._grad is not None:
            self._grad.tensor().zero_()

    # -- reductions --------------------------------------------------------
    def sum(self, axis=None, keepdims=False):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    # -- arithmetic --------------------------------------------------------
    def __neg__(self): return invoke("negative", [self], {})

    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            return invoke(op, [lhs, rhs], {})
        if isinstance(other, numbers.Number):
            name = scalar_op
            if reverse and op in ("broadcast_sub", "broadcast_div"):
                name = "_r" + scalar_op[1:]
            return invoke(name, [self], {"scalar": float(other)})
        if isinstance(other, np.ndarray):
            return self._binop(array(other, ctx=self._ctx, dtype=self.dtype),
                               op, scalar_op, reverse)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar", True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar", True)


def to_tensor(x) -> Optional[torch.Tensor]:
    """The tensor of an NDArray (tensors and None pass through)."""
    return x._t if isinstance(x, NDArray) else x


def invoke(op: Union[str, Operator], inputs: Sequence, attrs: dict):
    """Run one registered op on NDArrays; returns an NDArray, or a tuple
    of them for a multi-output op."""
    if isinstance(op, str):
        op = get_op(op)
    _note(op)
    tensors = [to_tensor(x) for x in inputs]
    if op.needs_train_flag:
        attrs = dict(attrs, _train=autograd.is_training())
    # a graph is built only inside autograd.record(); the grad mode is
    # switched only where it differs (the switch costs host time per op)
    recording = autograd.is_recording()
    if torch.is_grad_enabled() == recording:
        out = op.impl(*tensors, **attrs)
    else:
        with torch.set_grad_enabled(recording):
            out = op.impl(*tensors, **attrs)
    if op.mutate_aux:
        # FMutateInputs: the mutated outputs go back into their input
        # arrays (in place, off the tape) and leave the visible outputs
        outs = list(out)
        with torch.no_grad():
            for extra_idx, in_idx in op.mutate_aux.items():
                new, dst = outs[extra_idx], tensors[in_idx]
                if new is not dst:
                    dst.copy_(new)
        out = [o for i, o in enumerate(outs) if i not in op.mutate_aux]
        if len(out) == 1:
            out = out[0]
    if isinstance(out, (tuple, list)):
        return tuple(NDArray(o) for o in out)
    return NDArray(out)


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (lists
    and float64 arrays default to float32, as in MXNet)."""
    ctx = Context(ctx or current_context())
    if isinstance(source_array, NDArray):
        t = source_array._t
    elif isinstance(source_array, torch.Tensor):
        t = source_array
    else:
        was_np = isinstance(source_array, np.ndarray)
        arr = np.asarray(source_array)
        if dtype is None and (not was_np or arr.dtype == np.float64):
            arr = arr.astype(np.float32)
        t = host_tensor(arr)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t.to(ctx.torch_device, copy=True), ctx)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor from a numpy array, bfloat16 arrays (ml_dtypes)
    included."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def zeros(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    ctx = Context(ctx or current_context())
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype),
                               device=ctx.torch_device), ctx)


def ones(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    ctx = Context(ctx or current_context())
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.ones(shape, dtype=torch_dtype(dtype),
                              device=ctx.torch_device), ctx)
