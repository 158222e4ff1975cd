"""NDArray — a thin handle over a ``torch.Tensor`` (counterpart of
``mxnet_tpu/ndarray/ndarray.py``; ref: python/mxnet/ndarray/ndarray.py).

The tensor lives on the device of the array's Context. Arithmetic
dispatches through the op registry, as in the reference, so the ops a
forward runs are the registered ones. ``dtype`` is a numpy dtype, as in
the reference (bfloat16 as ``ml_dtypes.bfloat16``); the port's own code
reads the torch dtype through ``_tdtype``. ``asnumpy()`` of a bfloat16
array returns float32 values, which are exactly the bfloat16 values.

Writes go into the array: ``a += b`` and ``a[key] = v`` change the
tensor in place (a Parameter's ``data()`` and every view of it see
them); inside ``autograd.record()`` an array on the tape is rebound to
the recorded result instead, as the reference keeps its tape in SSA
form, and a variable itself (``attach_grad``) refuses the write.
``==``, ``<`` and the rest are elementwise and return 0/1 arrays in the
input's dtype; the hash stays the identity's.

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
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, context_of, current_context
from ..ops import Operator, _note, get_op

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "to_tensor",
           "host_tensor", "host_numpy", "host_copies", "concatenate",
           "waitall"]


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
    def dtype(self) -> np.dtype:
        return np_dtype(self._t.dtype)

    @property
    def _tdtype(self) -> torch.dtype:
        """The tensor's torch dtype (what the port's own code compares)."""
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

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return invoke("transpose", [self], {})

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

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def wait_to_read(self):
        """Block until the values are computed: a no-op on the host, a
        sync of the array's stream on the card."""
        if self._t.is_cuda:
            torch.cuda.current_stream(self._t.device).synchronize()

    def __len__(self):
        if not self._t.dim():
            raise TypeError("len() of unsized object")
        return self._t.shape[0]

    def __reduce__(self):
        # pickle through the host in the array's own dtype, as the
        # reference does
        return (_unpickle, (host_numpy(self._t.detach().cpu()),
                            self._ctx.device_type, self._ctx.device_id))

    # -- indexing ------------------------------------------------------------
    @property
    def _in_graph(self) -> bool:
        return self._t.requires_grad

    def _index(self, key):
        """``key`` with NDArrays, lists and numpy arrays as index
        tensors on this array's device (bool masks stay masks)."""
        if isinstance(key, tuple):
            return tuple(self._index(k) for k in key)
        if isinstance(key, NDArray):
            key = key.asnumpy()
        if isinstance(key, (list, np.ndarray)):
            arr = np.asarray(key)
            if arr.dtype != np.bool_:
                arr = arr.astype(np.int64)
            return torch.from_numpy(arr).to(self._t.device)
        return key

    def __getitem__(self, key) -> "NDArray":
        """Basic indexing (ints, slices, None, ``...``) gives a view;
        an NDArray, list or numpy array indexes as numpy does (a copy).
        Inside ``autograd.record()`` both are recorded."""
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._t[self._index(key)], self._ctx)

    def _value(self, value) -> torch.Tensor:
        if isinstance(value, NDArray):
            return value._t.to(self._t.dtype)
        return torch.as_tensor(np.asarray(value), dtype=self._t.dtype,
                               device=self._t.device)

    def _check_writable(self):
        if self._t.is_leaf and self._t.requires_grad and \
                autograd.is_recording():
            raise MXNetError(
                "in-place modification of an array with attach_grad() "
                "while recording is not supported (it would overwrite the "
                "leaf the gradient belongs to); use autograd.pause() or "
                "an out-of-place op")

    def __setitem__(self, key, value):
        """Write ``value`` into the indexed region (ref: ndarray.py
        ``__setitem__``): in place, or as a recorded assignment on a
        copy that this array is rebound to inside ``record()``."""
        key = self._index(key)
        if autograd.is_recording() and (self._in_graph or (
                isinstance(value, NDArray) and value._in_graph)):
            self._check_writable()
            out = self._t.clone()
            out[key] = self._value(value)
            self._t = out
            return
        with torch.no_grad():
            self._t[key] = self._value(value)

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    # -- conversion / copies -----------------------------------------------
    def astype(self, dtype, copy=True) -> "NDArray":
        if not copy and torch_dtype(dtype) == self._t.dtype:
            return self
        return invoke("Cast", [self], {"dtype": dtype})

    def astype_like(self, other) -> "NDArray":
        return self.astype(other._tdtype)

    def copy(self) -> "NDArray":
        return self.copyto(self._ctx)

    def copyto(self, other) -> "NDArray":
        """A copy on a context, or written into the NDArray ``other``
        (which takes this array's shape and dtype, as in the
        reference)."""
        if isinstance(other, NDArray):
            src = self._t.detach()
            if src.shape == other._t.shape and src.dtype == other._t.dtype:
                with torch.no_grad():
                    other._t.copy_(src)
            else:
                other._t = src.to(other._t.device, copy=True)
            return other
        ctx = Context(other)
        return NDArray(ctx.place(self._t.detach()), ctx)

    def as_in_context(self, ctx: Context) -> "NDArray":
        ctx = Context(ctx)
        if ctx == self._ctx:
            return self
        return NDArray(ctx.place(self._t), ctx)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self) -> "NDArray":
        return self

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

    # -- arithmetic --------------------------------------------------------
    def __neg__(self): return invoke("negative", [self], {})
    def __abs__(self): return invoke("abs", [self], {})

    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            return invoke(op, [lhs, rhs], {})
        if isinstance(other, numbers.Number):
            name = scalar_op
            if reverse and op in ("broadcast_sub", "broadcast_div",
                                  "broadcast_power", "broadcast_mod"):
                name = "_r" + scalar_op[1:]
            return invoke(name, [self], {"scalar": float(other)})
        if isinstance(other, np.ndarray):
            return self._binop(array(other, ctx=self._ctx, dtype=self._tdtype),
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
    def __mod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar", True)

    # -- comparisons: elementwise 0/1 in the input's dtype -------------------
    def _cmp(self, other, op, scalar_op):
        if isinstance(other, NDArray):
            return invoke(op, [self, other], {})
        if isinstance(other, numbers.Number):
            return invoke(scalar_op, [self], {"scalar": float(other)})
        if other is None:
            return False
        return NotImplemented

    def __eq__(self, o): return self._cmp(o, "broadcast_equal", "_equal_scalar")
    def __ne__(self, o): return self._cmp(o, "broadcast_not_equal", "_not_equal_scalar")
    def __gt__(self, o): return self._cmp(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._cmp(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._cmp(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._cmp(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__  # identity hash despite elementwise __eq__

    # -- in place (ref: ndarray.py :: _iop) ----------------------------------
    def _iop(self, o, op, scalar_op):
        """``self op= o``: the result is written into this array's
        tensor; inside ``record()`` an array on the tape is rebound to
        the recorded result (a write into a tensor the tape saved would
        corrupt its backward), as the reference rebinds its buffer."""
        r = self._binop(o, op, scalar_op)
        if r is NotImplemented:
            return r
        if autograd.is_recording() and r._t.requires_grad:
            self._check_writable()
            self._t = r._t
        elif r._t.shape == self._t.shape and r._t.dtype == self._t.dtype:
            with torch.no_grad():
                self._t.copy_(r._t)
        else:
            # promoted or broadcast past this array: rebound, as the
            # reference's write rebinds its buffer to the result
            self._t = r._t
        return self

    def __iadd__(self, o): return self._iop(o, "broadcast_add", "_plus_scalar")
    def __isub__(self, o): return self._iop(o, "broadcast_sub", "_minus_scalar")
    def __imul__(self, o): return self._iop(o, "broadcast_mul", "_mul_scalar")
    def __itruediv__(self, o): return self._iop(o, "broadcast_div", "_div_scalar")

    # -- fluent methods (the reference's subset) -----------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return invoke("Reshape", [self], {
            "shape": tuple(shape), "reverse": kwargs.get("reverse", False)})

    def reshape_like(self, other):
        return invoke("reshape_like", [self, other], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": axes if axes else None})

    def flatten(self):
        return invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def _reduce(self, name, axis, keepdims):
        return invoke(name, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", [self], {"ord": ord, "axis": axis,
                                       "keepdims": keepdims})

    def abs(self): return invoke("abs", [self], {})
    def sqrt(self): return invoke("sqrt", [self], {})
    def square(self): return invoke("square", [self], {})
    def exp(self): return invoke("exp", [self], {})
    def log(self): return invoke("log", [self], {})
    def relu(self): return invoke("relu", [self], {})
    def sigmoid(self): return invoke("sigmoid", [self], {})
    def tanh(self): return invoke("tanh", [self], {})

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def clip(self, a_min, a_max):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                             "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", [self], dict(depth=depth, **kw))

    def tile(self, reps):
        return invoke("tile", [self], {"reps": reps})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": shape})

    def zeros_like(self):
        return invoke("zeros_like", [self], {})

    def ones_like(self):
        return invoke("ones_like", [self], {})


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


def _unpickle(arr, devtype, devid):
    return array(arr, ctx=Context(devtype, devid))


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
    return NDArray(ctx.place(t), ctx)


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor from a numpy array, bfloat16 arrays (ml_dtypes)
    included."""
    # ascontiguousarray alone would make a 0-d array 1-d
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """The numpy array sharing a CPU tensor's memory, in its dtype
    (bfloat16 as ``ml_dtypes.bfloat16``)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np_dtype(torch.bfloat16))
    return t.numpy()


def host_copies(tensors: Sequence[torch.Tensor]) -> list:
    """CPU tensors holding the values of ``tensors``: a card's tensors
    copied into page-locked memory asynchronously, then one wait for
    each card they lie on; a CPU tensor is returned as it is."""
    out, devices = [], set()
    for t in tensors:
        t = t.detach()
        if t.device.type == "cpu":
            out.append(t)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
        devices.add(t.device)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()
    return out


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


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return invoke("Concat", list(arrays), {"dim": axis})


def waitall():
    """Wait for all queued work: a synchronise of every card, a no-op
    on the host (ref: MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
