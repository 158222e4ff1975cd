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

Deferred arrays (ref: the ``_pending`` marker): while a K-step chunk
buffers (:mod:`mxnet_tpu_torch.scan`) a hybridized call returns arrays
whose values a later function will produce, and ``nd.Custom`` returns
arrays whose values an op on the native dependency engine will write
(:class:`mxnet_tpu_torch.engine.EngineGate`). Such an array carries
``_pending``, (its step or gate, slot, meta); its tensor is already of
the right shape, dtype and device, so ``shape`` and the like read
without waiting, but any read of its values (``tensor()``, ``asnumpy``,
``wait_to_read``, an op that takes it, an in-place write) forces the
step, or waits for the engine op and re-raises its error, first. An
in-place write to an array that a pending engine op still reads
(``_read_pins``) waits for that op first (write after read).

Under ``MXNET_ENGINE_TYPE=NaiveEngine`` every registry op's output and
every new array goes through ``engine().on_dispatch``, which
synchronises the card's stream.

With telemetry on, every array made counts its tensor's storage in the
live-bytes totals of its context (``telemetry.ndarray_live``) until it
is collected; arrays that share a storage (a detach, a view, a graph's
alias) count its bytes once.
"""
from __future__ import annotations

import numbers
import weakref
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, context_of, current_context
from ..ops import Operator, _note, get_op
from .. import engine as _engine
from .. import telemetry as _telemetry
from ..symbol import layout_opt as _layout_opt

# the cached telemetry gate, read once an array
_TSTATE = _telemetry._STATE

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "empty",
           "to_tensor", "host_tensor", "host_numpy", "host_copies",
           "concatenate", "waitall"]


class NDArray:
    """A device-resident array."""

    __slots__ = ("_t", "_ctx", "_grad", "_grad_req", "_pending",
                 "_read_pins", "_mem", "__weakref__")

    # higher than numpy's so ndarray.__add__(NDArray) defers to us
    __array_priority__ = 1000.0

    def __init__(self, tensor: torch.Tensor, ctx: Optional[Context] = None):
        self._t = tensor
        self._ctx = ctx if ctx is not None else context_of(tensor.device)
        self._grad: Optional["NDArray"] = None
        self._grad_req = "null"
        self._pending = None
        self._read_pins = None
        self._mem = None
        if _TSTATE.on or (_TSTATE.on is None and _telemetry.enabled()):
            self._mem_track()

    def _mem_track(self):
        """Count this array's storage in the live-bytes totals until the
        array is collected (or rebound: :meth:`_rebind`)."""
        try:
            st = self._t.untyped_storage()
            box = _telemetry._ndarray_track(str(self._ctx), st.data_ptr(),
                                            st.nbytes())
        except Exception:
            return
        self._mem = weakref.finalize(self, _telemetry._ndarray_release, box)

    def _rebind(self, t: torch.Tensor):
        """Point the array at another tensor, its accounting moved."""
        self._t = t
        fin = self._mem
        if fin is not None:
            fin()
            self._mem = None
            self._mem_track()

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
        """The underlying ``torch.Tensor`` (shared, not copied); a
        deferred array's step is forced first."""
        p = self._pending      # an engine worker may clear it meanwhile
        if p is not None:
            p[0].force()
        return self._t

    # -- host transfer -----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A copy of the values on the host, bf16 widened to f32 on the
        device that holds them; one host copy on either device."""
        t = self.tensor().detach()
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
        """Block until the values are computed (``engine().wait_for_var``):
        a no-op on the host, a sync of the array's stream on the card."""
        _engine.engine().wait_for_var(self.tensor())

    def __len__(self):
        if not self._t.dim():
            raise TypeError("len() of unsized object")
        return self._t.shape[0]

    def __reduce__(self):
        # pickle through the host in the array's own dtype, as the
        # reference does
        return (_unpickle, (host_numpy(self.tensor().detach().cpu()),
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
        t = self.tensor()
        plan = _layout_opt.active()
        if plan is not None:
            plan.consumed("slice", {}, (t,))
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(t[self._index(key)], self._ctx)

    def _value(self, value) -> torch.Tensor:
        if isinstance(value, NDArray):
            return value.tensor().to(self._t.dtype)
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
        self.tensor()
        if self._read_pins:
            _engine.consume_read_pins(self)
        key = self._index(key)
        if autograd.is_recording() and (self._in_graph or (
                isinstance(value, NDArray) and value._in_graph)):
            self._check_writable()
            out = self._t.clone()
            out[key] = self._value(value)
            self._rebind(out)
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
            src = self.tensor().detach()
            if src.shape == other.tensor().shape and \
                    src.dtype == other._t.dtype:
                with torch.no_grad():
                    other._t.copy_(src)
            else:
                other._t = src.to(other._t.device, copy=True)
            return other
        ctx = Context(other)
        return NDArray(ctx.place(self.tensor().detach()), ctx)

    def as_in_context(self, ctx: Context) -> "NDArray":
        ctx = Context(ctx)
        if ctx == self._ctx:
            return self
        return NDArray(ctx.place(self.tensor()), ctx)

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
            [self], [NDArray(torch.zeros_like(self.tensor().detach()),
                             self._ctx)],
            grad_req)

    def detach(self) -> "NDArray":
        return NDArray(self.tensor().detach(), self._ctx)

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
        self.tensor()
        r = self._binop(o, op, scalar_op)
        if r is NotImplemented:
            return r
        if self._read_pins:
            _engine.consume_read_pins(self)
        if autograd.is_recording() and r._t.requires_grad:
            self._check_writable()
            self._rebind(r._t)
        elif r._t.shape == self._t.shape and r._t.dtype == self._t.dtype:
            with torch.no_grad():
                self._t.copy_(r._t)
        else:
            # promoted or broadcast past this array: rebound, as the
            # reference's write rebinds its buffer to the result
            self._rebind(r._t)
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
    return x.tensor() if isinstance(x, NDArray) else x


def invoke(op: Union[str, Operator], inputs: Sequence, attrs: dict):
    """Run one registered op on NDArrays; returns an NDArray, or a tuple
    of them for a multi-output op."""
    if isinstance(op, str):
        op = get_op(op)
    _note(op)
    tensors = [to_tensor(x) for x in inputs]
    plan = _layout_opt.active()
    if plan is not None:
        # a hybridized forward's conv-bias elision counts consumers
        plan.consumed(op.name, attrs, tensors)
    ctx = out_ctx = None
    if "ctx" in attrs:
        # the reference's ctx keyword: an op with inputs runs where they
        # lie and ignores it
        attrs = dict(attrs)
        ctx = attrs.pop("ctx")
    if op.needs_device:
        # a zero-input op: its device from ctx, else the current context
        out_ctx = Context(ctx or current_context())
        attrs = dict(attrs, _device=out_ctx.torch_device)
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
    if _engine._NAIVE[0]:
        _engine.engine().on_dispatch(out)
    if isinstance(out, (tuple, list)):
        return tuple(NDArray(o, out_ctx) for o in out)
    return NDArray(out, out_ctx)


def _unpickle(arr, devtype, devid):
    return array(arr, ctx=Context(devtype, devid))


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (lists
    and float64 arrays default to float32, as in MXNet)."""
    ctx = Context(ctx or current_context())
    if isinstance(source_array, NDArray):
        t = source_array.tensor()
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
    t = ctx.place(t)
    if _engine._NAIVE[0]:
        _engine.engine().on_dispatch(t)
    return NDArray(t, ctx)


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


def _create(name, shape, ctx, dtype) -> NDArray:
    """The creation op ``name``'s function called directly: the arrays
    the framework makes for itself (gradients, states, a clip's scale)
    are not op dispatches (``ops.recording`` does not see them)."""
    ctx = Context(ctx or current_context())
    t = get_op(name).impl(shape=shape, dtype=dtype, _device=ctx.torch_device)
    if _engine._NAIVE[0]:
        _engine.engine().on_dispatch(t)
    return NDArray(t, ctx)


def zeros(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    """The ``_zeros`` op (``F.zeros``) with MXNet's positional order."""
    return _create("_zeros", shape, ctx, dtype)


def ones(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    """The ``_ones`` op (``F.ones``) with MXNet's positional order."""
    return _create("_ones", shape, ctx, dtype)


def empty(shape, ctx: Optional[Context] = None, dtype="float32") -> NDArray:
    """An array of ``shape``; its values are zeros, as the reference's
    are."""
    return _create("_zeros", shape, ctx, dtype)


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return invoke("Concat", list(arrays), {"dim": axis})


def waitall():
    """Wait for all queued work: a synchronise of every card, then the
    native engine's ops, whose first error not raised yet raises here
    (ref: MXNDArrayWaitAll)."""
    _engine.engine().wait_for_all()
