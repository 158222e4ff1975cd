"""Gluon Parameter / ParameterDict, the subset serving and training
need (counterpart of ``mxnet_tpu/gluon/parameter.py``; ref:
python/mxnet/gluon/parameter.py).

A Parameter holds one NDArray per context, with deferred shapes
completed by the first forward, ``initialize``, ``set_data`` and
``cast``. Unless ``grad_req`` is ``'null'`` each data array is an
autograd variable (:func:`mxnet_tpu_torch.autograd.mark_variables`) with
a gradient array of its shape and dtype, which ``backward`` writes
(``'write'``) or adds into (``'add'``). Writes to the data
(``set_data``, the optimizer) go into the same tensor under
``torch.no_grad``, so the autograd leaf stays the same object, and a
captured graph that reads the parameter in place sees them.

Reading a gradient (``grad``, ``list_grad``) first runs a backward that
an armed Trainer deferred (:func:`mxnet_tpu_torch.autograd.
flush_all_pending`). Inside a hybridized block's call,
:func:`substitute` makes ``data`` return the CachedOp's stand-ins.
``ParameterDict.save``/``load`` write and read the parameters by name
in the reference's NDArray file format (``nd.save``).
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, current_context
from .. import autograd
from .. import initializer as init_mod
from .. import ndarray as nd
from ..ndarray import NDArray, array, zeros

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's shape is still unknown (ref: same name)."""


def _shape_complete(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


_SUBST = threading.local()


@contextlib.contextmanager
def substitute(mapping: Optional[Dict["Parameter", NDArray]]):
    """Inside the scope, ``data()`` of a Parameter in ``mapping``
    returns its NDArray there (a CachedOp's aliases of the parameters,
    so its one tape node or graph owns every read); None changes
    nothing."""
    old = getattr(_SUBST, "map", None)
    _SUBST.map = mapping if mapping is not None else old
    try:
        yield
    finally:
        _SUBST.map = old


class Parameter:
    def __init__(self, name: str, grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        # an auxiliary state (BatchNorm's moving statistics): updated by
        # its op through mutate_aux, never by the Trainer
        self._is_aux = False
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._data: Optional["OrderedDict[Context, NDArray]"] = None
        self._grad: Optional["OrderedDict[Context, NDArray]"] = None
        self._deferred_init = None

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._data is None:
            return
        if self._grad is None or req == "null":
            self._init_grad()
        else:
            autograd.mark_variables(list(self._data.values()),
                                    list(self._grad.values()), req)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        if len(self._shape) != len(new_shape) or not all(
                s in (0, ns) for s, ns in zip(self._shape, new_shape)):
            raise MXNetError(
                "Expected shape %s is incompatible with given shape %s for "
                "%s" % (self._shape, tuple(new_shape), self.name))
        self._shape = tuple(new_shape)

    # ------------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = default_init if self.init is None else self.init
        if not _shape_complete(self._shape):
            if self._allow_deferred_init:
                self._deferred_init = (init, list(ctx), default_init)
                return
            raise ValueError(
                "Cannot initialize Parameter %s: unknown shape %s and "
                "deferred init not allowed" % (self.name, self._shape))
        self._init_impl(init, ctx)

    def _init_impl(self, init, ctx_list):
        self._deferred_init = None
        data = zeros(self._shape, ctx=ctx_list[0], dtype=self.dtype)
        init_mod.create(init)(self.name, data)
        self._data = OrderedDict((c, data.as_in_context(c))
                                 for c in ctx_list)
        self._init_grad()

    def _init_grad(self):
        """A zero gradient array per context, each data array marked as
        a variable (none for ``grad_req='null'``)."""
        if self._grad_req == "null":
            self._grad = None
            autograd.mark_variables(list(self._data.values()),
                                    [None] * len(self._data), "null")
            return
        self._grad = OrderedDict(
            (c, zeros(d.shape, ctx=c, dtype=d.dtype))
            for c, d in self._data.items())
        autograd.mark_variables(list(self._data.values()),
                                list(self._grad.values()), self._grad_req)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_complete(self._shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s" % (self.name, self._shape))
        init, ctx, default_init = self._deferred_init
        self._init_impl(init if init is not None else default_init, ctx)

    # ------------------------------------------------------------------
    def _check_initialized(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s deferred (shape %s unknown)"
                    % (self.name, self._shape))
            raise RuntimeError(
                "Parameter %s has not been initialized. Call initialize() "
                "first" % self.name)
        if ctx is not None and ctx not in self._data:
            raise RuntimeError(
                "Parameter %s not initialized on context %s (has %s)"
                % (self.name, ctx, list(self._data)))

    def data(self, ctx: Optional[Context] = None) -> NDArray:
        sub = getattr(_SUBST, "map", None)
        if sub is not None:
            got = sub.get(self)
            if got is not None:
                return got
        if ctx is None:
            self._check_initialized()
            return next(iter(self._data.values()))
        self._check_initialized(ctx)
        return self._data[ctx]

    def list_data(self) -> List[NDArray]:
        self._check_initialized()
        return list(self._data.values())

    def grad(self, ctx: Optional[Context] = None) -> NDArray:
        autograd.flush_all_pending()
        if self._grad is None:
            raise RuntimeError("Parameter %s grad_req='null'" % self.name)
        if ctx is None:
            return next(iter(self._grad.values()))
        return self._grad[ctx]

    def list_grad(self) -> List[NDArray]:
        autograd.flush_all_pending()
        if self._grad is None:
            raise RuntimeError("Parameter %s grad_req='null'" % self.name)
        return list(self._grad.values())

    def zero_grad(self):
        if self._grad is not None:
            for g in self._grad.values():
                g.tensor().zero_()

    def list_ctx(self) -> List[Context]:
        self._check_initialized()
        return list(self._data.keys())

    def set_data(self, data):
        """Copy ``data`` (NDArray, tensor or numpy array) into every
        context's copy, converted to this parameter's dtype; the arrays
        keep their storage."""
        self.shape = tuple(data.shape)
        if self._data is None:
            if self._deferred_init is None:
                raise RuntimeError("Parameter %s not initialized" % self.name)
            self._shape = tuple(data.shape)
            self._finish_deferred_init()
        if isinstance(data, NDArray):
            src = data.tensor()
        elif isinstance(data, torch.Tensor):
            src = data
        else:
            src = array(data, ctx=cpu(), dtype=self.dtype).tensor()
        with torch.no_grad():
            for d in self._data.values():
                d.tensor().copy_(src.detach())

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a Context or a list of them),
        with fresh zero gradients (ref: reset_ctx). On the contexts it
        already has, nothing moves: the gradients are zeroed in place,
        so graphs that read the arrays stay valid."""
        ctx = [ctx] if isinstance(ctx, Context) else list(ctx)
        if self._data is not None:
            if list(self._data) == ctx:
                self.zero_grad()
                return
            data = next(iter(self._data.values()))
            self._data = OrderedDict((c, data.copyto(c)) for c in ctx)
            self._init_grad()
        elif self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def _load(self, data, ctx_list: List[Context]):
        """Take ``data`` as this parameter's value on ``ctx_list``
        without running an initializer (the weight carry)."""
        self.shape = tuple(data.shape)
        self._deferred_init = None
        self._data = OrderedDict(
            (c, array(data, ctx=c, dtype=self.dtype)) for c in ctx_list)
        self._init_grad()

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is None:
            return
        td = torch_dtype(dtype)
        self._data = OrderedDict((c, NDArray(d.tensor().detach().to(td), c))
                                 for c, d in self._data.items())
        self._init_grad()


class ParameterDict:
    """Prefix-scoped parameter dictionary (ref: ParameterDict)."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "%s(" % (self._prefix + " " if self._prefix else "")
        s += "\n  ".join(str(p) for p in self._params.values())
        return s + ")"

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs) -> Parameter:
        """Get-or-create, with attribute reconciliation (ref: get)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if v is None:
                    continue
                if k == "shape":
                    existing = param._shape
                    if existing is not None and len(existing) == len(tuple(v)):
                        param._shape = tuple(
                            e if e != 0 else n
                            for e, n in zip(existing, tuple(v)))
                    else:
                        param._shape = tuple(v)
                elif getattr(param, k, None) in (None, "write", 1.0):
                    setattr(param, k, v)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update with conflicting Parameter %s"
                                 % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        init = init if init is not None else init_mod.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        """Set an attribute (e.g. ``grad_req``) on every parameter."""
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def list_ctx(self):
        s = set()
        for p in self.values():
            if p._data is not None:
                s.update(p.list_ctx())
        return list(s)

    def save(self, fname, strip_prefix=""):
        """``nd.save`` of every parameter by name, ``strip_prefix`` cut
        from each (ref: ParameterDict.save)."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError("Parameter %s does not start with prefix %s"
                                 % (param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd.save(fname, arg_dict)

    def load(self, fname, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        """Set every parameter from ``fname``, its names given
        ``restore_prefix`` (ref: ParameterDict.load); with ``ctx`` the
        parameters move there first."""
        arg_dict = nd.load(fname, ctx=cpu())
        if restore_prefix:
            arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise AssertionError("Parameter %s missing in file %s"
                                         % (name, fname))
        for name, data in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError("Parameter %s in file %s is unknown"
                                     % (name, fname))
                continue
            if ctx is not None:
                self._params[name].reset_ctx(ctx)
            self._params[name].set_data(data)
