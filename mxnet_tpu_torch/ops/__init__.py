"""Operator registry and the ``F`` namespace (counterpart of
``mxnet_tpu/ops/__init__.py``; ref: the NNVM op registry).

Every op is a torch function ``impl(*tensors, **attrs) -> tensor |
tuple`` registered under its MXNet name. One registration serves the
eager ``mx.nd.*`` namespace and the ``F`` that ``hybrid_forward``
receives; there is no Symbol tracing in the port yet, so ``F`` is
always this op namespace. A few entries work on NDArrays and run Python
rather than one torch function (``Custom``, from :mod:`..operator`):
they are added with :func:`register_ndarray_fn` and reached through the
same ``F``. Ops that the reference backs with a Pallas
kernel call the hand-written CUDA kernels of ``cuda_norm``,
``cuda_attention``, ``cuda_epilogue`` and ``cuda_dropout``; the fused
ResNet bottleneck functions of ``cuda_fused`` are called directly, as
the reference's ``pallas_fused`` is.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Set

from ..base import MXNetError

__all__ = ["Operator", "register", "get_op", "recording", "last_op", "F",
           "register_ndarray_fn", "set_casts"]

_OPS: Dict[str, "Operator"] = {}
_ALIASES: Dict[str, str] = {}
# F entries that take and return NDArrays themselves (nd.Custom)
_ND_FNS: Dict[str, Callable] = {}
# AMP's cast table (contrib.amp.init): name as called through F/nd ->
# fn(inputs, attrs) -> (inputs, attrs) with the NDArray inputs cast
_CASTS: Dict[str, Callable] = {}
# what the cast table casts (None: nothing), part of a captured graph's
# key: its casts are those it was captured under
_CASTS_KEY = [None]


class Operator:
    """A registered operator.

    needs_rng : the reference draws random bits for this op (ref:
        ResourceRequest::kRandom). The port keeps the flag because the
        serving session's unpad rule reads it.
    needs_train_flag : impl takes a ``_train`` bool attr from
        :func:`mxnet_tpu_torch.autograd.is_training`.
    mutate_aux : mapping extra-output-index -> input-index; ``invoke``
        writes those outputs back into their input arrays and drops them
        from the visible outputs (ref: FMutateInputs; BatchNorm's moving
        statistics).
    """

    def __init__(self, name: str, impl: Callable, needs_rng: bool = False,
                 needs_train_flag: bool = False,
                 mutate_aux: Optional[Dict[int, int]] = None):
        self.name = name
        self.impl = impl
        self.needs_rng = needs_rng
        self.needs_train_flag = needs_train_flag
        self.mutate_aux = mutate_aux or {}
        self.__doc__ = impl.__doc__

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name: str, aliases: Sequence[str] = (), **opattrs) -> Callable:
    """Decorator registering a torch impl as an operator."""
    def _reg(fn):
        if name in _OPS:
            raise MXNetError("operator %r already registered" % name)
        _OPS[name] = Operator(name, fn, **opattrs)
        for a in aliases:
            _ALIASES[a] = name
        if name.lower() != name and name.lower() not in _ALIASES:
            _ALIASES[name.lower()] = name
        return fn
    return _reg


def get_op(name: str) -> Operator:
    op = _OPS.get(name)
    if op is None:
        canon = _ALIASES.get(name)
        if canon is not None:
            op = _OPS.get(canon)
    if op is None:
        raise MXNetError("unknown operator %r" % name)
    return op


# ---------------------------------------------------------------------------
# which ops a forward ran (the serving session reads needs_rng from it)
# ---------------------------------------------------------------------------
_rec = threading.local()


@contextlib.contextmanager
def recording():
    """Collect the Operators invoked on this thread inside the scope."""
    seen: Set[Operator] = set()
    old = getattr(_rec, "seen", None)
    _rec.seen = seen
    try:
        yield seen
    finally:
        _rec.seen = old


def _note(op: Operator):
    _rec.last = op.name
    seen = getattr(_rec, "seen", None)
    if seen is not None:
        seen.add(op)


def last_op(reset: bool = False) -> Optional[str]:
    """The name of the op this thread invoked last (a failed graph
    capture names it); ``reset`` forgets it."""
    name = getattr(_rec, "last", None)
    if reset:
        _rec.last = None
    return name


def register_ndarray_fn(name: str, fn: Callable):
    """Expose ``fn``, which takes and returns NDArrays, as ``F.<name>``
    and ``nd.<name>``."""
    if name in _ND_FNS or name in _OPS or name in _ALIASES:
        raise MXNetError("operator %r already registered" % name)
    _ND_FNS[name] = fn


def set_casts(table: Dict[str, Callable], key=None):
    """Install (or, with ``{}``, clear) the cast table that calls
    through ``F``/``nd`` consult: AMP's op lists. Only these namespace
    calls are cast, as the reference's patched ``nd`` module casts
    them; NDArray operators go to ``invoke`` directly and are not."""
    _CASTS.clear()
    _CASTS.update(table)
    # ``key`` (hashable) names what the table does, so that a table
    # installed again keeps the graphs captured under it
    _CASTS_KEY[0] = None if not table else \
        (key if key is not None else object())


class _OpNamespace:
    """``F.<op>(*inputs, **attrs)`` over NDArrays, for every registered
    op and NDArray-level entry (what ``hybrid_forward`` receives as
    ``F``)."""

    def __getattr__(self, name):
        fn = _ND_FNS.get(name)
        if fn is not None:
            return fn
        if name not in _OPS and name not in _ALIASES:
            raise AttributeError("no operator named %r" % name)
        op = get_op(name)
        cast = _CASTS.get(name)

        def call(*inputs, **attrs):
            from ..ndarray.ndarray import invoke
            if cast is not None:
                inputs, attrs = cast(inputs, attrs)
            return invoke(op, inputs, attrs)
        call.__name__ = name
        call.__doc__ = op.__doc__
        return call


F = _OpNamespace()

# op modules, imported for their registrations
from . import elemwise      # noqa: E402,F401
from . import matrix        # noqa: E402,F401
from . import nn            # noqa: E402,F401
from . import contrib_ops   # noqa: E402,F401
from . import reduce_ops    # noqa: E402,F401
from . import optimizer_ops  # noqa: E402,F401
from . import rnn_ops       # noqa: E402,F401
from . import image_ops     # noqa: E402,F401
