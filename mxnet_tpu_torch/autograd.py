"""Autograd: recording scopes and backward (counterpart of
``mxnet_tpu/autograd.py``; ref: python/mxnet/autograd.py).

The tape is torch's. Every op runs through
:func:`mxnet_tpu_torch.ndarray.invoke`, which builds a graph only inside
``record()`` (outside it the op runs under ``torch.no_grad``), so
nothing is recorded unless the caller asks. A variable is an NDArray
whose tensor is a torch leaf that requires grad, marked by
``attach_grad`` or :func:`mark_variables` (a Parameter marks its data).

:func:`backward` asks ``torch.autograd.grad`` for the gradient of every
live variable and then writes or adds it into the variable's ``.grad``
by its ``grad_req``, as the reference does; torch's own ``.grad``
accumulation is never used, so ``write`` overwrites and ``add`` adds.
A variable the heads do not reach keeps its ``.grad`` as it was.

Ops whose reference backward is a Pallas kernel are
``torch.autograd.Function``s whose backward is the port's kernel
(``ops/cuda_*.py``).

:func:`grad` returns the gradients instead of writing ``.grad``; with
``create_graph=True`` they are on the tape and can be differentiated
again. A user's :class:`Function` (and a ``CustomOp``, through
:func:`record_callback`) is a node whose backward calls Python: its
forward runs under :func:`pause`, its backward is called with NDArrays
over the incoming gradients, also under :func:`pause`. Such a node is
first-order only, as in the reference: differentiating through it with
``create_graph=True`` raises instead of returning a graph that lacks its
second derivative.

A hybridized block's call is one node of the tape
(:mod:`mxnet_tpu_torch.cached_op`). With ``MXNET_FUSED_BACKWARD`` on, a
:func:`backward` whose tape holds only such nodes runs as one plan (one
captured graph on the card). A Trainer that arms this module
(``MXNET_TRAINER_FUSED_UPDATE``) has the next such backward stashed
instead; its ``step`` runs the plan with the update appended. Reading a
gradient, or the next backward, runs a stashed plan without the update
first (:func:`flush_all_pending`), as the reference's fused-update
deferral does. Under ``MXNET_SCAN_STEPS`` the hybridized calls of a
step may return deferred arrays (:mod:`mxnet_tpu_torch.scan`):
``backward`` on their heads stashes the step for the Trainer's chunk
runner, and :func:`flush_all_pending` drains the buffered chunks
(registered by :func:`register_scan_flusher`) before the stashed plan.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

from .base import MXNetError
from .config import get as _cfg

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "mark_variables", "grad", "Function", "record_callback",
           "arm_fused_update", "disarm_fused_update", "take_pending_step",
           "flush_pending_step", "flush_all_pending",
           "register_scan_flusher", "flush_scan_chunks"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_rec: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(is_rec)
    return prev


def set_training(train_mode_: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(train_mode_)
    return prev


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec, self._train = recording, training

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with self.__class__(self._rec, self._train):
                return fn(*a, **kw)
        return wrapped


def record(train_mode: bool = True) -> _Scope:
    """Scope that records ops for :func:`backward` (train mode on by
    default)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    """Scope inside ``record()`` that records nothing."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


# every NDArray marked as a variable and still alive, by id: a WeakSet
# would compare two references to one array with its elementwise ``==``
_VARS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each of ``variables`` a leaf whose gradient goes to the
    matching NDArray of ``gradients`` (ref: autograd.mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        v._t = v.tensor().detach().requires_grad_(req != "null")
        v._grad = g
        v._grad_req = req
        if req == "null":
            _VARS.pop(id(v), None)
        else:
            _VARS[id(v)] = v


def _heads(heads, head_grads):
    """The head tensors and their cotangents: a head gradient left out
    is ones of the head's shape, as in MXNet, whatever the head's size."""
    from .ndarray.ndarray import NDArray, to_tensor
    heads = [heads] if isinstance(heads, NDArray) else list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, cots = [], []
    for h, hg in zip(heads, head_grads):
        t = h.tensor()
        if not t.requires_grad:
            raise MXNetError(
                "cannot differentiate: output was not computed under "
                "autograd.record() from any array with attach_grad()")
        outs.append(t)
        cots.append(torch.ones_like(t) if hg is None
                    else to_tensor(hg).to(t.dtype))
    return outs, cots


# ---------------------------------------------------------------------------
# fused-update deferral (MXNET_TRAINER_FUSED_UPDATE; reference
# autograd.py's _PENDING machinery). An armed Trainer has the next
# backward() over a tape of hybridized calls stashed as a plan; its step()
# runs the plan with the SGD update appended, as one captured graph on the
# card. Anything that needs the gradients before step() runs the plan
# without the update first. The captured runners live with their owners
# (cached_op._Plan.run), not here.
# ---------------------------------------------------------------------------
_ARM_TOKEN = [None]
_ARM_LEAF_IDS = [frozenset()]
_PENDING = [None]
# the K-step scan layer (scan.py): the drains of its buffered chunks,
# its hook that stashes a backward over deferred heads, and the plan of
# the last fused backward (the template an arming step leaves behind)
_SCAN_FLUSHERS: list = []
_SCAN_STASH = [None]
_LAST_PLAN = [None]


class _PendingStep:
    """A stashed plan (:class:`cached_op._Plan`) and the Trainer that
    owns it. ``execute()`` writes the gradients; ``execute_with_update``
    also applies ``update()``, the device part of the optimizer step,
    whose math and tensors ``upd_key`` names, through the runner kept in
    ``runners`` (the optimizer's own dict)."""

    __slots__ = ("plan", "token")

    def __init__(self, plan, token):
        self.plan, self.token = plan, token

    @property
    def leaf_ids(self):
        return self.plan.leaf_ids

    def execute(self):
        self.plan.run()

    def execute_with_update(self, runners, upd_key, update):
        self.plan.run(runners, upd_key, update)


def arm_fused_update(token, leaf_ids=None):
    """Arm deferral: the next backward() over a tape of hybridized calls
    whose variables cover ``leaf_ids`` (ids of the Trainer's parameter
    arrays) is stashed for ``token`` to consume at step(). One token at
    a time; arming replaces the previous owner."""
    _ARM_TOKEN[0] = token
    _ARM_LEAF_IDS[0] = frozenset(leaf_ids or ())


def disarm_fused_update(token=None):
    if token is None or _ARM_TOKEN[0] is token:
        _ARM_TOKEN[0] = None
        _ARM_LEAF_IDS[0] = frozenset()


def take_pending_step(token):
    """Claim the stashed plan if it belongs to ``token``; None otherwise."""
    p = _PENDING[0]
    if p is not None and p.token is token:
        _PENDING[0] = None
        return p
    return None


def flush_pending_step():
    """Run any stashed plan without the update (gradients written). A
    cheap no-op when nothing is stashed."""
    p = _PENDING[0]
    if p is not None:
        _PENDING[0] = None
        p.execute()


def register_scan_flusher(cb):
    _SCAN_FLUSHERS.append(cb)


def flush_scan_chunks():
    """Drain every buffered K-step chunk (a cheap no-op when nothing is
    buffered)."""
    for cb in _SCAN_FLUSHERS:
        cb()


def flush_all_pending():
    """Everything a gradient reader needs run before the read: the
    buffered chunks first (they are older steps, whose updates
    ``Trainer.step`` already took), then the stashed plan."""
    flush_scan_chunks()
    flush_pending_step()


def last_plan():
    """The plan of the last fused backward under ``MXNET_SCAN_STEPS``
    above 1, taken once (a chunk runner's template)."""
    plan, _LAST_PLAN[0] = _LAST_PLAN[0], None
    return plan


def _fused_backward(outs, cots) -> bool:
    """Run or stash the one plan of a tape of hybridized calls; False
    when the tape holds another node."""
    from . import cached_op
    plan = cached_op.tape_plan(outs, cots, list(_VARS.values()))
    if plan is None:
        return False
    if _cfg("MXNET_SCAN_STEPS") > 1:
        _LAST_PLAN[0] = plan
    token = _ARM_TOKEN[0]
    if token is not None and _ARM_LEAF_IDS[0] <= plan.leaf_ids:
        _PENDING[0] = _PendingStep(plan, token)
    else:
        plan.run()
    return True


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into every reachable variable's ``.grad``
    (ref: autograd.backward). A head gradient left out is ones of the
    head's shape, as in MXNet, whatever the head's size."""
    stash = _SCAN_STASH[0]
    if stash is not None and not retain_graph and stash(heads, head_grads):
        return
    flush_all_pending()
    outs, cots = _heads(heads, head_grads)
    if not retain_graph and _cfg("MXNET_FUSED_BACKWARD") and \
            _fused_backward(outs, cots):
        return
    variables = [v for v in list(_VARS.values()) if v._t.requires_grad]
    if not variables:
        return
    from . import cached_op
    # hybridized calls' own backward graphs, captured on this thread
    # before the engine replays them
    cached_op.capture_pending_backwards()
    grads = torch.autograd.grad(outs, [v._t for v in variables], cots,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for v, g in zip(variables, grads):
            if g is None:
                continue
            if v._grad_req == "write":
                v._grad.tensor().copy_(g)
            else:
                v._grad.tensor().add_(g.to(v._grad._t.dtype))


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    as NDArrays instead of written into ``.grad`` (ref: autograd.grad);
    every variable's ``.grad`` and ``grad_req`` stay as they were. A
    variable the heads do not reach gets zeros. With ``create_graph``
    the gradients are recorded (when recording) and can be
    differentiated again."""
    from .ndarray.ndarray import NDArray
    flush_all_pending()
    outs, cots = _heads(heads, head_grads)
    variables = [variables] if isinstance(variables, NDArray) \
        else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    from . import cached_op
    cached_op.capture_pending_backwards()
    with torch.enable_grad() if create_graph else torch.no_grad():
        grads = torch.autograd.grad(
            outs, [v.tensor() for v in variables], cots,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    res = []
    for v, g in zip(variables, grads):
        if g is None:
            g = torch.zeros_like(v.tensor().detach())
        elif not (create_graph and is_recording()):
            g = g.detach()
        res.append(NDArray(g, v.context))
    return res


class _Callback(torch.autograd.Function):
    """A tape node whose forward and backward are Python callbacks:
    ``run_forward()`` returns the output tensors, ``run_backward(grads,
    outputs)`` one gradient tensor (or None) per input tensor. The
    outputs reach the backward through ``save_for_backward``, so the
    callbacks hold no reference to them (which would be a cycle through
    the node)."""

    @staticmethod
    def forward(ctx, run_forward, run_backward, *inputs):
        outs = tuple(run_forward())
        ctx.run_backward = run_backward
        ctx.save_for_backward(*outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise MXNetError(
                "create_graph=True through a custom autograd.Function or "
                "CustomOp node: its backward is first-order only")
        return (None, None) + tuple(ctx.run_backward(grads,
                                                     ctx.saved_tensors))


def record_callback(inputs, run_forward, run_backward):
    """Run ``run_forward()`` (output tensors) as one node of the tape
    over the NDArrays ``inputs``, with ``run_backward(grads, outputs)``
    as its backward; returns the output tensors. Outside ``record()``,
    or when no input is in the graph, the forward runs alone."""
    tensors = [a.tensor() for a in inputs]
    if not (is_recording() and any(t.requires_grad for t in tensors)):
        return tuple(run_forward())
    with torch.enable_grad():
        return _Callback.apply(run_forward, run_backward, *tensors)


class Function:
    """A differentiable function with a backward written by hand (ref:
    autograd.py :: Function). Subclass it, define ``forward(self,
    *inputs)`` and ``backward(self, *out_grads)`` on NDArrays, keep what
    the backward needs with :meth:`save_for_backward`, and call the
    instance."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *out_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        arrays = [i for i in inputs if isinstance(i, NDArray)]
        meta = {}

        def run_forward():
            with pause():
                outputs = self.forward(*inputs)
            meta["single"] = isinstance(outputs, NDArray)
            outs = [outputs] if meta["single"] else list(outputs)
            meta["ctx"] = [o.context for o in outs]
            return [o.tensor() for o in outs]

        def run_backward(grads, outputs):
            with pause():
                in_grads = self.backward(
                    *[NDArray(g, c) for g, c in zip(grads, meta["ctx"])])
            if isinstance(in_grads, NDArray):
                in_grads = (in_grads,)
            if len(in_grads) != len(arrays):
                raise MXNetError(
                    "%s.backward returned %d gradients for %d inputs"
                    % (type(self).__name__, len(in_grads), len(arrays)))
            return [None if g is None else g.tensor() for g in in_grads]

        outs = record_callback(arrays, run_forward, run_backward)
        res = [NDArray(t, c) for t, c in zip(outs, meta["ctx"])]
        return res[0] if meta["single"] else res
