"""CachedOp — the captured-graph path behind ``HybridBlock.hybridize()``
(counterpart of ``mxnet_tpu/cached_op.py``; ref: src/imperative/
cached_op.cc :: CachedOp::Forward/Backward, CachedOpConfig).

The reference turns a hybridized block into jitted XLA programs keyed by
mode and input avals. Here a program is a ``torch.cuda.CUDAGraph``, keyed
the same way: train or eval, recording or not, and each input's shape,
strides, dtype and whether it needs a gradient.

* On a CUDA input the first call of a signature runs the block's eager
  forward on a side stream (the warm-up: kernels built, library
  workspaces and algorithm choices made). An eval signature is captured
  right after it, a recording one at its next call; from then on each
  call copies the data inputs into the graph's static buffers, replays
  it and clones the outputs out (the next replay overwrites them). With
  ``static_alloc`` the graph reads the parameters' own tensors in place,
  so an in-place write (``set_data``, the optimizer) is seen by the next
  replay; without it the parameters are copied in like data. A graph
  that reads a parameter whose storage has moved (``cast``, a re-init)
  is dropped. Every signature keeps its graphs (``static_shape`` is the
  reference's memory-planning hint; a CUDA graph is one shape whatever
  the flag), and AMP's cast table is part of the key. A capture that
  fails raises :class:`MXNetError` naming the op that broke it; nothing
  falls back to eager on the card.
* On a CPU input the same object runs the same function eagerly, so the
  tests hold it to the reference.

Under ``autograd.record()`` one call is one tape node (:class:`_Node`).
Its forward runs the block over aliases of its inputs (tensors that share
their storage but not their version counters) and keeps the residuals of
that inner graph; its backward applies them, as the reference's
``_run_vjp`` does. On the card the forward is one captured graph over
static residuals, and the node's own backward is captured too, but only
before the first backward that runs node by node needs it
(:func:`capture_pending_backwards`): a tape plan never does. An instance
whose residuals a live tape still needs is not replayed again; the next
call captures another instance, up to :data:`MAX_INSTANCES` a signature.
A tape recorded on graphs that were released since (``cast``,
``hybridize``, a parameter's storage moved) raises in its backward.

:func:`tape_plan` turns a backward whose tape holds only such nodes into
one plan (``MXNET_FUSED_BACKWARD``): every node's backward and the
gradient write-back, with an optimizer's update appended when an armed
Trainer consumes it (:mod:`mxnet_tpu_torch.autograd`), run eagerly at its
first occurrence and as one captured graph after that. A plan's runner
belongs to the last node's graph instance, or with an update to the
optimizer (its staged hyperparameters are what the graph reads), so it
dies with either; releasing any instance it replays over closes it.

Under ``MXNET_SCAN_STEPS`` a recorded call first asks the chunk runner
(:mod:`mxnet_tpu_torch.scan`, through ``_DEFER``) whether it belongs to
the step being buffered; if so it returns deferred arrays and runs
nothing. A record carries its call (``_Rec.call``, ``_Rec.meta``), from
which the runner replays a step's calls inside its chunk graph. The
reference's symbol plumbing (``_COP_SYMS``, ``get_symbol``) has no
counterpart: the port traces no Symbol graph.

With ``MXNET_LAYOUT_OPT`` on (the default), the block's forward runs
under the reference's two graph passes, applied op by op
(:mod:`mxnet_tpu_torch.symbol.layout_opt`): 2-D ungrouped convolutions
of tensor-core data channels-last, the outputs back in contiguous NCHW,
and a conv bias whose only consumer is a training BatchNorm given a zero
gradient. The flag, and ``MXNET_CONV_S2D`` beside it, are read at each
call and are part of the signature, so flipping one selects other
graphs; :meth:`CachedOp.layout_plan` gives a signature's decisions. The
passes run on the CPU too, as the reference's do.

With telemetry on, :mod:`mxnet_tpu_torch.compilewatch` records each
signature as a program (``CachedOp.forward``/``CachedOp.fwd_vjp``, its
node-by-node backward ``CachedOp.bwd``, a tape plan
``autograd.fused_backward``/``autograd.fused_step``): the warm-up's
seconds and FLOPs, the capture's seconds and memory, one hit a later
call.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .config import get as _cfg
from .context import Context
from . import autograd
from . import compilewatch as _cw
from . import engine as _engine
from . import ops as _ops
from . import random as _random
from .symbol import layout_opt as _layout_opt

__all__ = ["CachedOp", "eager", "in_call", "outermost", "tape_plan",
           "replay_counts", "reset_replay_counts",
           "capture_pending_backwards", "MAX_INSTANCES"]

# graph instances of one signature: each holds a whole forward's residuals
MAX_INSTANCES = 4

_TLS = threading.local()
_UID = [0]
# graph replays by kind since the last reset: a CachedOp's forward and
# backward, and a tape plan (backward, or backward + update)
# and a K-step chunk (scan.py)
_REPLAYS = {"forward": 0, "backward": 0, "tape": 0, "chunk": 0}
_SLOT = object()       # marks a data input's position among the arguments
# live records on instances whose node-by-node backward is not captured yet
_BWD_TODO: "weakref.WeakSet" = weakref.WeakSet()
# scan.py's hook: deferred outputs for a call while a chunk buffers
_DEFER = [None]


class _Seq:
    """A list or tuple among a call's arguments or outputs, with its
    NDArrays replaced by ``_SLOT`` (hashable: part of a signature)."""

    __slots__ = ("kind", "items")

    def __init__(self, kind, items):
        self.kind, self.items = kind, items

    def __eq__(self, other):
        return isinstance(other, _Seq) and self.kind is other.kind and \
            self.items == other.items

    def __hash__(self):
        return hash((self.kind, self.items))


def _flatten(obj, leaves: list):
    """``obj`` with each NDArray appended to ``leaves`` and replaced by
    ``_SLOT``, lists and tuples kept as :class:`_Seq`."""
    from .ndarray import NDArray
    if isinstance(obj, NDArray):
        leaves.append(obj)
        return _SLOT
    if isinstance(obj, (list, tuple)):
        return _Seq(type(obj), tuple(_flatten(o, leaves) for o in obj))
    return obj


def _unflatten(fmt, it):
    """The nesting ``fmt`` with its slots filled from ``it``."""
    if fmt is _SLOT:
        return next(it)
    if isinstance(fmt, _Seq):
        return fmt.kind(_unflatten(f, it) for f in fmt.items)
    return fmt


def _format(fmt, arrays):
    """A call's result from its output arrays: as the reference's
    CachedOp, a flat list of several, else the one; else the nesting."""
    if isinstance(fmt, _Seq) and all(c is _SLOT for c in fmt.items):
        return arrays if len(arrays) > 1 else arrays[0]
    return _unflatten(fmt, iter(arrays))


def replay_counts() -> Dict[str, int]:
    """Graph replays of each kind since the last reset."""
    return dict(_REPLAYS)


def reset_replay_counts():
    for k in _REPLAYS:
        _REPLAYS[k] = 0


def outermost() -> bool:
    """True outside every CachedOp call and :func:`eager` scope: only
    there does a hybridized block run through its CachedOp."""
    return getattr(_TLS, "depth", 0) == 0


def in_call() -> bool:
    """True while a CachedOp runs its block's forward (its eager run on
    the CPU, its warm-up or capture on the card, a chunk's replay):
    where the reference traces the block under jit. An op whose output
    shape depends on the data refuses to run there."""
    return getattr(_TLS, "calls", 0) > 0


@contextlib.contextmanager
def eager():
    """Run hybridized blocks inside the scope eagerly, as a CachedOp's
    own forward does with its children."""
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    try:
        yield
    finally:
        _TLS.depth -= 1


def _alias(t: torch.Tensor, requires_grad: bool) -> torch.Tensor:
    """A leaf over ``t``'s storage with a version counter of its own:
    writes into ``t`` (a static buffer's copy, the optimizer's update)
    do not invalidate the residuals an inner graph saved from it."""
    a = torch.empty(0, dtype=t.dtype, device=t.device)
    a.set_(t.untyped_storage(), t.storage_offset(), t.size(), t.stride())
    return a.requires_grad_(requires_grad)


_SIDE: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    s = _SIDE.get(idx)
    if s is None:
        s = _SIDE[idx] = torch.cuda.Stream(device=device)
    return s


@contextlib.contextmanager
def _on_side_stream(device: torch.device):
    """The warm-up's stream: it starts after the work queued so far and
    the current stream waits for it (PyTorch's capture recipe)."""
    cur = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        yield
    cur.wait_stream(side)


def _capture(graph, what: str, fn, pool=None):
    """Record ``fn()`` into ``graph``; a failure raises MXNetError naming
    ``what`` and the last op invoked. The current card's generator
    (:func:`mxnet_tpu_torch.random.generator`) is registered with the
    graph, so the random ops it captures draw anew on every replay,
    from where the eager stream stands; a torch without
    ``register_generator_state`` refuses such a draw during the capture,
    and the capture raises. The native engine's ops are drained first:
    a worker launching on the card must not run into it. Garbage is not collected during the capture:
    a dead block's CachedOp (a reference cycle) frees its graphs from its
    finalizer, which a capture cannot survive."""
    # an engine worker's launches and syncs must not run into a capture
    _engine.native_drain()
    _ops.last_op(reset=True)
    register = getattr(graph, "register_generator_state", None)
    if register is not None:
        register(_random.generator(
            Context("gpu", torch.cuda.current_device())))
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            return fn()
    except MXNetError:
        raise
    except Exception as e:  # noqa: BLE001 - re-raised with the op named
        raise MXNetError("%s: CUDA graph capture failed at op %s: %s"
                         % (what, _ops.last_op() or "(none)", e)) from e
    finally:
        if enabled:
            gc.enable()


class _Rec:
    """One call's tape record: the inner leaves (aliases of the inputs)
    and outputs whose graph holds the residuals, the inputs that need a
    gradient (``req``), the outputs that carry one (``diff``), and on
    the card the graph instance (``entry``) that owns them. ``call`` is
    the call (CachedOp, signature key, argument nesting, context) and
    ``meta`` its outputs' (shape, dtype, requires_grad), which a K-step
    chunk replays the call from (scan.py)."""

    __slots__ = ("entry", "static", "ins", "outs", "req", "diff", "gen",
                 "out_ts", "call", "meta", "__weakref__")

    def __init__(self, entry, static, ins, outs, call=None):
        self.entry, self.static = entry, static
        self.ins, self.outs = ins, outs
        self.req = [i for i, t in enumerate(ins) if t.requires_grad]
        self.diff = [j for j, o in enumerate(outs) if o.requires_grad]
        self.gen = entry.gen if static else 0
        self.out_ts = None
        self.call = call
        self.meta = None if call is None else tuple(
            (o.shape, o.dtype, o.requires_grad) for o in outs)

    def check(self):
        if not self.static:
            return
        if self.entry.graph is None:
            raise MXNetError(
                "CachedOp %s: the graphs this call was recorded on were "
                "released (cast, hybridize, a parameter's storage moved) "
                "before its backward" % self.entry.name)
        if self.gen != self.entry.gen:
            raise MXNetError(
                "CachedOp %s: the residuals of this call were overwritten "
                "by a later call of the same graph" % self.entry.name)

    def grads(self, gouts) -> List[Optional[torch.Tensor]]:
        """Input gradients (None where none) through the inner graph for
        output gradients ``gouts`` (None where none), the residuals kept
        for another pass."""
        grads = [None] * len(self.ins)
        if not self.diff or not self.req:
            return grads
        gs = torch.autograd.grad(
            [self.outs[j] for j in self.diff],
            [self.ins[i] for i in self.req],
            [torch.zeros_like(self.outs[j]) if gouts[j] is None
             else gouts[j] for j in self.diff],
            retain_graph=True, allow_unused=True)
        for i, g in zip(self.req, gs):
            grads[i] = g
        return grads

    def backward(self, gouts) -> List[Optional[torch.Tensor]]:
        """:meth:`grads`, through the instance's captured backward on
        the card."""
        self.check()
        if self.static:
            return self.entry.backward(gouts)
        return self.grads(gouts)

    def release(self):
        """The residuals are spent: free the instance (or the eager
        graph) for the next call."""
        _BWD_TODO.discard(self)
        if self.static:
            if self.entry.owner is not None and self.entry.owner() is self:
                self.entry.owner = None
        else:
            self.ins = self.outs = None


class _Node(torch.autograd.Function):
    """One CachedOp call on the tape: its inputs are the call's data and
    parameter tensors, its outputs ``rec.out_ts``."""

    @staticmethod
    def forward(ctx, rec, *tensors):
        ctx.rec = rec
        outs = rec.out_ts
        rec.out_ts = None
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        if torch.is_grad_enabled():
            raise MXNetError("create_graph=True through a hybridized "
                             "block: its backward is first-order only")
        rec = ctx.rec
        grads = rec.backward(list(gouts))
        rec.release()
        return (None,) + tuple(grads)


class _Entry:
    """One signature's graphs on the card: the static input buffers (None
    where a parameter is read in place), the inner leaves and outputs of
    the captured forward, and for a recording signature the captured
    backward with its static output gradients and input gradients; the
    plan runners it owns (``runners``) and those that replay over it
    (``readers``, closed when it is released)."""

    def __init__(self, cop, recording, layout=False):
        # weak: the CachedOp's finalizer holds its entries
        self._cop = weakref.ref(cop)
        self.name, self.recording = cop.name, recording
        self.layout = layout   # MXNET_LAYOUT_OPT of its signature
        self.graph = self.bwd = None
        self.bufs = self.leaves = self.outs = None
        self.gouts = self.gins = None
        self.ptrs = ()
        self.owner = None      # weakref to the _Rec whose residuals it holds
        self.gen = 0
        self.needs_bwd = False
        self.runners: Dict[tuple, "_Runner"] = {}
        self.readers: "weakref.WeakSet" = weakref.WeakSet()
        self.prog = None       # compilewatch (Watch, record, signature)
        self.bwd_prog = (None, None)

    @property
    def cop(self) -> "CachedOp":
        return self._cop()

    def busy(self) -> bool:
        return self.owner is not None and self.owner() is not None

    def capture(self, tensors, consts, ctx):
        cop = self.cop
        torch.cuda.synchronize()
        self.bufs, self.leaves = [], []
        with torch.no_grad():
            for i, t in enumerate(tensors):
                if i >= cop.n_data and cop.static_alloc:
                    buf, src = None, t
                else:
                    buf = src = torch.empty_like(t)
                    buf.copy_(t)
                self.bufs.append(buf)
                self.leaves.append(_alias(
                    src, self.recording and t.requires_grad))
        self.ptrs = cop._param_ptrs(tensors)
        fwd = torch.cuda.CUDAGraph()
        w, rec, _ = self.prog or (None, None, None)
        self.outs = _cw.timed(w, rec, "capture", lambda: _capture(
            fwd, "CachedOp %s forward" % cop.name,
            lambda: cop._run(self.leaves, consts, ctx, True, self.layout)),
            memory=True)
        if self.recording:
            self.gins = [None] * len(self.leaves)
            self.needs_bwd = any(o.requires_grad for o in self.outs) and \
                any(t.requires_grad for t in self.leaves)
        # set last: a capture that raised leaves nothing to replay
        self.graph = fwd

    def capture_backward(self):
        """Capture the node-by-node backward over this instance's static
        residuals (a no-op once done, or once released)."""
        if self.bwd is not None or self.graph is None:
            return
        rec = _Rec(self, True, self.leaves, self.outs)
        self.gouts = [torch.zeros_like(o) if o.requires_grad else None
                      for o in self.outs]
        bwd = torch.cuda.CUDAGraph()
        w = brec = None
        if self.prog is not None and _cw.enabled():
            w = self.cop._watch(None, True)
            brec = w.lookup(self.prog[2]) or w.miss(self.prog[2])
        self.gins = _cw.timed(w, brec, "capture", lambda: _capture(
            bwd, "CachedOp %s backward" % self.name,
            lambda: rec.grads(self.gouts), pool=self.graph.pool()),
            memory=True)
        self.bwd = bwd
        self.bwd_prog = (w, brec)

    def replay(self, tensors, train) -> List[torch.Tensor]:
        cop = self.cop
        with torch.no_grad():
            for buf, t in zip(self.bufs, tensors):
                if buf is not None:
                    buf.copy_(t)
            self.graph.replay()
            _REPLAYS["forward"] += 1
            self.gen += 1
            outs = [o.detach().clone() for o in self.outs]
            if train and not cop.static_alloc:
                # moving statistics the graph wrote into its copies
                for i in cop.aux_idx:
                    tensors[i].copy_(self.bufs[i])
        return outs

    def backward(self, gouts):
        if self.needs_bwd:
            # not captured ahead by autograd: capture here
            self.capture_backward()
        if self.bwd is None:
            return list(self.gins)
        with torch.no_grad():
            for buf, g in zip(self.gouts, gouts):
                if buf is None:
                    continue
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
            self.bwd.replay()
            _REPLAYS["backward"] += 1
            w, brec = self.bwd_prog
            if brec is not None:
                w.hit(brec)
            return [None if g is None else g.clone() for g in self.gins]


def capture_pending_backwards():
    """Capture the node-by-node backward of every instance a live record
    may replay it on, ahead of a backward (a capture inside autograd's
    engine is left as the last resort)."""
    for rec in list(_BWD_TODO):
        _BWD_TODO.discard(rec)
        rec.entry.capture_backward()


def _release_entries(entries):
    """Drop the graphs (and with them their memory pools) and close every
    plan runner that replays over them; a tape recorded on them raises
    in its backward (:meth:`_Rec.check`)."""
    for lst in entries.values():
        for e in lst:
            for r in list(e.readers):
                r.close()
            e.graph = e.bwd = None
            e.bufs = e.leaves = e.outs = e.gouts = e.gins = None
            e.runners.clear()
    entries.clear()


class CachedOp:
    """A hybridized block's forward as captured graphs (ref:
    CachedOp). ``forward(*args)`` is the block's eager forward over
    NDArrays, ``params`` its Parameters (read through
    :func:`gluon.parameter.substitute` inside a call), ``input_names``
    the data inputs' names then the parameters', ``flags`` the
    ``hybridize`` flags."""

    def __init__(self, forward, params, input_names, flags=(), name=""):
        _UID[0] += 1
        self.uid = _UID[0]
        self.name = name or "cop%d" % self.uid
        self._forward = forward
        self.params = list(params)
        self.input_names = list(input_names)
        flags = dict(flags)
        self.static_alloc = bool(flags.get("static_alloc", False))
        self.n_data = 0
        self._aux = [k for k, p in enumerate(self.params) if p._is_aux]
        self.aux_idx: List[int] = []
        self._entries: Dict[tuple, List[_Entry]] = {}
        # each signature's output nesting (its first call is eager)
        self._out_fmts: Dict[tuple, object] = {}
        self._out_fmt = None
        # each signature's layout plan (MXNET_LAYOUT_OPT), set by its
        # last run of the block's forward
        self._layout_plans: Dict[tuple, "_layout_opt.LayoutPlan"] = {}
        self._layout_plan = None
        self._warm: set = set()
        self._last_key = None
        self._watches: Dict[tuple, "_cw.Watch"] = {}
        self._progs: Dict[tuple, tuple] = {}   # key -> (Watch, record, sig)
        self._lock = threading.Lock()
        self._finalizer = weakref.finalize(self, _release_entries,
                                           self._entries)
        self._finalizer.atexit = False

    # ------------------------------------------------------------------
    def num_entries(self) -> int:
        """Signatures seen (one cache entry each, as the reference's
        program cache counts them)."""
        return len(self._entries)

    def release(self):
        """Drop every graph and its memory pool."""
        self._finalizer()

    def _param_ptrs(self, tensors):
        return tuple(t.data_ptr() for t in tensors[self.n_data:])

    def _watch(self, train, recording) -> "_cw.Watch":
        """The compilewatch site of calls in mode ``train`` (None: the
        node-by-node backward), recording or not, named as the
        reference names its programs."""
        w = self._watches.get((train, recording))
        if w is None:
            names = list(self.input_names) + ["static"]
            if train is None:
                w = _cw.Watch("CachedOp.bwd", "cached_op", names,
                              "cop%d" % self.uid)
            elif recording:
                w = _cw.Watch("CachedOp.fwd_vjp", "cached_op", names,
                              "cop%d" % self.uid)
            else:
                w = _cw.Watch("CachedOp.forward", "cached_op", names,
                              "cop%d/%s" % (self.uid,
                                            "train" if train else "eval"))
            self._watches[(train, recording)] = w
        return w

    def _program(self, key, tensors):
        """compilewatch's (Watch, record, signature) of the call with
        signature ``key``, and whether the signature is new; (None,
        False) with telemetry off."""
        if not _cw.enabled():
            return None, False
        prog = self._progs.get(key)      # the key holds the signature
        if prog is not None:
            prog[0].hit(prog[1])
            return prog, False
        train, recording = key[0], key[1]
        w = self._watch(train, recording)
        sig = tuple(_cw.tensor_sig(t) for t in tensors) + (_cw.value_sig(
            (train, key[2], key[3], key[5], key[6]),
            "train=%d casts=%s layout=%d s2d=%d"
            % (train, key[2], key[5], key[6])),)
        rec = w.lookup(sig)
        new = rec is None
        if new:
            rec = w.miss(sig)
        else:
            w.hit(rec)
        prog = self._progs[key] = (w, rec, sig)
        return prog, new

    def layout_plan(self, key=None) -> Optional[List[tuple]]:
        """``(nhwc, bias_elided)`` of each Convolution call, in call
        order, as the layout passes decided them for signature ``key``
        (default: the signature called last); None where the passes
        were off."""
        plan = self._layout_plans.get(key) if key is not None else \
            self._layout_plans.get(self._last_key)
        return None if plan is None else plan.rows()

    def _run(self, tensors, consts, ctx, substitute, layout=False):
        """The block's forward over ``tensors`` (data, then parameters)
        with every child eager; returns the output tensors, flat (their
        nesting is kept in ``self._out_fmt``). With ``layout`` the NHWC
        pass and the conv-bias elision wrap it, and their plan is kept
        in ``self._layout_plan``."""
        from .gluon.parameter import substitute as _sub
        from .ndarray import NDArray
        it = iter([NDArray(t, ctx) for t in tensors[:self.n_data]])
        args = [_unflatten(c, it) for c in consts]
        mapping = {p: NDArray(t, ctx) for p, t in
                   zip(self.params, tensors[self.n_data:])} \
            if substitute else None

        def body():
            with eager(), _sub(mapping):
                out = self._forward(*args)
            outs = []
            self._out_fmt = _flatten(out, outs)
            return [o.tensor() for o in outs]
        if layout:
            plan = _layout_opt.LayoutPlan()
            body = _layout_opt.convert_layout(
                _layout_opt.elide_conv_bias_into_bn(body, plan), plan)
            self._layout_plan = plan
        _TLS.calls = getattr(_TLS, "calls", 0) + 1
        try:
            return body()
        finally:
            _TLS.calls -= 1

    def _eager(self, tensors, consts, ctx, recording, entry, call=None):
        """One eager call: outputs, as one tape node when recording."""
        if not recording:
            with torch.no_grad():
                return self._run(tensors, consts, ctx, False, entry.layout)
        leaves = [_alias(t, t.requires_grad) for t in tensors]
        with torch.enable_grad():
            outs = self._run(leaves, consts, ctx, True, entry.layout)
        rec = _Rec(entry, False, leaves, outs, call)
        rec.out_ts = [o.detach() for o in outs]
        return list(_Node.apply(rec, *tensors))

    def _instance(self, key, recording) -> _Entry:
        lst = self._entries.setdefault(key, [])
        for e in lst:
            if not e.busy():
                return e
        if len(lst) >= MAX_INSTANCES:
            raise MXNetError(
                "CachedOp %s: %d recorded calls of one signature hold their "
                "residuals for a backward that has not run; run backward or "
                "drop their outputs before the next call"
                % (self.name, len(lst)))
        e = _Entry(self, recording, key[5])
        lst.append(e)
        return e

    def __call__(self, *args):
        from .ndarray import NDArray
        datas = []
        consts = tuple(_flatten(a, datas) for a in args)
        if not datas:
            raise MXNetError("CachedOp %s: no NDArray input" % self.name)
        if _DEFER[0] is not None:
            deferred = _DEFER[0](self, datas, consts)
            if deferred is not None:
                return deferred
        ctx = datas[0].context
        self.n_data = len(datas)
        arrays = datas + [p.data(ctx) for p in self.params]
        self.aux_idx = [self.n_data + k for k in self._aux]
        tensors = [a.tensor() for a in arrays]
        recording = autograd.is_recording() and \
            any(t.requires_grad for t in tensors)
        train = autograd.is_training()
        key = (train, recording, _ops._CASTS_KEY[0], consts,
               tuple((t.shape, t.stride(), t.dtype, t.device,
                      t.requires_grad) for t in tensors),
               _layout_opt.layout_opt_enabled(), _cfg("MXNET_CONV_S2D"))
        call = (self, key, consts, ctx) if recording else None
        with self._lock:
            prog, new = self._program(key, tensors)
            entry = self._instance(key, recording)
            if prog is not None:
                entry.prog = prog
            if not tensors[0].is_cuda:
                w, rec, _ = prog if new else (None, None, None)
                outs = _cw.timed(w, rec, "warmup", lambda: self._eager(
                    tensors, consts, ctx, recording, entry, call),
                    flops=True)
            else:
                outs = self._call_card(entry, key, tensors, consts, ctx,
                                       recording, train, call,
                                       prog if new else None)
            if self._out_fmt is not None:
                self._out_fmts[key] = self._out_fmt
                self._out_fmt = None
            if self._layout_plan is not None:
                self._layout_plans[key] = self._layout_plan
                self._layout_plan = None
            self._last_key = key
            fmt = self._out_fmts[key]
        return _format(fmt, [NDArray(t, ctx) for t in outs])

    def _call_card(self, entry, key, tensors, consts, ctx, recording,
                   train, call=None, new_prog=None):
        if key not in self._warm:
            w, rec, _ = new_prog or (None, None, None)
            with _on_side_stream(tensors[0].device):
                outs = _cw.timed(w, rec, "warmup", lambda: self._eager(
                    tensors, consts, ctx, recording, entry, call),
                    flops=True)
            self._warm.add(key)
            if not recording:
                entry.capture(tensors, consts, ctx)
            return outs
        if entry.graph is not None and \
                entry.ptrs != self._param_ptrs(tensors):
            # a parameter's storage moved: every graph of this op is stale
            _release_entries(self._entries)
            entry = self._instance(key, recording)
            entry.prog = self._program(key, tensors)[0] if \
                _cw.enabled() else None
        if entry.graph is None:
            entry.capture(tensors, consts, ctx)
        outs = entry.replay(tensors, train)
        if not recording:
            return outs
        rec = _Rec(entry, True, entry.leaves, entry.outs, call)
        entry.owner = weakref.ref(rec)
        if entry.needs_bwd and entry.bwd is None:
            _BWD_TODO.add(rec)
        rec.out_ts = outs
        return list(_Node.apply(rec, *tensors))


# ---------------------------------------------------------------------------
# the tape plan (MXNET_FUSED_BACKWARD): every CachedOp node of a backward
# as one function, captured after its first, eager run
# ---------------------------------------------------------------------------
class _Plan:
    """A backward over a tape of CachedOp nodes only: ``recs`` in
    forward order, ``wiring[n][i]`` the source of node n's input i
    (``("n", node, output)``, ``("v", leaf)`` or None), ``heads`` the
    (node, output) of each head, ``leaves`` the variables it writes."""

    __slots__ = ("recs", "wiring", "heads", "cots", "leaves", "key")

    def __init__(self, recs, wiring, heads, cots, leaves):
        self.recs, self.wiring, self.heads = recs, wiring, heads
        self.cots, self.leaves = cots, leaves
        # the instances and variables by id: a runner keeps the variables
        # alive, and an instance closes its runners before it goes
        self.key = (tuple((id(r.entry), r.static) for r in recs),
                    tuple(wiring), tuple(heads),
                    tuple((tuple(c.shape), c.dtype) for c in cots),
                    tuple((id(v), v._grad_req, v._grad.tensor().data_ptr())
                          for v in leaves))

    @property
    def leaf_ids(self):
        return frozenset(id(v) for v in self.leaves)

    def run(self, runners=None, upd_key=None, update=None):
        """Write the gradients (and apply ``update()``, whose math and
        tensors ``upd_key`` names) through the runner of this plan in
        ``runners``: the optimizer's with an update, else the last
        node's graph instance's."""
        if runners is None:
            runners = self.recs[-1].entry.runners
        key = self.key if upd_key is None else (self.key, upd_key)
        runner = runners.get(key)
        if runner is None or runner.closed:
            for k in [k for k, r in runners.items() if r.closed]:
                del runners[k]
            runner = runners[key] = _Runner(self)
        try:
            runner.run(self, update)
        finally:
            for r in self.recs:
                r.release()


def _tape_fn(plan, cots, update):
    """Every node's backward in reverse forward order, the gradients
    written into the variables by their ``grad_req``, then
    ``update()``."""
    cot: Dict[tuple, torch.Tensor] = {}

    def add(d, k, g):
        d[k] = g if k not in d else d[k] + g
    for h, c in zip(plan.heads, cots):
        add(cot, h, c)
    leaf_g: Dict[int, torch.Tensor] = {}
    for n in reversed(range(len(plan.recs))):
        rec = plan.recs[n]
        gouts = [cot.pop((n, j), None) for j in range(len(rec.outs))]
        if all(gouts[j] is None for j in rec.diff):
            continue
        for i, g in enumerate(rec.grads(gouts)):
            src = plan.wiring[n][i]
            if g is None or src is None:
                continue
            if src[0] == "n":
                add(cot, (src[1], src[2]), g)
            else:
                add(leaf_g, src[1], g)
    with torch.no_grad():
        for li, g in leaf_g.items():
            v = plan.leaves[li]
            tgt = v._grad.tensor()
            if v._grad_req == "write":
                tgt.copy_(g)
            else:
                tgt.add_(g.to(tgt.dtype))
        if update is not None:
            update()


class _Runner:
    """Runs a plan's function: eagerly when a node is not a graph
    instance (the CPU, a warm-up call); on the card eagerly the first
    time, then captured once and replayed, with the head gradients
    copied into static buffers. Captured, it keeps what the graph
    writes alive (the variables, their gradients, the update and the
    tensors it reads) until :meth:`close`."""

    def __init__(self, plan):
        self.static = all(r.static for r in plan.recs)
        if self.static:
            for r in plan.recs:
                r.entry.readers.add(self)
        self.graph = None
        self.warm = False
        self.closed = False
        self.cots = self.keep = None
        self.watch = self.rec = None

    def _program(self, plan, update):
        """compilewatch's (Watch, record) of this runner, the record new
        on its first run; None with telemetry off."""
        if not _cw.enabled():
            return None
        if self.watch is None:
            n = len(plan.recs)
            if update is None:
                self.watch = _cw.Watch(
                    "autograd.fused_backward", "autograd.backward",
                    instance="tape[%d nodes]" % n)
            else:
                self.watch = _cw.Watch(
                    "autograd.fused_step", "trainer.step",
                    instance="tape[%d nodes]+update" % n)
        if self.rec is None:
            sig = tuple(_cw.tensor_sig(c) for c in plan.cots) + \
                tuple(_cw.tensor_sig(v._t) for v in plan.leaves)
            self.watch._arg_names = \
                ["head_grad%d" % i for i in range(len(plan.cots))] + \
                ["leaf%d" % i for i in range(len(plan.leaves))]
            self.rec = self.watch.miss(sig)
            return self.watch, self.rec, True
        self.watch.hit(self.rec)
        return self.watch, self.rec, False

    def close(self):
        """An instance it replays over was released: never run again."""
        self.closed = True
        self.graph = self.cots = self.keep = None

    def run(self, plan, update):
        for r in plan.recs:
            r.check()
        w, rec, new = self._program(plan, update) or (None, None, False)
        if not self.static or not self.warm:
            _cw.timed(w, rec if new else None, "warmup",
                      lambda: _tape_fn(plan, plan.cots, update), flops=True)
            self.warm = True
            return
        if self.graph is None:
            torch.cuda.synchronize()
            self.cots = [c.clone() for c in plan.cots]
            self.keep = (plan.leaves,
                         [v._grad.tensor() for v in plan.leaves], update)
            graph = torch.cuda.CUDAGraph()
            _cw.timed(w, rec, "capture", lambda: _capture(
                graph, "backward of %d hybridized call(s)" % len(plan.recs),
                lambda: _tape_fn(plan, self.cots, update)), memory=True)
            self.graph = graph     # a capture that raised leaves none
        else:
            with torch.no_grad():
                for s, c in zip(self.cots, plan.cots):
                    s.copy_(c)
        self.graph.replay()
        _REPLAYS["tape"] += 1


def tape_plan(outs, cots, variables) -> Optional[_Plan]:
    """The plan of a backward from head tensors ``outs`` with cotangents
    ``cots`` when every node between them and the variables is a
    CachedOp call; None otherwise."""
    cls = _Node._backward_cls
    for h in outs:
        if not isinstance(h.grad_fn, cls):
            return None
    var_of = {id(v._t): v for v in list(variables)}
    order, index, state = [], {}, {}
    stack = [h.grad_fn for h in outs]
    while stack:
        fn = stack[-1]
        if fn in state:
            stack.pop()
            if state[fn] == 0:
                state[fn] = 1
                index[fn] = len(order)
                order.append(fn)
            continue
        state[fn] = 0
        for nf, _ in fn.next_functions:
            if nf is None or type(nf).__name__ == "AccumulateGrad":
                continue
            if not isinstance(nf, cls):
                return None
            if nf not in state:
                stack.append(nf)
            elif state[nf] == 0:
                return None              # a cycle cannot happen on a tape
    leaves, leaf_idx, wiring = [], {}, []
    for fn in order:
        w = []
        for nf, j in fn.next_functions:
            if nf is None:
                w.append(None)
            elif isinstance(nf, cls):
                w.append(("n", index[nf], j))
            else:
                v = var_of.get(id(nf.variable))
                if v is None or v._grad is None:
                    w.append(None)
                    continue
                if id(v) not in leaf_idx:
                    leaf_idx[id(v)] = len(leaves)
                    leaves.append(v)
                w.append(("v", leaf_idx[id(v)]))
        wiring.append(tuple(w))
    recs = [fn.rec for fn in order]
    if any(r.ins is None for r in recs):
        return None                       # spent by an earlier backward
    heads = [(index[h.grad_fn], h.output_nr) for h in outs]
    return _Plan(recs, wiring, heads, cots, leaves)

