"""K-step whole-loop compilation (``MXNET_SCAN_STEPS``; counterpart of
``mxnet_tpu/scan.py``).

``MXNET_SCAN_STEPS=K`` buffers K consecutive fused training steps (the
deferred backward and SGD update of ``MXNET_TRAINER_FUSED_UPDATE``) and
retires them as ONE function: on the card one captured CUDA graph that
runs, for k in 0..K-1, step k's forward (every hybridized call of the
step, as the CachedOps' own forward functions), its backward and
gradient write-back (``cached_op._tape_fn``), the guard's verdict and
the SGD update with step k's hyperparameters. On the CPU the same
function runs eagerly, so the tests hold everything but the capture.

How a step is buffered. The first eligible step (the arming step,
classic) leaves its backward's plan behind (``autograd``); the runner
takes its structure as the template (:class:`_Template`): the CachedOp
calls in order, their signatures, how their inputs are wired, the heads.
While the runner buffers, a recorded call whose signature matches the
template's next node copies its data inputs into step k's input slot
and returns deferred NDArrays (``NDArray._pending``) over step k's
output slot; an input that is an earlier node's deferred output is wired,
not forced. ``backward()`` on the deferred heads stashes the step
(:class:`_DeferredPending`), ``Trainer.step`` pushes it with its update
prepared on the host (counters advanced, lrs and wds taken, as the
per-step path takes them), and the K-th push retires the chunk. The
deferred arrays then take their values from the output slots.

Several devices: a Trainer over two or more contexts (replicated or
ZeRO, ``gluon/zero.py``) never arms the fused update, so it never
enters a chunk either; ``MXNET_SCAN_STEPS`` above 1 leaves its per-step
path as it is (K = 8 is K = 1 bit for bit), after one warning a
Trainer. A chunk over several devices in one captured graph needs
several cards in one process (ROADMAP.md queue 1, item 11).

Correctness contract: while a chunk buffers no parameter changes, and
anything that would observe intermediate state drains it first, so the
chunk is bit for bit the K per-step fused steps it replaces:

- ``Parameter.grad()``/``list_grad()``, ``NDArray.grad``, ``backward``
  and ``grad`` drain through ``autograd.flush_all_pending``;
- reading a deferred array (its value, an eager op that takes it, an
  in-place write) forces it: the buffered steps drain, and a step still
  being recorded re-runs its calls for real (so its arrays join the
  tape); a call that does not match the template drains first too;
- the Trainer's checkpoints (``save_states``, ``states_blob``,
  ``load_states``, ``load_states_blob``) drain the partial chunk.

A partial chunk drains as in the reference: with no guard and no
injection armed, each step runs through the per-step fused consume (its
calls replayed for real, with the update it was pushed with); else the
chunk function runs at its own length.

The eligibility ladder (each rung logs one warning and runs the
per-step path, on the card): a Trainer that is not fused-update
eligible (not plain SGD, masters, ``grad_req='add'``, a guard other
than ``skip_step``) never arms; a template whose forward writes
auxiliary state (BatchNorm's moving statistics) is not buffered; a loop
that forces its deferred arrays ``_FORCE_BAIL_STREAK`` times in a row
(a loss read every step, an eager op between forward and backward)
bails.

The guard at the boundary: a ``skip_step`` guard (no clip, no AMP
scaler) stays eligible. The graph writes each step's
``multi_finite_norm`` row into a (K, 2n) verdict and selects the old
weight and momentum where a gradient is not finite; the host reads the
verdict once a chunk and replays ``GradGuard.evaluate`` K times, so the
counters, the events and ``sync_count`` are what the per-step path
keeps, at one host read a chunk. A step skipped inside a chunk does not
advance the optimizer's counters, as a skipped per-step step does not:
the later steps of its chunk select their lrs by the number of steps
skipped before them (the reference advances the counter of a skipped
step inside a chunk; ROADMAP.md queue 3). The ``nan_grad`` and
``scaled_grad`` fault sites are drawn when a step is pushed and applied
in the graph.
"""
from __future__ import annotations

import logging
import weakref
from typing import Dict, List, Optional

import torch

from . import autograd
from . import cached_op
from . import compilewatch as _cw
from . import telemetry
from .base import MXNetError

log = logging.getLogger("mxnet_tpu_torch.scan")

__all__ = ["steps", "ChunkRunner", "guard_compatible", "flush_runners"]

# consecutive forces of a loop's deferred arrays after which buffering
# is pure overhead for it: the runner bails
_FORCE_BAIL_STREAK = 3


def steps() -> int:
    """The chunk length (MXNET_SCAN_STEPS), at least 1."""
    from .config import get as _cfg
    return max(1, int(_cfg("MXNET_SCAN_STEPS")))


def guard_compatible(trainer, guard) -> bool:
    """True when an enabled guard can ride the chunk boundary: only the
    ``skip_step`` policy, with no clip and no AMP scaler (the one policy
    that is a select in the graph whose bookkeeping replays from the
    verdict afterwards)."""
    if steps() <= 1:
        return False
    runner = getattr(trainer, "_scan", None)
    if runner is not None and runner.bailed:
        return False
    return (getattr(guard, "nonfinite", None) == "skip_step"
            and float(getattr(guard, "clip_norm", 0.0) or 0.0) <= 0.0
            and getattr(guard, "scaler", None) is None)


def _contiguous(shape, stride) -> bool:
    expect, acc = [], 1
    for n in reversed(shape):
        expect.append(acc)
        acc *= max(int(n), 1)
    return tuple(stride) == tuple(reversed(expect))


class _TNode:
    """One hybridized call of the template: its CachedOp, signature key,
    argument nesting, context, data-input count, output metas
    ((shape, dtype, requires_grad) each), output nesting, train flag and
    the parameter arrays it read."""

    __slots__ = ("cop", "key", "consts", "ctx", "n_data", "meta", "fmt",
                 "train", "params")


class _Template:
    """The structure of one step: the CachedOp calls (:class:`_TNode`),
    the plan's ``wiring`` and ``heads``, the heads' cotangent metas and
    the variables the backward writes. ``sig`` names all of it."""

    def __init__(self, nodes, plan):
        self.nodes = nodes
        self.wiring, self.heads = plan.wiring, plan.heads
        self.cot_meta = [(tuple(c.shape), c.dtype) for c in plan.cots]
        self.leaves = list(plan.leaves)
        self.leaf_ids = frozenset(id(v) for v in self.leaves)
        self.aux = any(n.cop._aux and n.train for n in nodes)
        self.sig = (tuple((id(n.cop), n.key) for n in nodes),
                    tuple(self.wiring), tuple(self.heads),
                    tuple(self.cot_meta),
                    tuple(id(v) for v in self.leaves))

    @classmethod
    def of(cls, plan) -> Optional["_Template"]:
        """The template of a plan, or None when a step of it cannot be
        replayed from slots (a data input that is itself a variable, or
        not contiguous)."""
        if plan is None:
            return None
        nodes = []
        for j, rec in enumerate(plan.recs):
            call = rec.call
            if call is None:
                return None
            cop, key, consts, ctx = call
            fmt = cop._out_fmts.get(key)
            if fmt is None:
                return None
            node = _TNode()
            node.cop, node.key, node.consts, node.ctx = cop, key, consts, ctx
            node.n_data = len(key[4]) - len(cop.params)
            node.meta, node.fmt, node.train = rec.meta, fmt, key[0]
            node.params = [p.data(ctx) for p in cop.params]
            for i, src in enumerate(plan.wiring[j]):
                if i < node.n_data:
                    if src is not None and (src[0] != "n" or src[1] >= j):
                        return None
                    shape, stride = key[4][i][0], key[4][i][1]
                    if src is None and not _contiguous(shape, stride):
                        return None
                elif src is not None and (
                        src[0] != "v" or plan.leaves[src[1]]
                        is not node.params[i - node.n_data]):
                    return None
            nodes.append(node)
        return cls(nodes, plan)


class _Step:
    """One step of the chunk: its slot ``k``, the calls recorded so far
    (``cursor``), its deferred arrays by (node, output) and its state:
    ``open`` (recording), ``stashed`` (its backward is pending),
    ``buffered`` (pushed) or ``done``."""

    __slots__ = ("runner", "k", "cursor", "arrays", "state",
                 "__weakref__")

    def __init__(self, runner, k):
        self.runner, self.k = runner, k
        self.cursor = 0
        self.arrays: Dict[tuple, weakref.ref] = {}
        self.state = "open"

    def force(self):
        """A deferred array of this step is read."""
        self.runner._force(self)

    def fill(self, values):
        """Give every live deferred array of this step its value
        (``values[(node, output)]()``, a tensor)."""
        for pos, ref in self.arrays.items():
            arr = ref()
            if arr is not None and arr._pending is not None and \
                    arr._pending[0] is self:
                arr._t = values(pos)
                arr._pending = None
        self.state = "done"


class _DeferredPending:
    """What ``backward()`` on a deferred step stashes in ``autograd``:
    ``Trainer.step`` pushes it to its runner. Run any other way
    (:meth:`execute`, :meth:`execute_with_update`), its calls are
    replayed for real first (:meth:`materialize`)."""

    __slots__ = ("step", "token")

    def __init__(self, step, token):
        self.step, self.token = step, token

    @property
    def leaf_ids(self):
        return self.step.runner.template.leaf_ids

    def materialize(self) -> "autograd._PendingStep":
        runner = self.step.runner
        runner.flush()
        return autograd._PendingStep(runner._materialize(self.step),
                                     self.token)

    def execute(self):
        self.materialize().execute()

    def execute_with_update(self, runners, upd_key, update):
        self.materialize().execute_with_update(runners, upd_key, update)


class _ChunkGraph:
    """One chunk function on the card: run eagerly the first time (the
    warm-up), captured the second and replayed from then on; ``keep``
    holds what the graph reads and writes."""

    __slots__ = ("warm", "graph", "keep")

    def __init__(self):
        self.warm, self.graph, self.keep = False, None, None


_RUNNERS: "weakref.WeakSet" = weakref.WeakSet()
_SUSPENDED = [0]


def flush_runners() -> None:
    """Drain every runner's buffered steps (the gradient readers call
    this through ``autograd.flush_scan_chunks``)."""
    for r in list(_RUNNERS):
        r.flush()


def _on_call(cop, datas, consts):
    """``CachedOp.__call__``'s hook: deferred outputs, or None for the
    call to run as usual (after any buffered steps drained)."""
    if _SUSPENDED[0]:
        return None
    runner = getattr(autograd._ARM_TOKEN[0], "_scan", None)
    if runner is not None and runner.live():
        return runner.on_call(cop, datas, consts)
    for r in list(_RUNNERS):
        if r.steps or r.cur is not None:
            r.flush()
    return None


def _on_backward(heads, head_grads) -> bool:
    """``autograd.backward``'s hook: True when it stashed a deferred
    step."""
    runner = getattr(autograd._ARM_TOKEN[0], "_scan", None)
    return runner is not None and runner.cur is not None and \
        runner.on_backward(heads, head_grads)


autograd.register_scan_flusher(flush_runners)


class ChunkRunner:
    """A Trainer's K-step buffer. ``push`` takes a stashed step and its
    prepared update; the K-th push retires the chunk; ``flush`` drains a
    partial one (checkpoints, gradient reads, deferred reads)."""

    def __init__(self, trainer, kk: int):
        self._trainer = weakref.ref(trainer)
        self.k = int(kk)
        self.template: Optional[_Template] = None
        self.steps: List[_Step] = []
        self.preps: List = []
        self.injects: List = []
        self.cur: Optional[_Step] = None
        self.bailed = False
        self.retired_chunks = 0    # chunks retired through the function
        self.flushed_steps = 0     # steps drained as a partial chunk
        self._force_streak = 0
        self._warned = False
        self._in: Dict[tuple, torch.Tensor] = {}
        self._out: Dict[tuple, torch.Tensor] = {}
        self._cot: List[torch.Tensor] = []
        self._guard_bufs = None
        self._graphs: Dict[tuple, _ChunkGraph] = {}
        self._draining = False
        self._watch = None         # compilewatch site of the chunks
        _RUNNERS.add(self)
        cached_op._DEFER[0] = _on_call
        autograd._SCAN_STASH[0] = _on_backward

    def live(self) -> bool:
        """Deferring calls: a template, no bail, and K still this
        runner's (at another K the Trainer drains it)."""
        return not self.bailed and self.template is not None and \
            steps() == self.k

    # -- the ladder -------------------------------------------------------
    def _bail(self, reason: str) -> None:
        self.bailed = True
        if not self._warned:
            self._warned = True
            log.warning(
                "MXNET_SCAN_STEPS=%d: %s — falling back to the per-step "
                "fused path for this Trainer", self.k, reason)

    def adopt(self, plan) -> None:
        """Take ``plan``'s structure as the template (a plan run per
        step; its calls were not deferred)."""
        if self.bailed:
            return
        t = _Template.of(plan)
        tr = self._trainer()
        if t is None or tr is None or not {
                id(p.list_data()[0]) for p in tr._params
                if p.grad_req != "null" and p._data is not None} \
                <= t.leaf_ids:
            return
        if t.aux:
            self._bail("a hybridized forward writes auxiliary state "
                       "(BatchNorm moving statistics), which a buffered "
                       "step cannot defer")
            return
        if self.template is not None and self.template.sig == t.sig:
            return
        self.template = t
        self._in.clear()
        self._out.clear()
        self._cot = []
        self._graphs.clear()

    # -- recording a step ---------------------------------------------------
    def _matches(self, node, j, cop, datas, consts, cur) -> bool:
        from . import ops as _ops
        if node.cop is not cop or node.consts != consts or \
                len(datas) != node.n_data:
            return False
        key = node.key
        if not autograd.is_recording() or \
                autograd.is_training() != key[0] or \
                _ops._CASTS_KEY[0] != key[2]:
            return False
        metas, wiring = key[4], self.template.wiring[j]
        for i, d in enumerate(datas):
            src, p = wiring[i], d._pending
            if src is not None:
                if p is None or p[0] is not cur or p[1] != src[1] or \
                        p[2] != src[2]:
                    return False
                continue
            if p is not None:
                return False
            t = d._t
            if (t.shape, t.stride(), t.dtype, t.device,
                    t.requires_grad) != metas[i]:
                return False
        for q, prm in enumerate(cop.params):
            a = prm.data(node.ctx)
            if a is not node.params[q]:
                return False
            t = a._t
            if (t.shape, t.stride(), t.dtype, t.device,
                    t.requires_grad) != metas[node.n_data + q]:
                return False
        return True

    def _slot(self, table, pos, shape, dtype, device):
        buf = table.get(pos)
        if buf is None:
            buf = table[pos] = torch.empty((self.k,) + tuple(shape),
                                           dtype=dtype, device=device)
        return buf

    def on_call(self, cop, datas, consts):
        t = self.template
        cur = self.cur
        if cur is None:
            if len(self.steps) >= self.k or \
                    not self._matches(t.nodes[0], 0, cop, datas, consts,
                                      None):
                if self.steps:
                    self.flush()
                return None
            cur = self.cur = _Step(self, len(self.steps))
        elif cur.state != "open" or cur.cursor >= len(t.nodes) or \
                not self._matches(t.nodes[cur.cursor], cur.cursor, cop,
                                  datas, consts, cur):
            self._force(cur)
            return None
        j = cur.cursor
        node = t.nodes[j]
        from .ndarray import NDArray
        with torch.no_grad():
            for i, d in enumerate(datas):
                if t.wiring[j][i] is None:
                    x = d._t
                    self._slot(self._in, (j, i), x.shape, x.dtype,
                               x.device)[cur.k].copy_(x)
        outs = []
        dev = node.params[0]._t.device if node.params else \
            datas[0]._t.device
        for o, (shape, dtype, _) in enumerate(node.meta):
            buf = self._slot(self._out, (j, o), shape, dtype, dev)
            arr = NDArray(buf[cur.k], node.ctx)
            arr._pending = (cur, j, o)
            cur.arrays[(j, o)] = weakref.ref(arr)
            outs.append(arr)
        cur.cursor += 1
        return cached_op._format(node.fmt, outs)

    def on_backward(self, heads, head_grads) -> bool:
        from .config import get as _cfg
        from .ndarray.ndarray import NDArray
        t, cur = self.template, self.cur
        if self.bailed or t is None or cur.state != "open" or \
                cur.cursor != len(t.nodes) or \
                autograd._PENDING[0] is not None or \
                not _cfg("MXNET_FUSED_BACKWARD"):
            return False
        heads = [heads] if isinstance(heads, NDArray) else list(heads)
        if len(heads) != len(t.heads):
            return False
        for h, pos in zip(heads, t.heads):
            p = getattr(h, "_pending", None)
            if p is None or p[0] is not cur or (p[1], p[2]) != pos:
                return False
        if head_grads is None:
            head_grads = [None] * len(heads)
        elif isinstance(head_grads, NDArray):
            head_grads = [head_grads]
        if any(g is not None and g._pending is not None
               for g in head_grads):
            return False
        with torch.no_grad():
            for h, (shape, dtype), hg, idx in zip(
                    heads, t.cot_meta, head_grads, range(len(heads))):
                if len(self._cot) <= idx:
                    self._cot.append(torch.empty(
                        (self.k,) + shape, dtype=dtype,
                        device=h._t.device))
                dst = self._cot[idx][cur.k]
                if hg is None:
                    dst.fill_(1)
                else:
                    dst.copy_(hg.tensor().to(dtype))
        cur.state = "stashed"
        autograd._PENDING[0] = _DeferredPending(cur, autograd._ARM_TOKEN[0])
        return True

    # -- forcing and replaying a step for real -------------------------------
    def _force(self, step) -> None:
        """A deferred array of ``step`` is read (or the loop left the
        template): drain, and make the step real."""
        self._force_streak += 1
        if self._force_streak >= _FORCE_BAIL_STREAK:
            self._bail("deferred outputs are read every chunk (a loss "
                       "read, an eager op between forward and backward)")
        if step.state == "stashed":
            pend = autograd._PENDING[0]
            self.flush()
            real = autograd._PendingStep(self._materialize(step),
                                         pend.token if pend else None)
            if isinstance(pend, _DeferredPending) and pend.step is step:
                autograd._PENDING[0] = real
        else:
            self.flush()

    def _materialize(self, step, upto=None):
        """Run ``step``'s calls for real (their graphs replayed, on the
        tape) from its slots, its deferred arrays taking their outputs;
        returns the tape plan of its backward (None with ``upto``)."""
        from .ndarray import NDArray
        t = self.template
        if self.cur is step:
            self.cur = None
        n = len(t.nodes) if upto is None else upto
        vals: List[list] = []
        _SUSPENDED[0] += 1
        try:
            for j in range(n):
                node = t.nodes[j]
                datas = []
                for i in range(node.n_data):
                    src = t.wiring[j][i]
                    datas.append(vals[src[1]][src[2]] if src is not None
                                 else NDArray(self._in[(j, i)][step.k]
                                              .clone(), node.ctx))
                it = iter(datas)
                args = [cached_op._unflatten(c, it) for c in node.consts]
                with autograd._Scope(True, node.train):
                    out = node.cop(*args)
                flat: list = []
                cached_op._flatten(out, flat)
                vals.append(flat)
        finally:
            _SUSPENDED[0] -= 1
        step.fill(lambda pos: vals[pos[0]][pos[1]]._t
                  if pos[0] < n else None)
        if upto is not None:
            return None
        outs = [vals[j][o]._t for j, o in t.heads]
        cots = [c[step.k].clone() for c in self._cot]
        plan = cached_op.tape_plan(outs, cots,
                                   list(autograd._VARS.values()))
        if plan is None:
            raise MXNetError("scan: a buffered step's calls, replayed, "
                             "no longer form a plan of hybridized calls")
        return plan

    # -- buffering -----------------------------------------------------------
    def push(self, pending, prep) -> bool:
        """Buffer one stashed step. False means the caller runs the step
        itself, per step, with the same ``prep`` (its counters already
        advanced)."""
        if self.bailed:
            return False
        tr = self._trainer()
        if tr is None:
            return False
        if not isinstance(pending, _DeferredPending):
            # the step's calls ran (no template yet, or they left it)
            if self.steps:
                self.flush()
            self.adopt(pending.plan)
            return False
        step = pending.step
        if step.runner is not self or step is not self.cur or \
                step.k != len(self.steps) or \
                (self.steps and prep.key != self.preps[0].key):
            # the update's math or tensors changed mid-chunk: drain and
            # run this step per step
            self.flush()
            return False
        step.state = "buffered"
        self.cur = None
        self.steps.append(step)
        self.preps.append(prep)
        self.injects.append(self._draw_injection(tr))
        if len(self.steps) >= self.k:
            self._retire()
        return True

    def _draw_injection(self, trainer):
        """The fault sites' draws for this step, made when it is pushed
        (where the per-step guard makes them)."""
        guard = trainer._grad_guard
        if guard is None or not guard.enabled:
            return (False, False)
        from . import faultinject
        if not faultinject.active():
            return (False, False)
        return (faultinject.should_fail("nan_grad"),
                faultinject.should_fail("scaled_grad"))

    def flush(self) -> None:
        """Drain the buffered steps in order, then make a step still
        being recorded real. With a guard or an injection armed the
        partial chunk runs as the chunk function at its own length; else
        each step runs through the per-step fused consume."""
        if self._draining:
            return
        self._draining = True
        try:
            tr = self._trainer()
            if self.steps and tr is None:
                self.steps, self.preps, self.injects = [], [], []
            if self.steps:
                guard = tr._grad_guard
                if (guard is not None and guard.enabled) or \
                        any(a or b for a, b in self.injects):
                    n = len(self.steps)
                    self._retire()
                    self.flushed_steps += n
                else:
                    steps, preps = self.steps, self.preps
                    self.steps, self.preps, self.injects = [], [], []
                    for step, prep in zip(steps, preps):
                        plan = self._materialize(step)
                        tr._consume_plan(autograd._PendingStep(plan, tr),
                                         prep)
                        self.flushed_steps += 1
                    telemetry.mark_step(n=len(steps))
            cur = self.cur
            if cur is not None and cur.state == "open":
                self._materialize(cur, upto=cur.cursor)
        finally:
            self._draining = False

    # -- retiring a chunk ----------------------------------------------------
    def _retire(self) -> None:
        import numpy as np
        from . import guardrails
        tr = self._trainer()
        steps, preps, injects = self.steps, self.preps, self.injects
        self.steps, self.preps, self.injects = [], [], []
        kk = len(steps)
        opt = tr._optimizer
        guard = tr._grad_guard
        guard_on = guard is not None and guard.enabled
        inject = guard_on and any(a or b for a, b in injects)
        prep = preps[0]
        staged = opt.staged_for(prep, rows=self.k)
        for c, st in enumerate(staged):
            st.stage([(p.vals[c][0], p.vals[c][1], p.rescale)
                      for p in preps])
        names, grads = tr._guard_arrays()
        device = grads[0].device
        if guard_on:
            self._guard_buffers(len(grads), device)
            if inject:
                flags = torch.tensor(injects + [(False, False)]
                                     * (self.k - kk), dtype=torch.bool)
                self._guard_bufs[2].copy_(flags)

        def chunk():
            self._chunk(kk, guard_on, inject, prep, staged, grads)
        key = (self.template.sig, kk, guard_on, inject, prep.key)
        caps = tr._mw_pre_update()
        with telemetry.phase("fused_step"):
            self._run(key, chunk, (prep, staged, grads), device)
        for step in steps:
            step.fill(lambda pos, k=step.k: self._out[pos][k].clone())
        self.retired_chunks += 1
        self._force_streak = 0
        if not guard_on:
            tr._mw_boundary(caps, prep.rescale)
            telemetry.mark_step(n=kk)
            return
        # the chunk's one host read: K verdicts replayed through the
        # guard, so its counters and events are the per-step path's
        vec = self._guard_bufs[0][:kk].cpu().numpy()
        guard.sync_count += 1
        applied = 0
        for row, p in zip(vec, preps):
            flags, norm = guardrails._read_report(row, len(grads))
            proceed, _, _ = guard.evaluate(names, flags, norm,
                                           rescale=p.rescale)
            applied += bool(proceed)
        tr._mw_boundary(caps, prep.rescale)
        telemetry.mark_step(n=kk, skipped=kk - applied)
        if applied < kk:
            # a skipped step advances no counter, as per step
            base = prep.base_counts
            idx = {i for c in prep.calls for i in c[0][3]}
            for i in idx:
                opt._index_update_count[i] = \
                    base.get(i, opt.begin_num_update) + applied
            opt.num_update = max([prep.base_num] +
                                 [opt._index_update_count[i] for i in idx])

    def _guard_buffers(self, n, device):
        if self._guard_bufs is None or \
                self._guard_bufs[0].shape[1] != 2 * n:
            self._guard_bufs = (
                torch.zeros((self.k, 2 * n), dtype=torch.float32,
                            device=device),
                torch.zeros((1,), dtype=torch.int64, device=device),
                torch.zeros((self.k, 2), dtype=torch.bool, device=device))

    def _program(self, key):
        """compilewatch's (Watch, record, new) of chunk ``key``; None
        with telemetry off."""
        if not _cw.enabled():
            return None
        if self._watch is None:
            self._watch = _cw.Watch(
                "scan.fused_chunk", "trainer.step",
                ["template", "steps", "guard", "inject", "update"],
                "tape[%d nodes]x%d steps" % (len(self.template.nodes),
                                             self.k))
        text = ("#%x" % (hash(key[0]) & 0xffffff), "K=%d" % key[1],
                "guard=%d" % key[2], "inject=%d" % key[3],
                "#%x" % (hash(key[4]) & 0xffffff))
        sig = tuple(_cw.value_sig(v, t) for v, t in zip(key, text))
        rec = self._watch.lookup(sig)
        if rec is not None:
            self._watch.hit(rec)
            return self._watch, rec, False
        return self._watch, self._watch.miss(sig), True

    def _run(self, key, fn, keep, device) -> None:
        """The chunk function: eagerly on the CPU and the first time on
        the card, then captured once and replayed."""
        w, rec, new = self._program(key) or (None, None, False)
        if device.type != "cuda":
            _cw.timed(w, rec if new else None, "warmup", fn, flops=True)
            return
        g = self._graphs.get(key)
        if g is None:
            if len(self._graphs) >= 2:
                self._graphs.clear()
            g = self._graphs[key] = _ChunkGraph()
        if not g.warm:
            _cw.timed(w, rec if new else None, "warmup", fn, flops=True)
            g.warm = True
            return
        if g.graph is None:
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            _cw.timed(w, rec, "capture", lambda: cached_op._capture(
                graph, "MXNET_SCAN_STEPS chunk of %d steps" % key[1], fn),
                memory=True)
            g.graph = graph     # a capture that raised leaves none
            g.keep = (keep, [a for a in self.template.leaves],
                      dict(self._in), dict(self._out), list(self._cot),
                      self._guard_bufs)
        g.graph.replay()
        cached_op._REPLAYS["chunk"] += 1

    def _chunk(self, kk, guard_on, inject, prep, staged, grads):
        """Steps 0..kk-1: each forward from its slots, its backward and
        gradient write-back, then its update (with the guard's verdict
        and the planted faults when armed)."""
        t = self.template
        if guard_on:
            verdict, skipped, flags = self._guard_bufs
            skipped.zero_()
        for k in range(kk):
            vals: Dict[tuple, torch.Tensor] = {}
            recs = []
            for j, node in enumerate(t.nodes):
                ins = []
                for i in range(node.n_data):
                    src = t.wiring[j][i]
                    ins.append(vals[(src[1], src[2])].detach()
                               if src is not None else self._in[(j, i)][k])
                ins += [a._t for a in node.params]
                leaves = [cached_op._alias(x, m[4])
                          for x, m in zip(ins, node.key[4])]
                node.cop.n_data = node.n_data
                with autograd._Scope(True, node.train), \
                        torch.enable_grad():
                    outs = node.cop._run(leaves, node.consts, node.ctx,
                                         True, node.key[5])
                node.cop._out_fmt = node.cop._layout_plan = None
                with torch.no_grad():
                    for o, x in enumerate(outs):
                        vals[(j, o)] = x
                        self._out[(j, o)][k].copy_(x)
                recs.append(cached_op._Rec(None, False, leaves, outs))
            cots = [c[k] for c in self._cot]
            plan = cached_op._Plan(recs, t.wiring, t.heads, cots, t.leaves)

            def update(k=k):
                ok = skips = None
                if inject:
                    _plant(grads, flags[k])
                if guard_on:
                    vec = _finite_norm(grads)
                    verdict[k].copy_(vec)
                    ok = (vec[:len(grads)] > 0).all()
                    skips = skipped
                prep.apply(staged, row=k, ok=ok, skipped=skips)
                if guard_on:
                    skipped.add_((~ok).to(torch.int64))
            cached_op._tape_fn(plan, cots, update)
            del plan, recs, vals


def _finite_norm(grads):
    from .ndarray import NDArray, invoke
    return invoke("multi_finite_norm", [NDArray(g) for g in grads],
                  {"num_arrays": len(grads)}).tensor()


def _plant(grads, flags):
    """``guardrails.inject_grad_faults`` as selects: NaN into the first
    gradient where ``flags[0]``, the last times 1e4 where ``flags[1]``."""
    from .ndarray import NDArray, invoke
    g0 = grads[0]
    g0.copy_(torch.where(flags[0], torch.full_like(g0, float("nan")), g0))
    gl = grads[-1]
    scaled = invoke("_mul_scalar", [NDArray(gl)], {"scalar": 1e4}).tensor()
    gl.copy_(torch.where(flags[1], scaled, gl))
