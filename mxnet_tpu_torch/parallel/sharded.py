"""The SPMD sharded training step (counterpart of
``mxnet_tpu/parallel/sharded.py``).

A Gluon net and its loss become one function of named tensors
(:func:`trace_block`: the data ``data0..dataN``, the parameters, the aux
states), and :class:`ShardedTrainStep` trains it over a :class:`~.Mesh`:

* Each local mesh device runs one replica of net+loss on its block of
  the batch (:mod:`._spmd`: the calling thread for one device, a thread
  a device otherwise). Replicas along an axis the data is not split over
  compute the same numbers (the compute on a ``tp`` axis is replicated,
  not split).
* The collectives the reference's partitioner inserts are explicit: the
  gradients are summed over the axes the data is split over (the batch
  axes) in one coalesced buffer a dtype, within the process by the
  kvstore's grouped reduce and across processes by ``all_reduce``; BatchNorm
  inside the step sums its statistics over the same axes
  (``ops/nn.py`` ``_BNTrainFn``); the loss is the f32 sum of the
  per-sample losses over the whole batch.
* A parameter sharded by ``param_rules`` (:func:`shard_params`) is
  stored as each device's shard of the f32 master and of each optimizer
  state; it is gathered over its axes before the forward, its summed
  gradient is cut to the shard, and LAMB's norms sum their partial
  squares over the shard's axes first.
* ``dtype="bfloat16"`` casts the parameters and the floating data inside
  the step only; masters, optimizer states and aux stay f32.
* Each replica draws its dropout seeds from a stream of its own
  (``random.stream``), seeded from ``seed`` and advanced every step; its
  state is the ``rng`` entry of :meth:`ShardedTrainStep.save_states`.
* On a card, with one local device, a step of one signature runs eagerly
  once (on a side stream, as the CachedOp's warm-up), and is captured
  after that into one CUDA graph through ``cached_op._capture`` and
  replayed: updates in place, the data copied into static buffers. When
  the mesh crosses processes, the cross-process reduce cannot be
  captured: the step is split around it (a captured forward+backward,
  the reduce, a captured update); :attr:`ShardedTrainStep.form` says
  which form ran; ``split_update`` captures the two programs too. Under
  ``cached_op.eager()`` the step runs eagerly, as a hybridized block
  does there.
  Several local cards, and the micro-steps and apply steps of
  ``grad_accum``, run eagerly. A capture that fails raises.
* With the layout pass on, a convolution weight whose every use in the
  step is a convolution run channels-last is stored channels-last after
  the step's first run (``_param_transforms``), so no step converts it;
  :meth:`ShardedTrainStep.write_back` gives the net contiguous arrays.
"""
from __future__ import annotations

import contextlib
import re
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError
from . import _spmd
from .collectives import assemble, block_of
from .mesh import Mesh, NamedSharding, P

__all__ = ["shard_params", "ShardedTrainStep", "data_parallel_step",
           "trace_block", "batch_axes"]


def batch_axes(mesh: Mesh):
    """The mesh axes the batch dim is sharded over: ('dcn', 'dp') on a
    mesh with a dcn axis, so the gradient reduction decomposes into the
    in-process and the cross-process stage; else 'dp'."""
    names = [a for a in ("dcn", "dp") if mesh.shape.get(a, 1) > 1]
    if not names:
        return "dp"
    return tuple(names) if len(names) > 1 else names[0]


# ---------------------------------------------------------------------------
# the functional form of net + loss
# ---------------------------------------------------------------------------
def _collect(net, loss_fn) -> "OrderedDict":
    params = OrderedDict(net.collect_params().items())
    if hasattr(loss_fn, "collect_params"):
        for k, v in loss_fn.collect_params().items():
            if k in params and params[k] is not v:
                raise MXNetError(
                    "ShardedTrainStep: loss parameter %r collides "
                    "with a distinct net parameter of the same "
                    "name; use a different prefix" % k)
            params[k] = v
    return params


class _Traced:
    """net+loss as a function of named tensors: ``fn(feed, ctx)`` runs the
    net on ``data0..`` with every parameter and aux state read from
    ``feed`` (the aux states updated in place, as FMutateInputs writes
    them) and returns the loss tensor and the layout plan of the run
    (None with the layout pass off; its decisions, and the uses of the
    tensors in ``track``)."""

    def __init__(self, net, loss_fn, n_data_inputs: int):
        from ..symbol.layout_opt import layout_opt_enabled
        self.net, self.loss_fn = net, loss_fn
        self.n_data = int(n_data_inputs)
        self.params = _collect(net, loss_fn)
        self._aux_names = {n for n, p in self.params.items() if p._is_aux}
        self._param_transforms: Dict[str, str] = {}
        self.layout = layout_opt_enabled()

    def __call__(self, feed: Dict[str, torch.Tensor], ctx, track=()):
        from .. import autograd, cached_op
        from ..gluon.parameter import substitute
        from ..ndarray import NDArray
        from ..symbol import layout_opt as lo
        mapping = {p: NDArray(feed[n], ctx) for n, p in self.params.items()}
        datas = [NDArray(feed["data%d" % i], ctx) for i in range(self.n_data)]

        def body():
            with cached_op.eager(), substitute(mapping), \
                    autograd.record(train_mode=True):
                out = self.net(datas[0], *datas[1:-1])
                loss = self.loss_fn(out, datas[-1])
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            return [loss.tensor()]
        plan = None
        if self.layout:
            plan = lo.LayoutPlan()
            for t in track:
                plan.track(t)
            body = lo.convert_layout(lo.elide_conv_bias_into_bn(body, plan),
                                     plan)
        cached_op._TLS.calls = getattr(cached_op._TLS, "calls", 0) + 1
        try:
            with ctx:
                loss = body()[0]
        finally:
            cached_op._TLS.calls -= 1
        return loss, plan


def trace_block(net, loss_fn, n_data_inputs: int = 2):
    """net+loss as one function of named tensors: ``(fn, data_names,
    param_names, needs_rng)``, the data named data0..dataN (the last is
    the label fed to the loss), ``fn._aux_names`` the aux states
    (BatchNorm's moving statistics), ``fn._param_transforms`` the
    parameters a step stores channels-last. ``needs_rng`` is None: the
    reference's key has no counterpart, each replica's random stream is
    installed around every run."""
    fn = _Traced(net, loss_fn, n_data_inputs)
    data_names = ["data%d" % i for i in range(n_data_inputs)]
    return fn, data_names, list(fn.params), None


def shard_params(param_shapes: Dict[str, Tuple[int, ...]], mesh: Mesh,
                 rules: Optional[Sequence[Tuple[str, P]]] = None
                 ) -> Dict[str, NamedSharding]:
    """Map parameter names to NamedShardings via first-match regex rules;
    default = fully replicated (pure DP). An axis that does not divide
    its dimension is dropped."""
    rules = list(rules or [])
    out = {}
    for name, shape in param_shapes.items():
        spec = P()
        for pattern, pspec in rules:
            if re.search(pattern, name):
                fixed = []
                for dim, ax in zip(shape, tuple(pspec) + (None,) * len(shape)):
                    if ax is None:
                        fixed.append(None)
                        continue
                    size = mesh.shape[ax] if isinstance(ax, str) else \
                        int(np.prod([mesh.shape[a] for a in ax]))
                    fixed.append(ax if dim % size == 0 else None)
                spec = P(*fixed)
                break
        out[name] = NamedSharding(mesh, spec)
    return out


# ---------------------------------------------------------------------------
# optimizer updates over the op registry
# ---------------------------------------------------------------------------
def _n_states(optimizer: str, momentum: float) -> int:
    if optimizer == "sgd":
        return 1 if momentum else 0
    if optimizer in ("adam", "adamw", "lamb"):
        return 2
    raise MXNetError("ShardedTrainStep: unknown optimizer %r "
                     "(sgd|adam|adamw|lamb)" % optimizer)


def _sq_norm(x: torch.Tensor, m, axes) -> torch.Tensor:
    """‖x‖ of the whole parameter of which ``x`` is member ``m``'s shard
    over ``axes`` (the partial sums of squares summed first)."""
    s = (x.float() * x.float()).sum()
    if axes and m.axis_size(axes) > 1:
        s = m.run.exchange(m, "sum", axes, s.reshape(1),
                           ("allreduce", 4, None)).reshape(())
    return torch.sqrt(s)


def _apply_update(optimizer: str, hp: Dict[str, float], w, g, states, t,
                  m=None, shard_axes=()):
    """One parameter update; returns (new_w, new_states). ``t`` is the
    step count (a device tensor), for the bias corrections folded into
    lr as the reference folds them."""
    from ..ops import get_op
    lr, wd, mom = hp["lr"], hp["wd"], hp["momentum"]
    clip = hp.get("clip_gradient", -1.0)
    rs = hp.get("rescale_grad", 1.0)
    if optimizer == "sgd":
        if mom:
            new_w, new_m = get_op("sgd_mom_update").impl(
                w, g, states[0], lr=lr, momentum=mom, wd=wd,
                rescale_grad=rs, clip_gradient=clip)
            return new_w, (new_m,)
        return get_op("sgd_update").impl(
            w, g, lr=lr, wd=wd, rescale_grad=rs, clip_gradient=clip), ()
    if optimizer in ("adam", "adamw"):
        b1, b2 = hp["beta1"], hp["beta2"]
        lr_t = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        if optimizer == "adam":
            new_w, mm, v = get_op("adam_update").impl(
                w, g, states[0], states[1], lr=lr_t, beta1=b1, beta2=b2,
                epsilon=hp["epsilon"], wd=wd, rescale_grad=rs,
                clip_gradient=clip)
        else:
            # eta 1: the decoupled wd term is not scaled by the
            # correction, as in the eager AdamW
            new_w, mm, v = get_op("adamw_update").impl(
                w, g, states[0], states[1], lr=lr_t, beta1=b1, beta2=b2,
                epsilon=hp["epsilon"], wd=wd, eta=1.0, rescale_grad=rs,
                clip_gradient=clip)
        return new_w, (mm, v)
    if optimizer == "lamb":
        b1, b2 = hp["beta1"], hp["beta2"]
        upd, mm, v = get_op("lamb_update_phase1").impl(
            w, g, states[0], states[1], beta1=b1, beta2=b2,
            epsilon=hp["epsilon"], t=t, bias_correction=True, wd=wd,
            rescale_grad=rs, clip_gradient=clip)
        r1 = _sq_norm(w, m, shard_axes) if m is not None else \
            torch.linalg.norm(w)
        r2 = _sq_norm(upd, m, shard_axes) if m is not None else \
            torch.linalg.norm(upd)
        new_w = get_op("lamb_update_phase2").impl(w, upd, r1, r2, lr=lr)
        return new_w, (mm, v)
    raise MXNetError("unknown optimizer %r" % optimizer)


# ---------------------------------------------------------------------------
# a replica's state
# ---------------------------------------------------------------------------
class _Replica:
    """What one local mesh device holds: its shard of every master and
    optimizer state, its aux copies, the step count ``t`` (+1, f32) and
    its random stream."""

    def __init__(self, m, params, aux, n_states, seed):
        dev = m.torch_device
        self.params = params
        self.states = {k: tuple(torch.zeros_like(v) for _ in range(n_states))
                       for k, v in params.items()}
        self.aux = aux
        self.accum = None
        # the weight conversions of the last run's layout plan; the first
        # run's plan and the parameters' tensors it tracked (for the
        # hoisting, then dropped)
        self.conversions = None
        self.first_plan = self.tracked = None
        self.t = torch.ones((), dtype=torch.float32, device=dev)
        self.gen = torch.Generator(device=dev)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=dev) \
            if dev.type == "cuda" else None
        self.reseed(seed, m.device.id)

    def reseed(self, seed: int, dev_id: int):
        s = (int(seed) * 1000003 + dev_id) % (1 << 63)
        self.gen.manual_seed(s)
        if self.counter is not None:
            self.counter.fill_((s % (1 << 31)) << 32)

    def carrier(self) -> np.ndarray:
        """The random stream's state as bytes (the counter, then the
        generator's state)."""
        parts = [self.gen.get_state().numpy().view(np.uint8)]
        if self.counter is not None:
            parts.insert(0, np.asarray(
                [int(self.counter.item())], np.int64).view(np.uint8))
        return np.concatenate(parts)

    def restore(self, blob: np.ndarray):
        blob = np.asarray(blob, np.uint8)
        if self.counter is not None:
            self.counter.fill_(int(blob[:8].view(np.int64)[0]))
            blob = blob[8:]
        self.gen.set_state(torch.from_numpy(blob.copy()))

    @contextlib.contextmanager
    def stream(self):
        from .. import random as _random
        with _random.stream(self.gen, self.counter):
            yield


def _float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


class _Program:
    """One signature's captured step: static data buffers, the graph(s),
    the loss buffer; ``form`` 'captured' or 'split' (then ``flats`` the
    first graph's gradients and loss, ``graph_b`` the update's graph and
    its buffers of the summed gradients)."""

    __slots__ = ("datas", "graph", "graph_b", "loss", "form", "flats")

    def __init__(self):
        self.datas = self.graph = self.graph_b = self.loss = None
        self.form = None
        self.flats = None


class ShardedTrainStep:
    """One-program-per-step SPMD trainer (see the module's text).

    ``step(*data) -> loss``. With ``grad_accum=N``, N-1 calls accumulate
    the summed gradients and every Nth applies the update
    (``rescale_grad = 1/N``); ``split_update`` runs the forward+backward
    and the update as two programs."""

    def __init__(self, net, loss_fn, mesh: Mesh, optimizer: str = "sgd",
                 lr: float = 0.01, momentum: float = 0.9, wd: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, clip_gradient: Optional[float] = None,
                 param_rules: Optional[Sequence[Tuple[str, P]]] = None,
                 data_specs: Optional[Sequence[P]] = None,
                 n_data_inputs: int = 2, dtype=None,
                 grad_accum: int = 1, seed: int = 0,
                 split_update: bool = False):
        self.mesh = mesh
        fn, data_names, param_names, _ = trace_block(net, loss_fn,
                                                     n_data_inputs)
        self._fn = fn
        self._data_names = data_names
        self._param_transforms = fn._param_transforms
        self._aux_names = [n for n in param_names if n in fn._aux_names]
        self._param_names = [n for n in param_names
                             if n not in fn._aux_names]
        self._optimizer = optimizer
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise MXNetError("grad_accum must be >= 1")
        if split_update and self.grad_accum > 1:
            raise MXNetError(
                "split_update is not supported with grad_accum > 1 "
                "(the accumulate path already separates the update)")
        self._split_update = bool(split_update)
        self._hp = dict(lr=lr, momentum=momentum, wd=wd, beta1=beta1,
                        beta2=beta2, epsilon=epsilon,
                        clip_gradient=-1.0 if clip_gradient is None
                        else clip_gradient,
                        rescale_grad=1.0 / self.grad_accum)
        from ..base import torch_dtype
        self._dtype = torch_dtype(dtype) if dtype is not None else None
        self._seed = int(seed)
        self._t = 0
        self._micro_count = 0
        self._loss_fn = loss_fn
        self._n_states = _n_states(optimizer, momentum)

        init = {}
        for name in self._param_names + self._aux_names:
            p = fn.params[name]
            try:
                data = p.data()
            except Exception as e:
                raise MXNetError(
                    "ShardedTrainStep: parameter %s is not materialized "
                    "(%s). Initialize the net and run one eager forward "
                    "to resolve deferred shapes before sharding." % (name, e))
            v = data.tensor().detach()
            if _float(v):
                v = v.float()
            init[name] = v
        self.param_shardings = shard_params(
            {k: tuple(init[k].shape) for k in self._param_names}, mesh,
            param_rules)
        self.state_shardings = {k: tuple(self.param_shardings[k]
                                         for _ in range(self._n_states))
                                for k in self._param_names}
        if data_specs is None:
            data_specs = [P(batch_axes(mesh)) for _ in data_names]
        self.data_shardings = [NamedSharding(mesh, s) for s in data_specs]
        axes = []
        for s in data_specs:
            for ax in tuple(s):
                for a in (_spmd.axes_of(ax) if ax is not None else ()):
                    if a not in axes:
                        axes.append(a)
        # the axes the batch is split over, in mesh order: the gradient
        # and the loss are summed over them
        self._batch_axes = tuple(a for a in mesh.axis_names if a in axes)
        self._run0 = _spmd.Run(mesh)
        self._replicas: List[_Replica] = []
        for m in self._run0.members:
            dev = m.torch_device
            params = {k: self._shard(init[k], k, m).to(dev, copy=True)
                      for k in self._param_names}
            aux = {k: init[k].to(dev, copy=True) for k in self._aux_names}
            self._replicas.append(_Replica(m, params, aux, self._n_states,
                                           self._seed))
        self._cuda = self._run0.members[0].torch_device.type == "cuda"
        self._remote = len(mesh.process_indices) > 1
        self._hoisted = False
        self._flops = None
        self._inventory = None
        self.form = None
        # the last run's weight conversions (layout pass) and the host
        # seconds of the last cross-process reduce of a split step
        self.stats = {"weight_conversions": None, "reduce_s": None}
        self._build()

    # ------------------------------------------------------------------
    def _spec(self, name) -> tuple:
        return tuple(self.param_shardings[name].spec)

    def _shard_axes(self, name) -> tuple:
        out = []
        for ax in self._spec(name):
            if ax is not None:
                out += list(_spmd.axes_of(ax))
        return tuple(out)

    def _shard(self, full: torch.Tensor, name, m) -> torch.Tensor:
        return block_of(full, self.param_shardings[name].spec, m.run,
                        m.coords)

    def _build(self):
        """Drop the captured programs (the hyperparameters in ``_hp``
        are read again by the next step)."""
        self._programs: Dict[tuple, _Program] = {}
        self._pool = None

    # ------------------------------------------------------------------
    # one replica's step, in phases
    # ------------------------------------------------------------------
    def _forward_backward(self, m, rep: _Replica, datas, first: bool):
        """Gradients of the replica's f32 loss sum (the whole parameters,
        not yet summed over the batch axes) and the loss sum."""
        with torch.enable_grad():
            return self._fwd_bwd(m, rep, datas, first)

    def _fwd_bwd(self, m, rep, datas, first):
        feed = {}
        leaves = []
        for k in self._param_names:
            w = rep.params[k]
            for dim, ax in enumerate(self._spec(k)):
                if ax is not None:
                    from .collectives import allgather
                    w = allgather(w, ax, axis=dim)
            from ..cached_op import _alias
            leaf = _alias(w, True)
            leaves.append(leaf)
            feed[k] = leaf
        if self._dtype is not None:
            for k in self._param_names:
                feed[k] = feed[k].to(self._dtype)
        track = [feed[k] for k in self._param_names] if first else []
        for k in self._aux_names:
            feed[k] = rep.aux[k]
        for name, d in zip(self._data_names, datas):
            if self._dtype is not None and _float(d):
                d = d.to(self._dtype)
            feed[name] = d
        loss, plan = self._fn(feed, m.device.context, track=track)
        loss = loss.float().sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g.detach()
                 for g, leaf in zip(grads, leaves)]
        rep.conversions = None if plan is None else plan.weight_conversions
        if first and plan is not None:
            rep.first_plan = plan
            rep.tracked = {k: feed[k] for k in self._param_names}
        return grads, loss.detach()

    def _flatten(self, grads) -> List[torch.Tensor]:
        """The gradients in one flat buffer a dtype."""
        by = OrderedDict()
        for i, g in enumerate(grads):
            by.setdefault(g.dtype, []).append(i)
        return [torch.cat([grads[i].reshape(-1) for i in idx])
                for idx in by.values()]

    def _unflatten(self, flats, grads):
        by = OrderedDict()
        for i, g in enumerate(grads):
            by.setdefault(g.dtype, []).append(i)
        out = [None] * len(grads)
        for flat, idx in zip(flats, by.values()):
            off = 0
            for i in idx:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view(grads[i].shape)
                off += n
        return out

    def _reduce(self, m, grads, loss):
        """The gradients (through one flat buffer a dtype) and the loss
        summed over the batch axes."""
        if not self._batch_axes or m.axis_size(self._batch_axes) == 1:
            return grads, loss
        ax = self._batch_axes
        flats = [m.run.exchange(m, "sum", ax, f,
                                ("allreduce", f.numel() * f.element_size(),
                                 None)) for f in self._flatten(grads)]
        loss = m.run.exchange(m, "sum", ax, loss.reshape(1),
                              ("allreduce", 4, None)).reshape(())
        return self._unflatten(flats, grads), loss

    def _local_grads(self, m, grads):
        """Each summed gradient cut to this device's shard."""
        return [self._shard(g, k, m) for g, k in zip(grads,
                                                     self._param_names)]

    def _update(self, m, rep: _Replica, grads):
        hp = self._hp
        with torch.no_grad():
            for k, g in zip(self._param_names, grads):
                w = rep.params[k]
                new_w, new_s = _apply_update(
                    self._optimizer, hp, w, g.float(), rep.states[k], rep.t,
                    m, self._shard_axes(k))
                w.copy_(new_w)
                for s, ns in zip(rep.states[k], new_s):
                    s.copy_(ns)
            rep.t.add_(1.0)

    def _accumulate(self, rep: _Replica, grads):
        with torch.no_grad():
            if rep.accum is None:
                rep.accum = [g.float().clone() for g in grads]
            else:
                for a, g in zip(rep.accum, grads):
                    a.add_(g.float())

    def _replica_step(self, m, datas, mode: str, first: bool):
        """``mode``: 'fused' (update), 'micro' (accumulate only), 'apply'
        (accumulated + this step's gradients, then update)."""
        rep = self._replicas[m.pos]
        with rep.stream():
            grads, loss = self._forward_backward(m, rep, datas, first)
        grads, loss = self._reduce(m, grads, loss)
        grads = self._local_grads(m, grads)
        if mode == "micro":
            self._accumulate(rep, grads)
            return loss
        if mode == "apply":
            self._accumulate(rep, grads)
            grads, rep.accum = rep.accum, None
        self._update(m, rep, grads)
        return loss

    def _setup(self, m):
        m.state["batch_axes"] = self._batch_axes
        return contextlib.nullcontext()

    # ------------------------------------------------------------------
    def _blocks(self, data) -> List[List[torch.Tensor]]:
        """Each local device's block of each data input (a process of a
        mesh over processes passes its local slice)."""
        from ..ndarray import NDArray, host_tensor
        ts = []
        for d in data:
            if isinstance(d, NDArray):
                ts.append(d.tensor())
            elif isinstance(d, torch.Tensor):
                ts.append(d)
            else:
                ts.append(host_tensor(np.asarray(d)))
        run = self._run0
        out = []
        for m in run.members:
            dev = m.torch_device
            row = []
            for t, sh in zip(ts, self.data_shardings):
                spec = tuple(sh.spec)
                if self._remote:
                    row.append(self._local_block(t, spec, m).to(dev))
                else:
                    row.append(block_of(t, spec, run, m.coords).to(dev))
            out.append(row)
        return out

    def _local_block(self, t, spec, m):
        """The block of member ``m`` in this process's slice ``t``."""
        run = self._run0
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = _spmd.axes_of(ax)
            idx = [run.group_position(x.coords, axes) for x in run.members]
            lo, hi = min(idx), max(idx)
            k = t.shape[dim] // (hi - lo + 1)
            t = t.narrow(dim, (run.group_position(m.coords, axes) - lo) * k,
                         k)
        return t

    def _prog_key(self, blocks):
        return tuple((tuple(t.shape), str(t.dtype)) for t in blocks[0])

    def step(self, *data, rng=None):
        """Run one (micro-)step; returns the loss, the f32 sum of the
        per-sample losses over the whole batch (an NDArray). A process of
        a mesh over processes passes its local slice of the batch."""
        from .. import commwatch, telemetry
        if rng is not None:
            for m, rep in zip(self._run0.members, self._replicas):
                rep.reseed(int(rng), m.device.id)
        blocks = self._blocks(data)
        if self.grad_accum > 1 and self._micro_count < self.grad_accum - 1:
            loss = self._eager(blocks, "micro")
            self._micro_count += 1
            return self._loss_nd(loss)
        mode = "apply" if self.grad_accum > 1 else "fused"
        key = ("sharded_step", id(self), self._prog_key(blocks))
        watch = contextlib.nullcontext()
        if commwatch.enabled():
            if not commwatch.has_program(key) and \
                    self._inventory is not None:
                commwatch.register_program(
                    key, "sharded_step", mesh=self.mesh, flops=self._flops,
                    collectives=self._inventory)
            watch = commwatch.program_watch(key, "sharded_step")
        with watch:
            loss = self._run(blocks, mode, watch)
            if commwatch.enabled() and self._cuda:
                # the watch times the step's completion, not its enqueue
                torch.cuda.synchronize(loss.device)
        if isinstance(watch, commwatch.program_watch) and \
                self._inventory is None:
            inv = commwatch.program_inventory(key)
            if inv is not None:
                self._inventory, _ = inv
        self._t += 1
        self._micro_count = 0
        telemetry.mark_step()
        return self._loss_nd(loss)

    def _loss_nd(self, loss):
        from ..ndarray import NDArray
        return NDArray(loss, self._run0.members[0].device.context)

    def _eager(self, blocks, mode, first=False, count=False):
        """The step run eagerly by every local replica: the loss, and with
        ``count`` also the FLOPs of the process's replicas (None where
        they cannot be counted)."""
        from .. import commwatch
        from ..compilewatch import count_flops
        run = _spmd.Run(self.mesh, collector=commwatch.current_collector())

        def one(m):
            body = lambda: self._replica_step(m, blocks[m.pos], mode, first)
            return count_flops(body) if count else (body(), None)
        res = run.execute(one, self._setup)
        flops = [f for _, f in res if f is not None]
        if count:
            return res[0][0], float(sum(flops)) if flops else None
        return res[0][0]

    def _run(self, blocks, mode, watch):
        """The applied step: eager on the CPU and over several local
        cards; on one local card, eager the first time a signature runs,
        then captured and replayed."""
        first = not self._hoisted
        key = self._prog_key(blocks)
        prog = self._programs.get(key)
        from .. import cached_op
        capture = self._cuda and len(self._run0.members) == 1 and \
            mode == "fused" and cached_op.outermost()
        if not capture or prog is None:
            from .. import commwatch
            count = first and isinstance(watch, commwatch.program_watch)
            if capture:
                from ..cached_op import _on_side_stream
                side = _on_side_stream(self._run0.members[0].torch_device)
            else:
                side = contextlib.nullcontext()
            with side:
                if count:
                    loss, flops = self._eager(blocks, mode, first, True)
                    self._flops = watch.flops = flops
                else:
                    loss = self._eager(blocks, mode, first)
            self._conversions()
            if first:
                self._hoist()
            if capture:
                self._programs[key] = _Program()
            if self.form is None or not capture:
                self.form = "eager"
            return loss
        if prog.graph is None:
            self._capture(prog, blocks)
        else:
            with torch.no_grad():
                for s, d in zip(prog.datas, blocks[0]):
                    s.copy_(d)
        return self._replay(prog)

    def _conversions(self):
        """Weight conversions the layout pass made in the last traced run
        (the capture's, for a captured step)."""
        self.stats["weight_conversions"] = self._replicas[0].conversions

    # ------------------------------------------------------------------
    def _hoist(self):
        """After the first run: store channels-last each weight whose
        every use was a convolution that ran channels-last, with its
        optimizer states (the reference's hoisted weight transposes)."""
        self._hoisted = True
        rep0 = self._replicas[0]
        plan, tracked = rep0.first_plan, rep0.tracked
        for rep in self._replicas:
            rep.first_plan = rep.tracked = None
        if plan is None or not tracked:
            return
        names = [k for k, t in tracked.items() if t.dim() == 4
                 and plan.hoistable(t)]
        cl = torch.channels_last
        for k in names:
            self._param_transforms[k] = "channels_last"
            for rep in self._replicas:
                rep.params[k] = rep.params[k].contiguous(memory_format=cl)
                rep.states[k] = tuple(s.contiguous(memory_format=cl)
                                      for s in rep.states[k])
                if rep.accum is not None:
                    i = self._param_names.index(k)
                    rep.accum[i] = rep.accum[i].contiguous(memory_format=cl)

    def _capture(self, prog: _Program, blocks):
        """Capture the step of this signature: whole, or split around
        the cross-process reduce (and, with ``split_update``, in two
        programs)."""
        from ..cached_op import _capture
        run = _spmd.Run(self.mesh)
        rm = run.members[0]
        rm.state["batch_axes"] = self._batch_axes
        rep = self._replicas[0]
        torch.cuda.synchronize()
        prog.datas = [d.clone() for d in blocks[0]]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prev = _spmd._TLS.__dict__.get("member")
        _spmd._TLS.member = rm
        try:
            if not self._remote and not self._split_update:
                prog.form = "captured"
                g = torch.cuda.CUDAGraph()
                with rep.stream():
                    prog.loss = _capture(
                        g, "ShardedTrainStep", lambda: self._replica_step(
                            rm, prog.datas, "fused", False), pool=self._pool)
                prog.graph = g
            else:
                prog.form = "split"
                ga = torch.cuda.CUDAGraph()

                def part_a():
                    return self._forward_backward(rm, rep, prog.datas, False)
                with rep.stream():
                    grads, loss = _capture(ga, "ShardedTrainStep (forward+"
                                           "backward)", part_a,
                                           pool=self._pool)
                prog.flats = (grads, loss)
                prog.graph = ga
                gb = torch.cuda.CUDAGraph()
                red = [torch.empty_like(g) for g in grads]

                def part_b():
                    self._update(rm, rep, self._local_grads(rm, red))
                _capture(gb, "ShardedTrainStep (update)", part_b,
                         pool=self._pool)
                prog.graph_b = (gb, red)
                prog.loss = torch.empty_like(loss)
        finally:
            _spmd._TLS.member = prev
        self.form = prog.form
        self._conversions()

    def _replay(self, prog: _Program):
        if prog.form == "captured":
            prog.graph.replay()
            return prog.loss.clone()
        prog.graph.replay()
        grads, loss = prog.flats
        run = _spmd.Run(self.mesh)
        rm = run.members[0]
        rm.state["batch_axes"] = self._batch_axes
        gb, red = prog.graph_b
        with torch.no_grad():
            t0 = time.perf_counter()
            summed, tot = self._reduce(rm, grads, loss)
            self.stats["reduce_s"] = time.perf_counter() - t0
            for r, g in zip(red, summed):
                r.copy_(g)
        gb.replay()
        return tot.clone()

    # ------------------------------------------------------------------
    # the state, whole
    # ------------------------------------------------------------------
    def _whole(self, per_member: List[torch.Tensor], spec) -> torch.Tensor:
        if self._remote and any(a is not None for a in spec):
            raise MXNetError("ShardedTrainStep: gathering a parameter "
                             "sharded across processes is not supported")
        t = assemble(per_member, spec, self._run0)
        return t.clone(memory_format=torch.contiguous_format)

    @property
    def params(self) -> Dict[str, "object"]:
        """The f32 masters, whole, as NDArrays."""
        from ..ndarray import NDArray
        ctx = self._run0.members[0].device.context
        return {k: NDArray(self._whole([r.params[k] for r in self._replicas],
                                       self._spec(k)), ctx)
                for k in self._param_names}

    @property
    def states(self) -> Dict[str, tuple]:
        from ..ndarray import NDArray
        ctx = self._run0.members[0].device.context
        return {k: tuple(NDArray(self._whole(
            [r.states[k][i] for r in self._replicas], self._spec(k)), ctx)
            for i in range(self._n_states)) for k in self._param_names}

    @property
    def aux(self) -> Dict[str, "object"]:
        from ..ndarray import NDArray
        ctx = self._run0.members[0].device.context
        return {k: NDArray(self._replicas[0].aux[k].clone(), ctx)
                for k in self._aux_names}

    def _carriers(self) -> np.ndarray:
        """Every mesh device's random stream, in mesh order."""
        local = [r.carrier() for r in self._replicas]
        if not self._remote:
            return np.stack(local)
        import torch.distributed as tdist
        got = [None] * len(self.mesh.process_indices)
        tdist.all_gather_object(got, local)
        return np.stack([c for part in got for c in part])

    def save_states(self, fname):
        """Write params + optimizer states + aux + t + rng to one npz.
        Over processes every process calls it; rank 0 writes."""
        from .. import dist
        if self._micro_count:
            raise MXNetError(
                "save_states mid-gradient-accumulation (%d of %d "
                "micro-steps pending) — checkpoint at an apply "
                "boundary" % (self._micro_count, self.grad_accum))
        blob = {}
        for k, v in self.params.items():
            blob["p:" + k] = v.tensor().cpu().numpy()
        for k, v in self.aux.items():
            blob["a:" + k] = v.tensor().cpu().numpy()
        for k, states in self.states.items():
            for i, s in enumerate(states):
                blob["s%d:%s" % (i, k)] = s.tensor().cpu().numpy()
        blob["t"] = np.asarray(self._t, np.int64)
        blob["rng"] = self._carriers()
        if dist.rank() == 0:
            with open(fname, "wb") as f:
                np.savez(f, **blob)

    def load_states(self, fname):
        """Restore a :meth:`save_states` file in place (captured graphs
        stay valid); the next step continues where the saved run left off.
        A file without ``rng`` keeps the current streams. Pending
        accumulation is discarded."""
        from ..ndarray import host_tensor
        with open(fname, "rb") as f:
            blob = dict(np.load(f))
        run = self._run0

        def put(dst, arr, name):
            src = host_tensor(np.asarray(arr)).float() if \
                _float(dst) else host_tensor(np.asarray(arr))
            dst.copy_(self._shard(src, name, m) if name else src)
        with torch.no_grad():
            for m, rep in zip(run.members, self._replicas):
                for k in self._param_names:
                    put(rep.params[k], blob["p:" + k], k)
                    for i, s in enumerate(rep.states[k]):
                        put(s, blob["s%d:%s" % (i, k)], k)
                for k in self._aux_names:
                    put(rep.aux[k], blob["a:" + k], None)
                rep.t.fill_(float(int(blob["t"]) + 1))
                rep.accum = None
        if "rng" in blob:
            rng = np.asarray(blob["rng"])
            for m, rep in zip(run.members, self._replicas):
                rep.restore(rng[m.device.id])
        self._t = int(blob["t"])
        self._micro_count = 0

    def write_back(self, net):
        """Copy the masters (contiguous, in the documented layouts) and
        the aux states back into the net (and a parametric loss)."""
        params = _collect(net, self._loss_fn)
        for name, val in list(self.params.items()) + list(self.aux.items()):
            params[name].set_data(val.tensor().contiguous())


def data_parallel_step(loss_fn: Callable, mesh: Mesh, lr: float = 0.01):
    """A minimal SGD step for a plain function: ``step(params, batch) ->
    (new_params, loss)`` with ``params`` a dict of tensors and
    ``loss_fn(params, batch)`` a scalar tensor. The reference replicates
    the parameters and splits the batch over 'dp', and its partitioner
    makes the gradient the whole batch's; the port computes that same
    gradient on the mesh's first local device."""
    dev = _spmd.Run(mesh).members[0].torch_device

    def step(params, batch):
        from ..ndarray import NDArray, host_tensor

        def tensor(x):
            if isinstance(x, NDArray):
                x = x.tensor()
            elif not isinstance(x, torch.Tensor):
                x = host_tensor(np.asarray(x))
            return x.to(dev)
        leaves = {k: tensor(v).detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, tensor(batch))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = {k: w.detach() - lr * g
                   for (k, w), g in zip(leaves.items(), grads)}
        return new, loss.detach()
    return step
