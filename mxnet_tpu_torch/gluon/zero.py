"""ZeRO weight-update sharding for the data-parallel Trainer (counterpart
of ``mxnet_tpu/gluon/zero.py``).

The replicated step sums every gradient on every replica and runs the
same update N times, each replica holding the whole optimizer state.
With ``MXNET_ZERO=1`` an eligible Trainer instead:

1. **reduce-scatters** the gradients over its replica contexts: each
   replica receives the summed values of a 1/N fragment of every
   parameter;
2. **updates its fragments only**: the optimizer state is allocated
   sharded, one ``(1, C)`` buffer a kind a replica, never whole;
3. **all-gathers** the updated fragments, so every replica holds the
   whole new weights, bit for bit the same on each.

Layout: the parameters are grouped by dtype; in a group each one is
flattened, zero-padded to a multiple of N and split into N fragments,
and replica r owns fragment r of every parameter at a static offset of
its group's ``(C,)`` shard. With ``MXNET_ZERO_DCN=k`` the replicas form
a k x (N / k) dcn x ici mesh: the reduce-scatter runs RS(ici) then
RS(dcn), the all-gather AG(dcn) then AG(ici), and position p owns
fragment ``(p % n_ici) * k + p // n_ici``.

The step runs eagerly, one thread a replica context (the SPMD runtime
of :mod:`mxnet_tpu_torch.parallel`: a mesh of contexts, its
``reduce_scatter`` and ``allgather``), on the CPU and on a mesh that
mixes a card and the host alike. Each fragment's update is the
optimizer's own registry op on the owned slice
(``Optimizer.zero_fragment_update``): the multi-tensor ops the
replicated Trainer's ``update_multi`` runs when it aggregates, else the
one-tensor ops, so the two paths take the same steps bit for bit on the
same sums. With ``MXNET_KVSTORE_QUANTIZE`` the reduce-scatter and the
all-gather ride the quantized wire (:mod:`..parallel.quantize`) with an
error-feedback residual each (one gradient-domain ``(1, N * C)`` buffer
and one shard-domain ``(1, C)`` buffer a group and replica).

Grad guard: with one active the step splits into ``reduce`` (the
reduce-scatter and a per-fragment report of non-finite counts and
squared norms, summed across the replicas) and ``update`` (the shard
update with the verdict's per-fragment coefficient, then the
all-gather), with one host read of the small report between them and
the verdict from the shared ``GradGuard.evaluate``. With modelwatch
sampling, the report also carries each fragment's weight norm and the
update norms, read at the next sampled step's host read.

Checkpoints stay topology-free: :meth:`ZeroEngine.serialized_states`
pickles the replicated layout a replicated Trainer writes (byte for
byte after the same steps), and :meth:`load_serialized_states` re-slices
such a blob onto any replica count, the residuals of the quantized wire
included.

The documented divergence from the replicated path: after ``step()``
each replica's gradient arrays keep their LOCAL values; the summed
gradients exist only scattered inside the step.
"""
from __future__ import annotations

import logging
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from .. import telemetry

__all__ = ["ZeroEngine", "eligibility", "DONE", "SKIPPED", "BAIL"]

_LOG = logging.getLogger("mxnet_tpu_torch.zero")

DONE = "done"          # the sharded step ran (weights and states moved)
SKIPPED = "skipped"    # the guard skipped the step (counted, no update)
BAIL = "bail"          # a structural change: the replicated path takes over


def _frag_len(size: int, n: int) -> int:
    return -(-size // n)


class _Item:
    __slots__ = ("idx", "param", "shape", "size", "frag", "offset", "fi",
                 "gi", "pos")

    def __init__(self, idx, param, shape, size, frag, offset, fi, gi, pos):
        self.idx = idx          # the Trainer's parameter index
        self.param = param
        self.shape = shape
        self.size = size
        self.frag = frag        # fragment length a replica (padded)
        self.offset = offset    # the fragment's offset in its group shard
        self.fi = fi            # flat fragment index (hyperparameter row)
        self.gi = gi            # group index
        self.pos = pos          # position in the per-step argument lists


class _Group:
    __slots__ = ("dtype", "items", "C")

    def __init__(self, dtype):
        self.dtype = dtype      # torch dtype
        self.items: List[_Item] = []
        self.C = 0


def _nbytes_of(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# the eligibility ladder, one reason a rung, in the reference's order
# ---------------------------------------------------------------------------
def eligibility(trainer) -> Tuple[bool, Optional[str]]:
    """``(ok, reason if not)`` for sharding this Trainer's update. The
    Trainer warns once with the reason when ``MXNET_ZERO`` is on."""
    from .. import config as _cfg
    from .. import kvstore as kvs_mod
    if not _cfg.get("MXNET_ZERO"):
        return False, None
    ctxs = trainer._contexts
    if len(ctxs) < 2:
        return False, "single replica (need >=2 data-parallel devices)"
    # the port's mesh tells cpu(i) contexts apart: two replicas share a
    # device when they name the same context
    if len(set(ctxs)) != len(ctxs):
        return False, "replica contexts share a device (no mesh to shard " \
            "over)"
    if trainer._update_on_kvstore:
        return False, "update_on_kvstore=True (the kvstore owns the update)"
    kv = trainer._kvstore
    if kv is not None and type(kv) is not kvs_mod.KVStore:
        return False, "kvstore %r is not the in-process store (dist ZeRO " \
            "needs the multi-process reduce-scatter path)" % (
                getattr(kv, "type", type(kv).__name__),)
    if trainer._compression_params:
        return False, "gradient compression rides the kvstore push path"
    if trainer._optimizer.zero_fragment_update() is None:
        return False, "optimizer %s has no elementwise in-graph fragment " \
            "form" % type(trainer._optimizer).__name__
    total = 0
    live = 0
    for p in trainer._params:
        if p.grad_req == "null":
            continue
        if p.grad_req != "write":
            return False, "parameter %s has grad_req=%r (need 'write')" \
                % (p.name, p.grad_req)
        if getattr(p, "_stype", "default") != "default" or \
                getattr(p, "_grad_stype", "default") != "default":
            return False, "parameter %s is sparse" % p.name
        if p._data is not None:
            live += 1
            total += int(np.prod(p.shape))
    if not live:
        return False, "no initialized trainable parameters"
    min_size = _cfg.get("MXNET_ZERO_MIN_SIZE")
    if min_size and total < min_size:
        return False, "model too small (%d < MXNET_ZERO_MIN_SIZE=%d)" \
            % (total, min_size)
    return True, None


def _qseed_fold(key, salt: int) -> Optional[int]:
    if key is None:
        return None
    return int(np.random.SeedSequence([int(key), int(salt)])
               .generate_state(1)[0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class ZeroEngine:
    """The shard layout, the sharded optimizer state and the step of one
    Trainer."""

    def __init__(self, trainer):
        from .. import config as _cfg
        from ..parallel import quantize as qz
        from ..parallel.mesh import contexts_mesh
        self._trainer = trainer
        self._contexts = list(trainer._contexts)
        self._n = len(self._contexts)
        # the wire's configuration is taken once; its residuals are
        # allocated to match (a later change rebuilds them)
        self._quant = qz.from_env()
        qz.note_active(self._quant)
        n_dcn = int(_cfg.get("MXNET_ZERO_DCN") or 0)
        if n_dcn > 1 and self._n % n_dcn == 0:
            self._n_dcn = n_dcn
            self._axis_names = ("dcn", "dp")
            self._mesh_shape = (n_dcn, self._n // n_dcn)
            self._dcn_axis = "dcn"
        else:
            if n_dcn > 1:
                _LOG.warning(
                    "MXNET_ZERO_DCN=%d does not divide the replica count "
                    "%d; using a flat dp mesh", n_dcn, self._n)
            self._n_dcn = 1
            self._axis_names = ("dp",)
            self._mesh_shape = (self._n,)
            self._dcn_axis = None
        # device position p -> the global fragment it owns
        if self._dcn_axis is None:
            self._owner = list(range(self._n))
        else:
            n_ici = self._n // self._n_dcn
            self._owner = [(p % n_ici) * self._n_dcn + (p // n_ici)
                           for p in range(self._n)]
        self._mesh = contexts_mesh(self._contexts, self._axis_names,
                                   self._mesh_shape)
        self._groups: List[_Group] = []
        self._items: List[_Item] = []
        self._names: List[str] = []
        self._states: List[List[List[torch.Tensor]]] = []  # [g][kind][dev]
        self._gres: List[List[torch.Tensor]] = []          # [g][dev]
        self._wres: List[List[torch.Tensor]] = []
        self._nstates = 0
        self._hyper_key = None
        self._frag_fn = None
        self._structure = None
        self._qstep = 0
        # modelwatch's report deferred from the previous sampled step:
        # ("full" | "usq", names, (F,) or (3F + F,) tensor, rescale)
        self._mw_pending = None
        self._build_layout()

    # ------------------------------------------------------------------
    # layout and the sharded state
    # ------------------------------------------------------------------
    def _trainable(self):
        return [(i, p) for i, p in enumerate(self._trainer._params)
                if p.grad_req != "null" and p._data is not None]

    def _signature(self):
        return tuple((i, tuple(p.shape), p.list_data()[0]._tdtype)
                     for i, p in self._trainable())

    def _aggregate(self) -> bool:
        """Whether the replicated Trainer would run this step's update
        through ``update_multi`` (the fragment ops follow it)."""
        opt = self._trainer._optimizer
        return opt.aggregate_num > 1 and len(self._trainable()) > 1

    def _fragment_form(self):
        return self._trainer._optimizer.zero_fragment_update(
            aggregate=self._aggregate())

    def _build_layout(self):
        frag = self._fragment_form()
        if frag is None:
            raise MXNetError("optimizer %s has no ZeRO fragment form"
                             % type(self._trainer._optimizer).__name__)
        self._nstates, self._hyper_key, self._frag_fn = frag
        self._structure = self._signature()
        self._groups, self._items, self._names = [], [], []
        by_dtype: Dict[torch.dtype, _Group] = {}
        for i, p in self._trainable():
            dt = p.list_data()[0]._tdtype
            g = by_dtype.get(dt)
            if g is None:
                g = by_dtype[dt] = _Group(dt)
                self._groups.append(g)
            size = int(np.prod(p.shape)) if p.shape else 1
            item = _Item(i, p, tuple(p.shape), size,
                         _frag_len(size, self._n), g.C, 0, 0, 0)
            g.C += item.frag
            g.items.append(item)
        for gi, g in enumerate(self._groups):
            for it in g.items:
                it.gi = gi
        for fi, it in enumerate(self._iter_items()):
            # group-major: the hyperparameter and report row and the
            # position in the per-step argument lists
            it.fi = fi
            it.pos = fi
            self._items.append(it)
            self._names.append(it.param.name)
        # K buffers of (1, C) a replica: the whole state never exists
        self._states = [
            [[torch.zeros((1, g.C), dtype=g.dtype,
                          device=ctx.torch_device)
              for ctx in self._contexts] for _k in range(self._nstates)]
            for g in self._groups]
        self._alloc_residuals()
        self._qstep = 0
        self._publish_gauges()

    def _alloc_residuals(self):
        """The quantized wire's error-feedback residuals, a group and
        replica: one gradient-domain ``(1, N * C)`` buffer (each staged
        hop's error scattered into the rows its input covered) and one
        shard-domain ``(1, C)`` buffer for the re-quantized
        all-gather."""
        self._gres, self._wres = [], []
        if self._quant is None:
            return
        for g in self._groups:
            self._gres.append([torch.zeros((1, self._n * g.C),
                                           dtype=torch.float32,
                                           device=c.torch_device)
                               for c in self._contexts])
            self._wres.append([torch.zeros((1, g.C), dtype=torch.float32,
                                           device=c.torch_device)
                               for c in self._contexts])

    def _iter_items(self):
        for g in self._groups:
            for it in g.items:
                yield it

    # ------------------------------------------------------------------
    # memory accounting
    # ------------------------------------------------------------------
    def state_bytes_per_replica(self) -> int:
        return sum(g.C * _nbytes_of(g.dtype) * self._nstates
                   for g in self._groups)

    def replicated_state_bytes_per_replica(self) -> int:
        return sum(it.size * _nbytes_of(g.dtype) * self._nstates
                   for g in self._groups for it in g.items)

    def state_bytes_total(self) -> int:
        return self.state_bytes_per_replica() * self._n

    def _publish_gauges(self):
        shard_b = self.state_bytes_per_replica()
        repl_b = self.replicated_state_bytes_per_replica()
        for ctx in self._contexts:
            telemetry.zero_shard_state(str(ctx), shard_b, len(self._items),
                                       repl_b)

    # ------------------------------------------------------------------
    # the per-replica pieces of a step (run in the replica's thread)
    # ------------------------------------------------------------------
    def _reduce(self, p, grads, key):
        """This replica's summed ``(C,)`` shard of each group, and with
        the quantized wire the new gradient residuals."""
        from ..parallel import collectives as coll
        from ..parallel import quantize as qz
        n, quant, dcn = self._n, self._quant, self._dcn_axis
        shards, new_gres = [], []
        for gi, g in enumerate(self._groups):
            cols = [coll.pad_to_multiple(grads[it.pos].reshape(-1),
                                         it.frag * n).reshape(n, it.frag)
                    for it in g.items]
            gmat = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
            if quant is not None:
                gin = gmat.float() + self._gres[gi][p].reshape(n, g.C)
                sh, err = qz.quantized_rs(gin, "dp", dcn, quant,
                                          key=_qseed_fold(key, gi))
                shards.append(sh.to(gmat.dtype))
                new_gres.append(err.reshape(1, n * g.C))
            else:
                sh = coll.hierarchical_reduce_scatter(gmat, "dp", dcn, 0)
                shards.append(sh.reshape(-1))
        return shards, new_gres

    def _report(self, shards, weights=None):
        """The replicated report: ``[non-finite counts (F), grad squared
        norms (F)]`` of the scattered fragments, with ``weights`` also
        the weight fragments' squared norms (F), summed over every
        replica by one all-reduce."""
        from ..parallel import collectives as coll
        r_own = coll.shard_owner_index("dp", self._dcn_axis)
        bads, sqs, psqs = [], [], []
        for it in self._items:
            f32 = shards[it.gi][it.offset:it.offset + it.frag].float()
            bads.append((~torch.isfinite(f32)).sum().float())
            sqs.append(f32.square().sum())
            if weights is not None:
                wfrag = self._own_frag(weights[it.pos], it, r_own)
                psqs.append(wfrag.float().square().sum())
        vec = torch.stack(bads + sqs + psqs)
        return coll.allreduce_sum(vec, self._axis_names
                                  if self._dcn_axis else "dp")

    def _own_frag(self, w, it, r_own):
        from ..parallel import collectives as coll
        wflat = coll.pad_to_multiple(w.reshape(-1), it.frag * self._n)
        return wflat[r_own * it.frag:(r_own + 1) * it.frag]

    def _update(self, p, shards, weights, hyper, coef=None, key=None,
                want_usq=False):
        """The owned fragments' update and the all-gather: the new whole
        weights (per item), written into this replica's arrays, and the
        new state fragments written into its shard buffers. Returns the
        update squared norms (summed over the replicas) with
        ``want_usq``."""
        from ..parallel import collectives as coll
        from ..parallel import quantize as qz
        n, quant, dcn, K = self._n, self._quant, self._dcn_axis, \
            self._nstates
        r_own = coll.shard_owner_index("dp", dcn)
        usq = [None] * len(self._items) if want_usq else None
        for gi, g in enumerate(self._groups):
            gsh = shards[gi]
            w_frags, st_frags = [], [[] for _ in range(K)]
            for it in g.items:
                gfrag = gsh[it.offset:it.offset + it.frag]
                if coef is not None:
                    c = coef[it.fi]
                    if c == 0:
                        # the guard's zero verdict: a multiply would
                        # keep a NaN
                        gfrag = torch.zeros_like(gfrag)
                    elif c != 1:
                        gfrag = gfrag * c
                wfrag = self._own_frag(weights[it.pos], it, r_own)
                sts = tuple(self._states[gi][k][p].reshape(-1)
                            [it.offset:it.offset + it.frag]
                            for k in range(K))
                nw, nst = self._frag_fn(wfrag, gfrag, sts, hyper[it.fi])
                nw = nw.to(g.dtype)
                if want_usq:
                    usq[it.fi] = (nw.float() - wfrag.float()).square().sum()
                w_frags.append(nw)
                for k in range(K):
                    st_frags[k].append(nst[k])
            nshard = torch.cat(w_frags) if len(w_frags) > 1 else w_frags[0]
            if quant is not None:
                # the re-quantized all-gather with its own residual:
                # updates below one grid step accumulate in it
                qin = nshard.float() + self._wres[gi][p].reshape(-1)
                gathered, werr = qz.quantized_ag(
                    qin, "dp", dcn, quant,
                    key=_qseed_fold(key, 1000 + gi))
                gathered = gathered.to(g.dtype)
                self._wres[gi][p].copy_(werr.reshape(1, g.C))
            else:
                gathered = coll.hierarchical_allgather(
                    nshard, "dp", dcn, 0).reshape(n, g.C)
            for it in g.items:
                fr = gathered[:, it.offset:it.offset + it.frag]
                fr = fr.reshape(-1)[:it.size].reshape(weights[it.pos].shape)
                weights[it.pos].copy_(fr)
            for k in range(K):
                new = torch.cat(st_frags[k]) if len(st_frags[k]) > 1 \
                    else st_frags[k][0]
                self._states[gi][k][p].copy_(new.reshape(1, -1))
        if want_usq:
            return coll.allreduce_sum(torch.stack(usq), self._axis_names
                                      if self._dcn_axis else "dp")
        return None

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _qseed(self) -> Optional[int]:
        """The step's dither seed with stochastic int8 rounding (both
        halves of a guarded step share it), else None."""
        q = self._quant
        if q is None or not q.stochastic or q.mode != "int8":
            return None
        self._qstep += 1
        return self._qstep

    def _hyper(self):
        """Each fragment's host hyperparameters, the update counters
        advanced once: ``(lrs, wds, rescale)``."""
        opt = self._trainer._optimizer
        for it in self._items:
            opt._update_count(it.idx)
        lrs, wds = [], []
        for it in self._items:
            lr, wd = opt.zero_hyperparams(it.idx)
            lrs.append(float(lr))
            wds.append(float(wd))
        return lrs, wds, float(opt.rescale_grad)

    def _member_hyper(self, device, hyper):
        """The per-fragment :class:`ZeroHyper` list on one device: the
        lrs and wds also as f32 device tensors, the rescale in each
        group's dtype, one copy a step and device."""
        from ..optimizer import ZeroHyper
        lrs, wds, rescale = hyper
        lr_t = torch.tensor(lrs, dtype=torch.float32, device=device)
        wd_t = torch.tensor(wds, dtype=torch.float32, device=device)
        rs_t = {g.dtype: torch.tensor(rescale, dtype=g.dtype, device=device)
                for g in self._groups}
        return [ZeroHyper(lrs[it.fi], wds[it.fi], rescale, lr_t[it.fi],
                          wd_t[it.fi], rs_t[self._groups[it.gi].dtype])
                for it in self._items]

    def _run(self, body):
        """``body(member, pos)`` once a replica, in the replica's thread,
        gradients off; the results in replica order."""
        from .. import commwatch
        from ..parallel import _spmd

        def one(m):
            with torch.no_grad():
                return body(m, m.pos)
        run = _spmd.Run(self._mesh, collector=commwatch.current_collector())
        return run.execute(one)

    def _tensors(self):
        grads = [[g.tensor() for g in it.param.list_grad()]
                 for it in self._items]
        weights = [[w.tensor() for w in it.param.list_data()]
                   for it in self._items]
        # per replica: the item lists
        return ([[grads[i][p] for i in range(len(self._items))]
                 for p in range(self._n)],
                [[weights[i][p] for i in range(len(self._items))]
                 for p in range(self._n)])

    def _check_rebuild(self) -> bool:
        """False on a change the engine cannot carry (the caller bails
        to the replicated path); new static hyperparameters or a new
        wire configuration rebuild what depends on them."""
        from ..parallel import quantize as qz
        frag = self._fragment_form()
        if frag is None:
            return False
        if self._signature() != self._structure \
                or frag[0] != self._nstates:
            # a new parameter set or state count: rebuilding would reset
            # the moments, so the replicated path takes them
            return False
        if frag[1] != self._hyper_key:
            self._hyper_key, self._frag_fn = frag[1], frag[2]
        newq = qz.from_env()
        if (newq.key() if newq else None) != \
                (self._quant.key() if self._quant else None):
            # the carried correction is at most one grid step: dropped
            self._quant = newq
            qz.note_active(newq)
            self._alloc_residuals()
        return True

    def _watch_key(self, variant: str):
        """commwatch's program key of one half of the step: the wire's
        configuration is part of it (its collectives are other ones)."""
        return ("zero.%s" % variant, id(self),
                self._quant.key() if self._quant else None)

    def _sync_done(self, watching):
        if watching:
            for ctx in self._contexts:
                if ctx.torch_device.type == "cuda":
                    torch.cuda.synchronize(ctx.torch_device)

    @staticmethod
    def _norm32(sq: float) -> float:
        return float(np.float32(np.sqrt(sq)))

    def _consume_mw_pending(self, mw):
        """Publish the modelwatch report the previous sampled step left
        (one host read; that step finished during this step's forward
        and backward)."""
        pend, self._mw_pending = self._mw_pending, None
        if pend is None or mw is None:
            return
        kind, names, handle, rescale, small = pend
        if kind != "full":
            return
        # the replicas' staged norms (the noise scale's) ride the read
        vec = torch.cat([handle.float().reshape(-1)]
                        + [v.to(handle.device).float() for v in small]) \
            .cpu().numpy().astype(np.float64)
        mw.sync_count += 1
        F = len(names)
        # [bad(F), gsq(F), psq(F), usq(F)]
        flags = [bool(vec[i] == 0) for i in range(F)]
        gnorms = [self._norm32(v) for v in vec[F:2 * F]]
        pnorms = [self._norm32(v) for v in vec[2 * F:3 * F]]
        unorms = [self._norm32(v) for v in vec[3 * F:4 * F]]
        small_sq = float(np.sum(np.square(vec[4 * F:]))) if small else None
        mw.publish(names, gnorms, pnorms, unorms, names, small_sq,
                   rescale=rescale, flags=flags, same_step_update=True)

    def run_step(self, ignore_stale_grad: bool = False) -> str:
        """One sharded step: DONE, SKIPPED (the guard skipped it) or BAIL
        (a structural change). A failure of the step itself raises."""
        from .. import commwatch, faultinject, guardrails
        trainer = self._trainer
        if not self._check_rebuild():
            return BAIL
        guard = trainer.grad_guard
        guarded = guard is not None and guard.enabled
        mw = trainer.modelwatch
        mw_on = mw is not None and mw.sampling
        watching = commwatch.enabled()
        if (guarded or mw_on) and faultinject.active():
            # the replicated guard's fault sites, on the first replica
            guardrails.inject_grad_faults(
                [(it.param.name, it.param.list_grad()[0])
                 for it in self._items])
        if mw_on and self._mw_pending is not None \
                and (not guarded or self._mw_pending[0] == "full"):
            self._consume_mw_pending(mw)
        grads, weights = self._tensors()
        seed = self._qseed()
        nq = len(self._gres)

        if not guarded:
            hyper = self._hyper()

            def body(m, p):
                hp = self._member_hyper(m.torch_device, hyper)
                shards, gres = self._reduce(p, grads[p], seed)
                rep = self._report(shards, weights[p]) if mw_on else None
                usq = self._update(p, shards, weights[p], hp, key=seed,
                                   want_usq=mw_on)
                for gi in range(nq):
                    self._gres[gi][p].copy_(gres[gi])
                return None if rep is None else torch.cat([rep, usq])
            with telemetry.phase("zero_step"):
                with commwatch.program_watch(self._watch_key("step"),
                                             "zero.step"):
                    outs = self._run(body)
                    self._sync_done(watching)
            if mw_on:
                # this step's full report, read at the next sampled step
                small, mw._small = mw._small, []
                self._mw_pending = ("full", list(self._names), outs[0],
                                    float(trainer._optimizer.rescale_grad),
                                    small)
            return DONE

        # guarded: the reduce-scatter and the report, the verdict on the
        # host, then the coefficient-masked update and the all-gather
        def reduce_body(m, p):
            shards, gres = self._reduce(p, grads[p], seed)
            # the wire carried the gradients: the residual advances even
            # when the guard skips the step
            for gi in range(nq):
                self._gres[gi][p].copy_(gres[gi])
            return shards, self._report(shards,
                                        weights[p] if mw_on else None)
        with telemetry.phase("allreduce"):
            with commwatch.program_watch(self._watch_key("reduce"),
                                         "zero.reduce"):
                red = self._run(reduce_body)
                self._sync_done(watching)
        F = len(self._items)
        pend = None
        if mw_on and self._mw_pending is not None:
            pend, self._mw_pending = self._mw_pending, None
        parts = [red[0][1].float()]
        if pend is not None:
            parts.append(pend[2].to(parts[0].device).float())
        small = []
        if mw_on:
            small, mw._small = mw._small, []
            parts.extend(v.to(parts[0].device).float() for v in small)
        # the step's one host read: the report (and the deferred update
        # norms of the previous sampled step)
        vec = torch.cat(parts).cpu().numpy().astype(np.float64)
        guard.sync_count += 1
        flags = [bool(vec[i] == 0) for i in range(F)]
        norm = float(np.sqrt(np.sum(vec[F:2 * F])))
        if mw_on:
            gnorms = [self._norm32(v) for v in vec[F:2 * F]]
            pnorms = [self._norm32(v) for v in vec[2 * F:3 * F]]
            unames = unorms = None
            off = 3 * F
            if pend is not None:
                unames = pend[1]
                unorms = [self._norm32(v) for v in vec[off:off + len(unames)]]
                off += len(unames)
            small_sq = float(np.sum(np.square(vec[off:]))) if small else None
            mw.sync_count += 1
            mw.publish(self._names, gnorms, pnorms, unorms, unames, small_sq,
                       rescale=trainer._optimizer.rescale_grad, flags=flags)
        with telemetry.phase("guard"):
            proceed, bad, clip_scale = guard.evaluate(
                self._names, flags, norm,
                rescale=trainer._optimizer.rescale_grad)
        if not proceed:
            # the counters have not advanced: a skipped step leaves
            # num_update and Adam's t where the replicated path does
            return SKIPPED
        # a proceeding step advances the counters, after the verdict
        hyper = self._hyper()
        coef = [1.0] * F
        if bad:
            bad_set = set(bad)
            for it in self._items:
                if it.param.name in bad_set:
                    coef[it.fi] = 0.0
        if clip_scale is not None:
            coef = [c * clip_scale if c else 0.0 for c in coef]

        def update_body(m, p):
            hp = self._member_hyper(m.torch_device, hyper)
            return self._update(p, red[p][0], weights[p], hp, coef=coef,
                                key=seed, want_usq=mw_on)
        with telemetry.phase("zero_step"):
            with commwatch.program_watch(self._watch_key("update"),
                                         "zero.update"):
                outs = self._run(update_body)
                self._sync_done(watching)
        if mw_on:
            self._mw_pending = ("usq", list(self._names), outs[0],
                                float(trainer._optimizer.rescale_grad), [])
        return DONE

    # ------------------------------------------------------------------
    # topology-free checkpoints
    # ------------------------------------------------------------------
    def _host(self, t: torch.Tensor) -> np.ndarray:
        from ..ndarray import ndarray as _nd
        return _nd.host_numpy(t.detach().cpu())

    def _gathered_state_arrays(self) -> Dict[int, List[np.ndarray]]:
        """``{param index: [whole numpy state, ... K]}`` assembled from
        the fragments (honouring the dcn ownership permutation)."""
        out: Dict[int, List[np.ndarray]] = {}
        for gi, g in enumerate(self._groups):
            if not self._nstates:
                for it in g.items:
                    out[it.idx] = []
                continue
            per_kind = []
            for k in range(self._nstates):
                shards = [self._host(self._states[gi][k][p]).reshape(-1)
                          for p in range(self._n)]
                by_frag = [None] * self._n
                for p in range(self._n):
                    by_frag[self._owner[p]] = shards[p]
                per_kind.append(by_frag)
            for it in g.items:
                ks = []
                for k in range(self._nstates):
                    full = np.concatenate(
                        [per_kind[k][r][it.offset:it.offset + it.frag]
                         for r in range(self._n)])
                    ks.append(full[:it.size].reshape(it.shape))
                out[it.idx] = ks
        return out

    def _state_arrays(self, arrs, ctx):
        from ..ndarray import array
        out = [array(a, ctx=ctx, dtype=a.dtype) for a in arrs]
        if self._nstates == 0:
            return None
        if self._nstates == 1:
            return out[0]
        return tuple(out)

    def gather_states(self) -> dict:
        """The replicated layout ``{index: state}`` (the state shapes
        ``create_state`` makes), on the first replica's context, in the
        order the replicated Updater creates them."""
        ctx0 = self._contexts[0]
        gathered = self._gathered_state_arrays()
        return {it.idx: self._state_arrays(gathered[it.idx], ctx0)
                for it in sorted(self._items, key=lambda it: it.idx)}

    def serialized_states(self) -> bytes:
        """The states blob the replicated Trainer writes (the Updater's
        pickle, byte for byte after the same steps). With the quantized
        wire the residuals are carried state too: the blob is then the
        reference's tagged wrapper holding them in parameter space."""
        from ..optimizer import Updater
        upd = Updater(self._trainer._optimizer)
        upd.states = self.gather_states()
        blob = upd.get_states(dump_optimizer=False)
        if self._quant is None:
            return blob
        gres, wres = self._gathered_residuals()
        from ..optimizer import loads_states
        return pickle.dumps({"__mx_zero_quant__": 1,
                             "states": loads_states(blob),
                             "grad_residual": gres,
                             "weight_residual": wres})

    def _gathered_residuals(self):
        """``({idx: grad residual}, {idx: weight residual})`` as whole
        parameter-shaped numpy arrays: the grad residual summed over the
        replicas (row j of a replica's ``(N, C)`` buffer is its carried
        correction for fragment j; the carry conserves the sum), the
        weight residual assembled by the ownership permutation."""
        gres: Dict[int, np.ndarray] = {}
        wres: Dict[int, np.ndarray] = {}
        if self._quant is None:
            return gres, wres
        for gi, g in enumerate(self._groups):
            tot = None
            for p in range(self._n):
                a = self._host(self._gres[gi][p]).astype(
                    np.float32).reshape(self._n, g.C)
                tot = a if tot is None else tot + a
            by_frag = [None] * self._n
            for p in range(self._n):
                by_frag[self._owner[p]] = self._host(
                    self._wres[gi][p]).astype(np.float32).reshape(-1)
            for it in g.items:
                full = np.concatenate(
                    [tot[j, it.offset:it.offset + it.frag]
                     for j in range(self._n)])
                gres[it.idx] = full[:it.size].reshape(it.shape)
                wfull = np.concatenate(
                    [by_frag[r][it.offset:it.offset + it.frag]
                     for r in range(self._n)])
                wres[it.idx] = wfull[:it.size].reshape(it.shape)
        return gres, wres

    def _scatter_residuals(self, gres, wres):
        """Parameter-space residuals from any topology into this layout:
        the grad residual whole on replica 0 (zeros elsewhere: the carry
        conserves the sum only, and ``x + 0 + ... + 0`` gathers back
        exactly at any replica count), the weight residual re-sliced onto
        the owners by :func:`~..parallel.reshard.place_from_host`."""
        from ..parallel import reshard as rs
        if self._quant is None:
            return
        devs = list(self._contexts)
        for gi, g in enumerate(self._groups):
            gbuf = np.zeros((self._n, g.C), np.float32)
            wentries = []
            for it in g.items:
                lay = self._frag_layout(it)
                arr = gres.get(it.idx) if gres else None
                if arr is not None:
                    flat = np.asarray(arr, np.float32).reshape(-1)
                    for r in range(self._n):
                        lo, hi = lay.data_extent(r)
                        if hi > lo:
                            gbuf[r, it.offset:it.offset + (hi - lo)] = \
                                flat[lo:hi]
                warr = wres.get(it.idx) if wres else None
                if warr is not None:
                    wentries.append(
                        (np.asarray(warr, np.float32).reshape(-1), lay))
            gflat = torch.from_numpy(gbuf.reshape(1, self._n * g.C))
            wbufs = rs.place_from_host(wentries, self._n, g.C, devs,
                                       np.float32, label="zero.residual")
            for p, ctx in enumerate(devs):
                self._gres[gi][p] = (gflat if p == 0 else torch.zeros_like(
                    gflat)).to(ctx.torch_device)
                self._wres[gi][p] = wbufs[p].reshape(1, g.C)

    def _frag_layout(self, it):
        """This engine's FragLayout of one item: the fragment split, the
        ownership permutation and the offset in the group shard."""
        from ..parallel import reshard as rs
        return rs.FragLayout(it.size, self._n, tuple(self._owner),
                             it.offset)

    def scatter_states(self, states: dict):
        """Load a replicated-layout ``{index: state}`` (a checkpoint of
        any topology) into this layout through
        :func:`~..parallel.reshard.place_from_host`; a parameter the dict
        lacks (all of them in a step-0 checkpoint) gets fresh zeros, as
        the replicated path creates its state lazily."""
        from ..parallel import reshard as rs
        devs = list(self._contexts)
        for gi, g in enumerate(self._groups):
            if not self._nstates:
                continue
            dt = self._np_dtype(g.dtype)
            per_kind = [[] for _k in range(self._nstates)]
            for it in g.items:
                if it.idx not in states:
                    continue
                st = states[it.idx]
                ks = st if isinstance(st, (tuple, list)) else (st,)
                if len(ks) != self._nstates or any(k is None for k in ks):
                    raise MXNetError(
                        "state for parameter %s has %d tensor(s); this "
                        "optimizer shards %d — was the checkpoint saved "
                        "with a different optimizer?"
                        % (it.param.name,
                           0 if st is None else len(ks), self._nstates))
                lay = self._frag_layout(it)
                for k in range(self._nstates):
                    a = ks[k].asnumpy() if hasattr(ks[k], "asnumpy") \
                        else ks[k]
                    per_kind[k].append((np.asarray(a).astype(dt)
                                        .reshape(-1), lay))
            for k in range(self._nstates):
                bufs = rs.place_from_host(per_kind[k], self._n, g.C, devs,
                                          dt, label="zero.states")
                for p in range(self._n):
                    self._states[gi][k][p] = bufs[p].to(g.dtype) \
                        .reshape(1, g.C)

    @staticmethod
    def _np_dtype(dtype: torch.dtype):
        from ..base import np_dtype
        return np.dtype(np_dtype(dtype))

    def load_serialized_states(self, blob: bytes):
        """Load a states blob of any path and topology: the replicated
        pickle, the quantized kvstore path's wrapper (its per-key grad
        residual adopted as this engine's) or this engine's own."""
        from ..optimizer import loads_states
        states = loads_states(blob)
        gres = wres = None
        if isinstance(states, dict) and states.get("__mx_quant__"):
            raw = states.get("kv_residual") or {}
            gres = {}
            for k, v in raw.items():
                try:
                    gres[int(k)] = v
                except (TypeError, ValueError):
                    pass
            states = loads_states(states["updater"])
        elif isinstance(states, dict) and states.get("__mx_zero_quant__"):
            gres = states.get("grad_residual")
            wres = states.get("weight_residual")
            states = states["states"]
        if isinstance(states, tuple) and len(states) == 2:
            states = states[0]      # the dump_optimizer=True form
        self.scatter_states(states)
        if self._quant is not None:
            self._scatter_residuals(gres or {}, wres or {})

    # ------------------------------------------------------------------
    def reshard_from(self, old, blk_bytes=None):
        """Move the OLD engine's state fragments into this layout, device
        to device, through :func:`~..parallel.reshard.reshard_fragments`
        (one plan a group and kind, in staged blocks, the whole state
        never on one device); the residuals go through the checkpoint's
        host path. Raises MXNetError when the layouts do not match."""
        from ..parallel import reshard as rs
        if old._nstates != self._nstates or \
                len(old._items) != len(self._items):
            raise MXNetError(
                "reshard_from: engine layouts disagree (states %d vs "
                "%d, params %d vs %d) — was the optimizer swapped "
                "mid-run?" % (old._nstates, self._nstates,
                              len(old._items), len(self._items)))
        old_by_idx = {it.idx: it for it in old._items}
        devs = list(self._contexts)
        if self._nstates:
            for gi, g in enumerate(self._groups):
                moves = []
                for it in g.items:
                    oit = old_by_idx.get(it.idx)
                    if oit is None or oit.size != it.size \
                            or oit.gi != gi:
                        raise MXNetError(
                            "reshard_from: parameter %s has no "
                            "matching fragment layout in the old "
                            "engine" % it.param.name)
                    moves += rs.plan_moves(old._frag_layout(oit),
                                           self._frag_layout(it))
                for k in range(self._nstates):
                    src = [old._states[gi][k][p].reshape(-1)
                           for p in range(old._n)]
                    bufs = rs.reshard_fragments(
                        src, moves, self._n, g.C, devs,
                        blk_bytes=blk_bytes, label="zero.state")
                    # the old buffers go as soon as they are moved: at
                    # most one kind's destination is live beside them
                    del src
                    old._states[gi][k] = [None] * old._n
                    for p in range(self._n):
                        self._states[gi][k][p] = bufs[p].reshape(1, g.C)
        if self._quant is not None:
            if old._quant is not None:
                gres, wres = old._gathered_residuals()
            else:
                gres, wres = {}, {}
            self._scatter_residuals(gres, wres)

    def dissolve_into(self, updaters, contexts):
        """Hand the sharded state to the replicated updaters (a bail, a
        survivor set too small to shard): the moments carry over instead
        of restarting at zero."""
        if not self._nstates:
            return
        gathered = self._gathered_state_arrays()
        for upd, ctx in zip(updaters, contexts):
            for it in sorted(self._items, key=lambda it: it.idx):
                upd.states[it.idx] = self._state_arrays(gathered[it.idx],
                                                        ctx)
