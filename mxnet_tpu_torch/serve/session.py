"""InferenceSession — eval-mode serving of one Block on one device, with
padded shape buckets (counterpart of ``mxnet_tpu/serve/session.py``).

Requests are padded with zeros up to a ladder rung
(:mod:`.bucketing`), run through the block's forward in inference mode
on the session's device, and the padding is sliced back off the
outputs by the reference's rules:

* When no op of the model draws random numbers, the session learns
  which outputs scale with the batch and sequence axes by running the
  block at two probe shapes, (1, 2) and (2, 3), and slices exactly
  those.
* Otherwise — BERT's ``_contrib_sdp_selfatt`` and ``Dropout`` are
  registered ``needs_rng`` — it falls back to the reference's shape
  heuristic: an output is unpadded on axis 0 when that axis equals the
  batch bucket, and on the sequence axis when that axis equals the
  sequence bucket. So BERT's decoder output, ``(seq, batch, vocab)``,
  can come back at bucket size, exactly as the reference returns it.

Each bucket runs the block's CachedOp eval graph (the block is
hybridized with ``static_alloc`` and ``static_shape`` unless it already
is), the counterpart of the reference's ``serve_program`` with donated
request buffers: on the card a bucket is captured on its first use, and
each request is copied into the graph's static input buffers and
replayed. The graph reads the parameters in place, so weights are live:
a ``set_data`` is seen by the next request. The forward that resolves
deferred shapes and the unpad probes run eagerly. Outputs are numpy
arrays; a bfloat16 output comes back as float32 holding the same values
(numpy has no bfloat16).

One request runs at a time on a session (``_exec_lock``, held from the
staging copy to the outputs' host copy), so the continuous-batching
:class:`~.scheduler.Scheduler` may call :meth:`infer` from several engine
workers: a captured graph's static buffers are never shared by two
requests. A bucket's capture drains the native engine first, so it
never runs inside an engine op: the Scheduler serves a cold bucket's
batch on its own thread. With telemetry on, a miss counts in
``mx_serve_bucket_miss_total{bucket}``, a warm bucket's forward (staging,
replay and host copy) is timed into ``mx_serve_batch_seconds{bucket}``
(a cold bucket's span, its capture, is cancelled: compilewatch records
the capture as a program), and under a sampled ambient
:class:`~mxnet_tpu_torch.tracing.TraceContext` the forward is a
``serve::forward`` span of the request's trace.

Mesh-sharded serving (``mesh=``, ``param_specs=``, ``data_spec=``)
runs each request once per mesh device, one thread a device
(:mod:`..parallel._spmd`), on the request replicated or on its
``data_spec`` block of the batch axis; the outputs are assembled from
the devices' blocks. :meth:`refresh_weights` copies every whole
parameter onto every mesh device, where it stays resident until the
next refresh: a weight update reaches the session there. Each device
draws from a generator of its own, reseeded every request from one draw
of the session's context, so replicated devices draw the same numbers
(the reference places one key on the mesh). Executions are serialized
(``_exec_lock``), and :meth:`collective_tag` gives the engine the
program's descriptor. Where this differs from the reference's pjit
partitioning: ``param_specs`` (``(regex, P)`` rules, the first match
wins) is checked against the shapes and the mesh but not applied, every
device holds every whole weight and runs every product, and a request
runs no collective; a mesh of several devices runs eagerly, nothing is
captured; a mesh of one device is the single-device session on it
(captured, reading the live weights, so it needs no refresh);
``data_spec`` splits the batch axis only.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray, host_tensor
from .. import cached_op as _cached_op
from .. import engine as _engine
from .. import ops as _ops
from .. import telemetry
from .. import tracing
from .bucketing import BucketLadder

__all__ = ["InferenceSession"]


def _bucket_key(bucket: Tuple[int, ...]) -> str:
    if len(bucket) == 1:
        return "b%d" % bucket[0]
    return "b%ds%d" % bucket


class InferenceSession:
    """Multi-bucket eval serving of one HybridBlock on one device.

    Parameters
    ----------
    block : HybridBlock
        The model, initialized.
    example_inputs : tuple of NDArray (or arrays)
        Required: their shapes are the template for every non-padded
        dimension, and one forward over them resolves deferred shapes.
    ctx : Context, optional
        Serving device. Defaults to the example inputs' context, else
        the current context (``gpu(0)``).
    buckets : str, optional
        Explicit bucket spec (overrides MXNET_SERVE_BUCKETS).
    seq_axis : int, optional
        The padded sequence axis of the request inputs (e.g. 1 for
        (batch, seq) tokens). None = only the batch axis is bucketed.
    max_batch / max_seq : int, optional
        Ladder ceiling for the default pow-2 rungs (defaults: the
        example shapes).
    mesh / param_specs / data_spec
        Mesh-sharded serving (see the module docstring): a
        :class:`~mxnet_tpu_torch.parallel.Mesh`, ``(name_regex, P)``
        rules for the parameters, and the request's spec (``P(axis)`` on
        the batch axis, or None for replicated requests).
    """

    def __init__(self, block, example_inputs: Optional[Sequence] = None,
                 ctx=None, buckets: Optional[str] = None,
                 seq_axis: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 mesh=None, param_specs=None, data_spec=None):
        from ..gluon.block import HybridBlock
        if not isinstance(block, HybridBlock):
            raise MXNetError(
                "InferenceSession serves hybridizable blocks; got %s"
                % type(block).__name__)
        if not example_inputs:
            raise MXNetError(
                "InferenceSession: example_inputs required — their "
                "shapes fix the non-padded dims")
        if not block._active:
            block.hybridize(static_alloc=True, static_shape=True)
        if ctx is None and isinstance(example_inputs[0], NDArray):
            ctx = example_inputs[0].context
        if mesh is not None and mesh.size == 1 and ctx is None:
            ctx = mesh.devices.flat[0].context
        self._ctx = Context(ctx or current_context())
        self._block = block

        hosts = [self._as_host(a) for a in example_inputs]
        self._templates = [(tuple(h.shape), h.dtype) for h in hosts]
        # one forward resolves deferred shapes and shows which ops the
        # model runs (an op that draws random numbers turns off the
        # probe-based unpad, as in the reference)
        with _ops.recording() as seen, _cached_op.eager():
            self._forward([h.to(self._ctx.torch_device) for h in hosts])
        self._needs_rng = any(op.needs_rng for op in seen)
        self._seq_axis = seq_axis

        ex_batch = self._templates[0][0][0]
        ex_seq = (self._templates[0][0][seq_axis]
                  if seq_axis is not None else None)
        self.ladder = BucketLadder.from_env(
            max_batch or ex_batch,
            (max_seq or ex_seq) if seq_axis is not None else None,
            spec=buckets)
        self._out_scales = self._detect_out_axes()

        self._lock = threading.Lock()
        self._exec_lock = threading.Lock()
        self._warm: set = set()
        self._stats: Dict[Tuple[int, ...], list] = {}  # bucket -> [hit, miss]
        self._closed = False

        self._mesh = mesh
        self._param_rules = [(re.compile(pat), spec)
                             for pat, spec in (param_specs or [])]
        self._data_spec = data_spec
        self._weights: Optional[Dict[str, List[torch.Tensor]]] = None
        if mesh is not None and mesh.size > 1:
            self._init_mesh()

    # ------------------------------------------------------------------
    def _forward(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        # no_grad, not inference_mode: parameters whose deferred shapes
        # complete here must stay ordinary tensors that set_data (or a
        # trainer) can update in place later
        with torch.no_grad():
            out = self._block(*[NDArray(t, self._ctx) for t in tensors])
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o.tensor() for o in outs]

    def _probe_inputs(self, b: int, s: int) -> List[torch.Tensor]:
        out = []
        for shape, dtype in self._templates:
            tgt = list(shape)
            tgt[0] = b
            if self._seq_axis is not None and len(tgt) > self._seq_axis:
                tgt[self._seq_axis] = s
            out.append(torch.zeros(tgt, dtype=dtype,
                                   device=self._ctx.torch_device))
        return out

    def _detect_out_axes(self):
        """Per-output ``(scales_with_batch, scales_with_seq)`` learned
        from forwards at two probe shapes (b 1->2, seq 2->3). None (fall
        back to the shape heuristic) when an op of the model draws
        random numbers or the probe shapes do not run."""
        if self._needs_rng:
            return None
        try:
            with _cached_op.eager():
                oa = self._forward(self._probe_inputs(1, 2))
                ob = self._forward(self._probe_inputs(2, 3))
        except (RuntimeError, ValueError, IndexError):
            return None
        scales = []
        sax = self._seq_axis
        for a, c in zip(oa, ob):
            batch = a.dim() > 0 and a.shape[0] == 1 and c.shape[0] == 2
            seq = (sax is not None and a.dim() > sax
                   and a.shape[sax] == 2 and c.shape[sax] == 3)
            scales.append((batch, seq))
        return scales

    # ------------------------------------------------------------------
    # padding + staging
    # ------------------------------------------------------------------
    def _pad_to(self, x: torch.Tensor, bucket: Tuple[int, ...],
                template) -> torch.Tensor:
        shape, dtype = template
        tgt = list(shape)
        tgt[0] = bucket[0]
        if self._seq_axis is not None and len(tgt) > self._seq_axis:
            tgt[self._seq_axis] = bucket[1]
        x = x.to(dtype)
        if tuple(x.shape) == tuple(tgt):
            return x
        buf = torch.zeros(tgt, dtype=dtype)
        buf[tuple(slice(0, s) for s in x.shape)] = x
        return buf

    @staticmethod
    def _as_host(x) -> torch.Tensor:
        if isinstance(x, NDArray):
            return x.tensor().cpu()
        if isinstance(x, torch.Tensor):
            return x.cpu()
        return host_tensor(onp.asarray(x))

    def validate_request(self, hosts: Sequence):
        """One shape contract: arity, >= 1 row, only the batch (and seq)
        axes free, every input's row/seq agreeing with the first.
        Anything else raises — padding would otherwise zero-fill a
        too-small feature axis and serve plausible-looking garbage."""
        if len(hosts) != len(self._templates):
            raise MXNetError("serve: expected %d data input(s), got %d"
                             % (len(self._templates), len(hosts)))
        if not hosts[0].ndim or hosts[0].shape[0] < 1:
            raise MXNetError("serve: request must have >= 1 row")
        n = int(hosts[0].shape[0])
        sax = self._seq_axis
        if sax is not None and hosts[0].ndim <= sax:
            raise MXNetError(
                "serve: data input 0 has ndim %d but this session "
                "buckets sequence axis %d" % (hosts[0].ndim, sax))
        seq0 = int(hosts[0].shape[sax]) if sax is not None else None
        for i, (h, (tshape, _td)) in enumerate(zip(hosts, self._templates)):
            ok = (h.ndim == len(tshape) and h.shape[0] == n
                  and all(d == 0 or d == sax or h.shape[d] == tshape[d]
                          for d in range(h.ndim))
                  and (sax is None or h.ndim <= sax
                       or h.shape[sax] == seq0))
            if not ok:
                raise MXNetError(
                    "serve: data input %d has shape %s, expected %s "
                    "with only the batch%s axis free (shared across "
                    "inputs)"
                    % (i, tuple(h.shape), tshape,
                       "/seq" if sax is not None else ""))

    # ------------------------------------------------------------------
    # the serving call
    # ------------------------------------------------------------------
    def infer(self, *data, _warming: bool = False):
        """Serve one (possibly multi-row) request: pad to the bucket,
        run the forward, slice the padding back off. Inputs are numpy
        arrays, tensors or NDArrays; outputs are numpy arrays (a single
        array when the model has one output)."""
        if self._closed:
            raise MXNetError("InferenceSession is closed")
        hosts = [self._as_host(x) for x in data]
        self.validate_request(hosts)
        b = int(hosts[0].shape[0])
        s = (int(hosts[0].shape[self._seq_axis])
             if self._seq_axis is not None else None)
        bucket, beyond = self.ladder.bucket_for(b, s)
        with self._lock:
            # a miss is a bucket the warmup did not cover, or any
            # request beyond the ladder; warm flips only after the first
            # run returns, so a concurrent caller of a cold bucket is
            # cold too
            warm = bucket in self._warm
            miss = (not warm) or beyond
            st = self._stats.setdefault(bucket, [0, 0])
            if not _warming:
                st[1 if miss else 0] += 1
                if miss:
                    telemetry.count_event("mx_serve_bucket_miss_total",
                                          bucket=_bucket_key(bucket))

        tctx = tracing.current() if tracing.active() else None
        t0w = time.time() if tctx is not None else 0.0
        if not warm and self._ctx.device_type == "gpu" \
                and not self._sharded:
            # the capture drains the engine under the lock; an engine op
            # of this session waiting for the lock would never finish
            _engine.native_drain()
        with self._exec_lock, telemetry.span(
                "serve::forward", "serve", hist="mx_serve_batch_seconds",
                bucket=_bucket_key(bucket)) as sp:
            if not warm:
                # a cold bucket's time is its capture: compilewatch has
                # it; the batch histogram is about serving
                sp.cancel()
            run = self._run_mesh if self._sharded else self._run
            outs = [NDArray(o, self._ctx).asnumpy()
                    for o in run(hosts, bucket)]
        if tctx is not None:
            tracing.record_span("serve::forward", "serve", t0w, time.time(),
                                ctx=tctx,
                                args={"bucket": _bucket_key(bucket),
                                      "warm": bool(warm)})
        with self._lock:
            self._warm.add(bucket)
        return self._unpad(outs, bucket, b, s)

    def _run(self, hosts, bucket) -> List[torch.Tensor]:
        """Stage a request padded to ``bucket`` on the device and run the
        forward; on the card a warm bucket waits for nothing from the
        host here (the staging copies leave pinned memory)."""
        dev = self._ctx.torch_device
        staged = [self._pad_to(h, bucket, t) for h, t in
                  zip(hosts, self._templates)]
        if dev.type == "cuda":
            staged = [x.pin_memory().to(dev, non_blocking=True)
                      for x in staged]
        return self._forward(staged)

    # ------------------------------------------------------------------
    # mesh-sharded serving
    # ------------------------------------------------------------------
    @property
    def _sharded(self) -> bool:
        return self._weights is not None

    def _init_mesh(self):
        from ..parallel import _spmd
        mesh = self._mesh
        self._params = dict(self._block.collect_params().items())
        self._specs = {n: self._spec_for(n, tuple(p.shape))
                       for n, p in self._params.items()}
        ds = self._data_spec
        if ds is not None and any(a is not None for a in tuple(ds)[1:]):
            raise MXNetError(
                "serve: data_spec %r splits an axis other than the batch "
                "axis; the port's mesh session splits the batch axis only"
                % (ds,))
        self._batch_axes = None if ds is None or not tuple(ds) \
            or tuple(ds)[0] is None else _spmd.axes_of(tuple(ds)[0])
        run = _spmd.Run(mesh)
        # the devices the batch splits over
        self._split = run.axis_size(self._batch_axes) \
            if self._batch_axes else 1
        self._gens = []
        for m in run.members:
            dev = m.torch_device
            self._gens.append((torch.Generator(device=dev),
                               torch.zeros((1,), dtype=torch.int64,
                                           device=dev)
                               if dev.type == "cuda" else None))
        self.refresh_weights()

    def _spec_for(self, name: str, shape):
        """The first matching rule's spec for parameter ``name``, checked
        against its shape and the mesh (else replicated)."""
        from ..parallel import _spmd
        from ..parallel.mesh import P
        for pat, spec in self._param_rules:
            if not pat.match(name):
                continue
            entries = tuple(spec)
            if len(entries) > len(shape):
                raise MXNetError(
                    "serve: param_specs rule %r gives %r %d axes, but "
                    "parameter %r has rank %d"
                    % (pat.pattern, spec, len(entries), name, len(shape)))
            for dim, ax in enumerate(entries):
                if ax is None:
                    continue
                n = 1
                for a in _spmd.axes_of(ax):
                    if a not in self._mesh.shape:
                        raise MXNetError(
                            "serve: param_specs rule %r names mesh axis %r "
                            "for parameter %r; the mesh has %s"
                            % (pat.pattern, a, name,
                               tuple(self._mesh.axis_names)))
                    n *= self._mesh.shape[a]
                if shape[dim] % n:
                    raise MXNetError(
                        "serve: dimension %d (%d) of parameter %r does not "
                        "divide over the %d devices of mesh axis %r"
                        % (dim, shape[dim], name, n, ax))
            return spec
        return P()

    def refresh_weights(self):
        """(Sharded mode) copy each parameter's current value, whole, onto
        each mesh device. Call after a weight update; a single-device
        session reads the live parameters on every request and needs
        none."""
        if self._mesh is None or self._mesh.size == 1:
            return
        from ..parallel import _spmd
        devs = [m.torch_device for m in _spmd.Run(self._mesh).members]
        with torch.no_grad():
            self._weights = {
                name: [p.data(p.list_ctx()[0]).tensor()
                       .to(dev, copy=True).contiguous() for dev in devs]
                for name, p in self._params.items()}

    def _run_mesh(self, hosts, bucket) -> List[torch.Tensor]:
        """One request on every mesh device: its block of the request
        (or all of it), the resident weights, the forward; the outputs
        assembled on the first device."""
        from .. import commwatch, random as _random
        from ..gluon.parameter import substitute
        from ..parallel import _spmd
        from ..parallel import collectives as coll
        from ..parallel.mesh import P
        staged = [self._pad_to(h, bucket, t) for h, t in
                  zip(hosts, self._templates)]
        rows = bucket[0]
        extra = (-rows) % self._split
        if extra:
            # the batch splits evenly: zero rows past the bucket
            staged = [torch.cat([x, x.new_zeros((extra,) + x.shape[1:])])
                      for x in staged]
        seed = int(torch.randint(0, 1 << 62, (1,), generator=_random
                                 .generator(Context("cpu", 0))).item())
        run = _spmd.Run(self._mesh, collector=commwatch.current_collector())
        spec = P(self._batch_axes) if self._batch_axes else None
        local_rows = (rows + extra) // self._split

        def body(m):
            ctx = m.device.context
            dev = m.torch_device
            datas = [NDArray(coll.block_of(x, spec, run, m.coords).to(dev),
                             ctx) for x in staged]
            mapping = {p: NDArray(self._weights[n][m.pos], ctx)
                       for n, p in self._params.items()}
            gen, counter = self._gens[m.pos]
            gen.manual_seed(seed)
            if counter is not None:
                counter.fill_((seed % (1 << 31)) << 32)
            with ctx, torch.no_grad(), _cached_op.eager(), \
                    substitute(mapping), _random.stream(gen, counter):
                out = self._block(*datas)
            outs = out if isinstance(out, (list, tuple)) else [out]
            return [o.tensor() for o in outs]
        results = run.execute(body)
        outs = []
        for i in range(len(results[0])):
            blocks = [r[i] for r in results]
            if spec is None:
                outs.append(blocks[0])
                continue
            if not blocks[0].dim() or blocks[0].shape[0] != local_rows:
                raise MXNetError(
                    "serve: output %d has shape %s; with data_spec %r each "
                    "output's axis 0 must be the batch (%d rows a device)"
                    % (i, tuple(blocks[0].shape), self._data_spec,
                       local_rows))
            outs.append(coll.assemble(blocks, spec, run)[:rows])
        return outs

    def collective_tag(self) -> Optional[dict]:
        """The ``engine.push_async(collective=...)`` descriptor of the
        ops that run this session's requests when they run over several
        devices (a mesh of more than one), else None: the program, and
        the identity of the session's serializing exec lock, so two
        in-flight batches of one session are sanctioned while two
        multi-device programs with no shared lock are the deadlock
        shape the collective-interleave check looks for."""
        if self._mesh is None or self._mesh.size < 2:
            return None
        return {"program": "serve %s over %s" % (
                    self._block.name, dict(self._mesh.shape)),
                "lock": id(self._exec_lock)}

    def _is_warm(self, b: int, s: Optional[int]) -> bool:
        """Whether a request of ``b`` rows and length ``s`` finds its
        bucket captured."""
        bucket, _ = self.ladder.bucket_for(b, s)
        with self._lock:
            return bucket in self._warm

    def _unpad(self, outs, bucket, b, s):
        sliced = []
        for i, o in enumerate(outs):
            sc = self._out_scales[i] if self._out_scales else None
            batched = (sc[0] if sc is not None
                       else o.ndim and o.shape[0] == bucket[0])
            seqful = (sc[1] if sc is not None
                      else (self._seq_axis is not None
                            and o.ndim > self._seq_axis
                            and o.shape[self._seq_axis] == bucket[1]))
            if batched and o.ndim and b != bucket[0]:
                o = o[:b]
            if seqful and self._seq_axis is not None \
                    and o.ndim > self._seq_axis and s != bucket[1]:
                idx = [slice(None)] * o.ndim
                idx[self._seq_axis] = slice(0, s)
                o = o[tuple(idx)]
            sliced.append(o)
        return sliced if len(sliced) > 1 else sliced[0]

    # ------------------------------------------------------------------
    def warmup(self, buckets: Optional[Sequence[Tuple[int, ...]]] = None):
        """Run every ladder rung once ahead of traffic (zeros input)."""
        for bucket in (buckets or self.ladder.all_buckets()):
            fakes = []
            for shape, dtype in self._templates:
                tgt = list(shape)
                tgt[0] = bucket[0]
                if self._seq_axis is not None and len(tgt) > self._seq_axis:
                    tgt[self._seq_axis] = bucket[-1]
                fakes.append(torch.zeros(tgt, dtype=dtype))
            self.infer(*fakes, _warming=True)
        return self

    @property
    def max_batch(self) -> int:
        return self.ladder.max_batch

    @property
    def seq_axis(self) -> Optional[int]:
        return self._seq_axis

    def bucket_table(self) -> List[dict]:
        """Per-bucket serving stats: warmed / hits / misses."""
        with self._lock:
            keys = sorted(set(self._warm) | set(self._stats))
            return [{"bucket": _bucket_key(k),
                     "warmed": k in self._warm,
                     "hits": self._stats.get(k, [0, 0])[0],
                     "misses": self._stats.get(k, [0, 0])[1]}
                    for k in keys]

    def bucket_misses(self) -> int:
        with self._lock:
            return sum(v[1] for v in self._stats.values())

    def close(self):
        self._closed = True
