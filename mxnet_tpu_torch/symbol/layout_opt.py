"""NHWC layout pass and conv-bias elision on the hybridized path
(counterpart of ``mxnet_tpu/symbol/layout_opt.py``; ref: the cuDNN
operator wrappers' NHWC kernels, src/operator/nn/cudnn/).

The reference rewrites the Symbol graph a CachedOp traces before it
compiles it. The port has no Symbol graph: its CachedOp runs the block's
forward op by op (:mod:`mxnet_tpu_torch.cached_op`), so both passes act
on the ops as that forward runs them. They wrap the forward, the way the
reference's passes wrap its graph, and write their decisions into a
:class:`LayoutPlan`, one a signature, which the CachedOp keeps
(``CachedOp.layout_plan``).

:func:`convert_layout` — where an NHWC island starts: a 2-D
``Convolution`` with ``layout`` None or ``"NCHW"`` and ``num_group`` 1
whose data will run on tensor cores (:func:`tensor_core_dtype`: bfloat16
or float16, or float32 while cuDNN may use TF32) takes its data in
``torch.channels_last`` and a channels_last copy of its weight inside
the call (PyTorch's idiom for the reference's NHWC op with an HWIO
weight). cuDNN's tensor-core convolutions are NHWC kernels, which an
NCHW input reaches through layout-change kernels; its full-f32
convolutions run NCHW directly, and there the reference's rewrite only
costs (``chip_smoke.py`` phase 19 times both). The reference rewrites
every such conv whatever its dtype; the port's plan says which ran
channels-last. Logical shapes stay NCHW and the memory format
carries the layout, so no attribute is remapped: BatchNorm's ``axis=1``,
structured Dropout's ``axes`` and PReLU's gamma keep their meaning,
Pooling follows its input, and the reference's ``_FOLLOW`` and ``_JOIN``
ops keep the format torch gives them. A grouped convolution takes its
input as it comes. Every output of the call leaves contiguous NCHW.
Parameter storage is not touched on the CachedOp path: the reference
keeps its weight transposes inside that graph because the Trainer owns
the parameters. The sharded step owns its parameters, and there the
reference's ``_hoist_weight_transposes`` has its counterpart: a plan
tracks the tensors a step feeds as parameters (:meth:`LayoutPlan.track`),
and a parameter whose every use is a convolution that ran channels-last
(:meth:`LayoutPlan.hoistable`) is stored channels-last by the step
(``parallel/sharded.py``), so the per-step weight conversion goes
(:attr:`LayoutPlan.weight_conversions` counts those that remain).

:func:`elide_conv_bias_into_bn` — a convolution's bias whose output has
exactly one consumer, a BatchNorm with ``axis == 1`` and
``use_global_stats`` off, gets a gradient of exactly zero (the
reference's ``BlockGrad``; BatchNorm subtracts the batch mean, so the
true gradient is zero up to rounding). A convolution cannot know its
consumers when it runs, so its bias is added by :class:`_BiasAdd`, whose
backward reads the decision; the decision is made when the forward
ends, from every registry op that took the conv's output (``invoke``
reports them to :meth:`LayoutPlan.consumed`), before any backward can
run.
The forward, and the moving statistics with it, are unchanged.

``MXNET_LAYOUT_OPT`` (default on) switches both; :func:`layout_opt_enabled`
reads it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional

import torch

__all__ = ["layout_opt_enabled", "convert_layout", "elide_conv_bias_into_bn",
           "LayoutPlan", "ConvStep", "active", "tensor_core_dtype"]

_TLS = threading.local()


def layout_opt_enabled() -> bool:
    from ..config import get as _cfg
    return _cfg("MXNET_LAYOUT_OPT")


def tensor_core_dtype(dtype) -> bool:
    """Whether cuDNN runs a convolution of ``dtype`` data on tensor
    cores: 16-bit floats always, float32 while TF32 is allowed (torch's
    ``backends.cudnn.allow_tf32``, read at the call; a captured graph
    keeps the decision of its capture, as it keeps its kernels)."""
    if dtype in (torch.bfloat16, torch.float16):
        return True
    return dtype == torch.float32 and torch.backends.cudnn.allow_tf32


class ConvStep:
    """One Convolution call of a run: whether it ran channels-last
    (``nhwc``), whether its bias may be elided (``eligible``: it has one,
    NCHW), and whether it was (``bias_elided``, decided when the forward
    ends)."""

    __slots__ = ("nhwc", "eligible", "consumers", "bias_elided")

    def __init__(self, nhwc, eligible):
        self.nhwc, self.eligible = nhwc, eligible
        self.consumers: List[tuple] = []
        self.bias_elided = False

    def decide(self):
        cons = self.consumers
        self.bias_elided = bool(
            self.eligible and len(cons) == 1 and cons[0][0] == "BatchNorm"
            and int(cons[0][1].get("axis", 1)) == 1
            and not cons[0][1].get("use_global_stats", False))

    def __repr__(self):
        return "ConvStep(nhwc=%s, bias_elided=%s)" % (self.nhwc,
                                                      self.bias_elided)


class LayoutPlan:
    """The decisions of one run of a hybridized forward: a
    :class:`ConvStep` for each Convolution call, in call order."""

    def __init__(self):
        self.nhwc = False
        self.elide = False
        self.convs: List[ConvStep] = []
        self._watch = {}      # id(conv output) -> (step, output)
        # id(tracked tensor) -> (tensor, [consumer op names], [nhwc of
        # each convolution that took it as its weight])
        self._tracked = {}
        self.weight_conversions = 0

    def rows(self) -> List[tuple]:
        """``(nhwc, bias_elided)`` of each conv call, in order."""
        return [(s.nhwc, s.bias_elided) for s in self.convs]

    def conv(self, nsp: int, layout, num_group, has_bias: bool,
             dtype) -> ConvStep:
        """Record a Convolution call of ``dtype`` data and say how it
        runs."""
        ncw = layout in (None, "NCHW")
        step = ConvStep(self.nhwc and nsp == 2 and ncw
                        and int(num_group or 1) == 1
                        and tensor_core_dtype(dtype),
                        self.elide and has_bias and ncw)
        self.convs.append(step)
        return step

    def produced(self, step: ConvStep, out: torch.Tensor):
        if step.eligible:
            self._watch[id(out)] = (step, out)

    def track(self, t: torch.Tensor):
        """Note every op that takes ``t`` (a sharded step's parameter)."""
        self._tracked[id(t)] = (t, [], [])

    def conv_weight(self, weight: torch.Tensor, step: ConvStep):
        """A convolution took ``weight``: whether it ran channels-last,
        and a conversion counted where the weight was not stored so."""
        hit = self._tracked.get(id(weight))
        if hit is not None and hit[0] is weight:
            hit[2].append(step.nhwc)
        if step.nhwc and not weight.is_contiguous(
                memory_format=torch.channels_last):
            self.weight_conversions += 1

    def hoistable(self, t: torch.Tensor) -> bool:
        """Whether every use of the tracked ``t`` was a convolution that
        ran channels-last."""
        hit = self._tracked.get(id(t))
        if hit is None or hit[0] is not t or not hit[1]:
            return False
        return all(n == "Convolution" for n in hit[1]) and \
            len(hit[2]) == len(hit[1]) and all(hit[2])

    def consumed(self, op_name: str, attrs: dict, tensors):
        """A registry op took ``tensors``: note it as a consumer of each
        watched conv output and tracked tensor among them."""
        if self._tracked:
            for t in tensors:
                hit = self._tracked.get(id(t))
                if hit is not None and hit[0] is t:
                    hit[1].append(op_name)
        if not self._watch:
            return
        for t in tensors:
            hit = self._watch.get(id(t))
            if hit is not None and hit[1] is t:
                hit[0].consumers.append((op_name, attrs))

    def finish(self):
        for s in self.convs:
            s.decide()
        self._watch.clear()


def active() -> Optional[LayoutPlan]:
    """The plan of the hybridized forward running on this thread, if a
    pass is on."""
    return getattr(_TLS, "plan", None)


@contextlib.contextmanager
def _installed(plan: LayoutPlan):
    prev = getattr(_TLS, "plan", None)
    _TLS.plan = plan
    try:
        yield
    finally:
        _TLS.plan = prev


def _leave(t):
    """An output leaves its island in contiguous NCHW."""
    return t.contiguous() if isinstance(t, torch.Tensor) else t


def convert_layout(fn: Callable, plan: LayoutPlan) -> Callable:
    """``fn`` (a forward returning a list of tensors) with its 2-D
    ungrouped tensor-core convolutions run channels-last and its outputs
    returned contiguous; each conv's decision goes into ``plan``."""
    plan.nhwc = True

    def run(*args, **kwargs):
        with _installed(plan):
            outs = fn(*args, **kwargs)
        return [_leave(o) for o in outs]
    return run


def elide_conv_bias_into_bn(fn: Callable, plan: LayoutPlan) -> Callable:
    """``fn`` with the bias of each convolution whose only consumer is a
    training BatchNorm on axis 1 given a zero gradient; the decisions go
    into ``plan`` when ``fn`` returns."""
    plan.elide = True

    def run(*args, **kwargs):
        with _installed(plan):
            try:
                return fn(*args, **kwargs)
            finally:
                plan.finish()
    return run


class _BiasAdd(torch.autograd.Function):
    """``out + bias`` on axis 1; the bias's gradient is zero when its
    conv step's bias was elided, else the sum the broadcast gives."""

    @staticmethod
    def forward(ctx, out, bias, step, shape):
        ctx.step, ctx.bias_shape = step, bias.shape
        ctx.shape = shape
        return out + bias.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        if ctx.step.bias_elided:
            db = g.new_zeros(ctx.bias_shape)
        else:
            db = g.sum_to_size(ctx.shape).reshape(ctx.bias_shape)
        return g, db, None, None


def add_bias(out: torch.Tensor, bias: torch.Tensor, step: ConvStep,
             shape) -> torch.Tensor:
    """A conv's bias added through :class:`_BiasAdd` when its step may be
    elided, as a plain add otherwise."""
    if step.eligible and torch.is_grad_enabled() and bias.requires_grad:
        return _BiasAdd.apply(out, bias, step, shape)
    return out + bias.reshape(shape)
