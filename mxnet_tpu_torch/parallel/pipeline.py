"""Pipeline parallelism over a ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``).

The GPipe schedule, SPMD: every stage holds its layer's parameters
(stacked on ``pp``), the schedule walks ``n_micro + n_stages - 1`` ticks
and every stage computes on every tick, as the reference's scan does;
stage 0 injects the microbatches, the activations hop to the next stage
with :func:`~.collectives.ring_permute`, and only the last stage writes
outputs. The backward runs through the same permutes (their backward is
the permute the other way), so each stage's gradient is its own.

:func:`pipeline_apply` runs inside :func:`~.collectives.shard_map`;
:func:`make_pipeline_step` builds a whole SGD step for a stack of
identical stages.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as _coll
from .mesh import Mesh, P

__all__ = ["pipeline_apply", "make_pipeline_step"]


def _tree_map(fn, tree):
    return _coll._tree_fill(tree, iter([fn(x)
                                        for x in _coll._tree_leaves(tree)]))


def pipeline_apply(stage_fn: Callable, stage_params, x_micro,
                   axis_name: str = "pp"):
    """A GPipe pipeline, inside shard_map.

    ``stage_fn(params, x) -> y`` is one stage on one microbatch (its
    output shaped as its input); ``stage_params`` this stage's
    parameters; ``x_micro (n_micro, micro_batch, ...)`` the
    microbatches (only stage 0's are read, every stage passes the same
    shape). Returns ``(n_micro, micro_batch, ...)``: the last stage's
    outputs on the last stage, zeros on the others."""
    m = _coll._member("pipeline_apply")
    xm, wrap = _coll._unwrap(x_micro)
    n_stages = m.axis_size(axis_name)
    stage = m.axis_index(axis_name)
    n_micro = xm.shape[0]
    n_ticks = n_micro + n_stages - 1
    dev = xm.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == n_stages - 1, device=dev)
    carry = torch.zeros_like(xm[0])
    zero = torch.zeros_like(xm[0])
    outs = [zero] * n_micro
    for t in range(n_ticks):
        mb = min(t, n_micro - 1)
        # the tensor condition keeps the carry on every stage's tape, so
        # each stage runs the same permutes backward
        x_in = torch.where(first, xm[mb], carry)
        y = _coll._unwrap(stage_fn(stage_params, x_in))[0]
        if tuple(y.shape) != tuple(xm.shape[1:]):
            raise ValueError(
                "pipeline_apply: stage output shape %s must equal input "
                "shape %s (homogeneous stages)"
                % (tuple(y.shape), tuple(xm.shape[1:])))
        y = y.to(xm.dtype)
        done = t - (n_stages - 1)
        if done >= 0:
            # every stage keeps y on its tape (zeros off the last stage),
            # so every stage runs the same backward
            outs[done] = torch.where(last, y, zero)
        # the reference's scan traces its permute once, charged n_ticks
        carry = _coll.ring_permute(y, axis_name,
                                   watch_count=n_ticks if t == 0 else 0)
    return wrap(torch.stack(outs))


def make_pipeline_step(stage_fn: Callable, mesh: Mesh, n_micro: int,
                       loss_fn: Callable, lr: float = 0.01,
                       axis_name: str = "pp"):
    """A pipelined SGD step for a stack of identical stages.

    ``stage_fn(params_one_stage, x) -> y`` takes this stage's
    parameters (a dict, list or tuple of tensors, or one tensor) and a
    tensor; the parameters come stacked on a leading ``pp`` axis
    (leaves shaped ``(n_stages, ...)``). ``loss_fn(y, labels)`` is a
    scalar, computed on the last stage. Returns ``step(stacked_params,
    x, labels) -> (new_params, loss)``: x ``(n_micro, batch, ...)``
    replicated over ``pp``, each stage's plain SGD update applied
    there, the loss summed over the stages."""
    n_stages = mesh.shape[axis_name]

    def sharded_body(params_stacked, x_micro, labels):
        m = _coll._member("make_pipeline_step")
        stage = m.axis_index(axis_name)
        leaves = []

        def leaf(p):
            t = _coll._unwrap(p)[0][0].detach().requires_grad_(True)
            leaves.append(t)
            return t
        params = _tree_map(leaf, params_stacked)
        xm = _coll._unwrap(x_micro)[0]
        lab = _coll._unwrap(labels)[0]
        mask = torch.tensor(1.0 if stage == n_stages - 1 else 0.0,
                            device=xm.device)
        with torch.enable_grad():
            out = pipeline_apply(stage_fn, params, xm, axis_name)
            # only the last stage has real outputs; the others
            # contribute zero. The loss is summed over the stages after
            # the backward: the cotangents reach the earlier stages
            # through the permutes' backward, and a sum on the tape
            # would scale them by the stage count
            loss = _coll._unwrap(loss_fn(out, lab))[0] * mask
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        loss = m.run.exchange(m, "sum", axis_name, loss.detach().float())
        with torch.no_grad():
            it = iter(zip(leaves, grads))

            def update(_p):
                w, g = next(it)
                new = w.detach() if g is None else w.detach() - lr * g
                return new[None]
            new_params = _tree_map(update, params_stacked)
        return new_params, loss

    fn = _coll.shard_map(sharded_body, mesh=mesh,
                         in_specs=(P(axis_name), P(), P()),
                         out_specs=(P(axis_name), P()))

    def step(stacked_params, x, labels):
        new_params, loss = fn(stacked_params, x, labels)
        return (_tree_map(lambda a: _coll._unwrap(a)[0], new_params),
                _coll._unwrap(loss)[0])
    return step
