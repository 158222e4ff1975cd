"""Expert parallelism over an ``ep`` mesh axis (counterpart of
``mxnet_tpu/parallel/moe.py``).

Switch-style top-1 routing with static capacity: each device holds one
expert; its tokens go to their experts with one all-to-all over ``ep``,
are processed there, and come back with the inverse all-to-all. Shapes
are static: a token beyond its expert's capacity on its device is
dropped and comes back as zeros.

:func:`moe_apply` runs inside :func:`~.collectives.shard_map`;
:func:`make_moe_layer` builds a whole layer over a mesh, its weights
drawn from ``np.random.RandomState(seed)`` as the reference draws them,
so one seed gives both packages the same weights.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import collectives as _coll
from .mesh import Mesh, P

__all__ = ["moe_apply", "make_moe_layer"]


def moe_apply(expert_fn: Callable, expert_params, x, gate_logits,
              capacity: int, axis_name: str = "ep"):
    """Inside shard_map: route this device's tokens to their experts.

    ``expert_fn(params, tokens)`` is this device's expert on an
    ``(E * capacity, d)`` buffer, its tokens from every device (rows past
    a sender's load are zeros); ``expert_params`` this device's expert
    parameters; ``x (T, d)`` this device's tokens; ``gate_logits (T, E)``
    the routing scores, E the number of devices; ``capacity`` the slots
    each device gives each expert. Returns ``(T, d)``: the expert outputs
    weighted by the gate probability, zeros for the dropped tokens."""
    m = _coll._member("moe_apply")
    tx, wrap = _coll._unwrap(x)
    logits = _coll._unwrap(gate_logits)[0]
    E = m.axis_size(axis_name)
    T, d = tx.shape
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)                   # (T,)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    # each token's position in its expert's block on this device
    onehot = torch.nn.functional.one_hot(expert_idx, E)
    pos_in_expert = torch.cumsum(onehot, dim=0) - 1
    pos = pos_in_expert.gather(1, expert_idx[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.clamp(expert_idx * capacity + pos, 0, E * capacity - 1)
    kept = torch.where(keep[:, None], tx, torch.zeros_like(tx))
    # kept tokens have slots of their own and a dropped token adds exact
    # zeros, so the sum is the same in any order, on either device
    dispatch = tx.new_zeros((E * capacity, d)).index_add(
        0, slot, kept).reshape(E, capacity, d)
    recv = _coll._unwrap(_coll.all_to_all(dispatch, axis_name, split_axis=0,
                                          concat_axis=0, tiled=False))[0]
    out = _coll._unwrap(expert_fn(expert_params,
                                  recv.reshape(E * capacity, d)))[0]
    out = out.reshape(E, capacity, d)
    back = _coll._unwrap(_coll.all_to_all(out, axis_name, split_axis=0,
                                          concat_axis=0, tiled=False))[0]
    y = back.reshape(E * capacity, d)[slot]
    y = torch.where(keep[:, None], y, torch.zeros_like(y))
    return wrap((y.float() * gate[:, None]).to(tx.dtype))


def make_moe_layer(mesh: Mesh, d: int, d_hidden: int, capacity: int,
                   axis_name: str = "ep", seed: int = 0):
    """An expert-parallel FFN layer: one ReLU MLP expert a device, the
    gate shared. Returns ``(apply, params)``: ``apply(params, x_global)
    -> y_global`` with the tokens split over ``axis_name``; ``params``
    holds ``w1 (E, d, d_hidden)``, ``w2 (E, d_hidden, d)`` (each device
    its expert's slice) and ``wg (d, E)`` as f32 CPU tensors."""
    E = mesh.shape[axis_name]
    rng = np.random.RandomState(seed)
    params = {
        "w1": torch.from_numpy(rng.randn(E, d, d_hidden).astype(np.float32)
                               * 0.1),
        "w2": torch.from_numpy(rng.randn(E, d_hidden, d).astype(np.float32)
                               * 0.1),
        "wg": torch.from_numpy(rng.randn(d, E).astype(np.float32) * 0.1),
    }

    def expert_fn(p, tokens):
        return torch.relu(tokens @ p["w1"][0]) @ p["w2"][0]

    def body(p, x):
        p = {k: _coll._unwrap(v)[0] for k, v in p.items()}
        tx = _coll._unwrap(x)[0]
        return moe_apply(expert_fn, p, tx, tx @ p["wg"], capacity,
                         axis_name)

    pspec = {"w1": P(axis_name), "w2": P(axis_name), "wg": P()}
    fn = _coll.shard_map(body, mesh=mesh, in_specs=(pspec, P(axis_name)),
                         out_specs=P(axis_name))
    return fn, params
