"""The fused multi-layer RNN operator (counterpart of
``mxnet_tpu/ops/rnn_ops.py``; ref: src/operator/rnn.cc / rnn-inl.h ::
RNNOp).

Weights arrive as ONE flat vector in MXNet's packed layout: per (layer,
direction) the i2h then the h2h weight, then all the biases, i2h then
h2h per (layer, direction); the gate order is LSTM [i, f, g, o] and GRU
[r, z, n]. The math is the reference's, step for step: the i2h product
of all T steps is one ``torch.matmul`` (the reference hoists it out of
its ``lax.scan``), and the recurrence is a Python loop over T with the
h2h ``torch.matmul`` and the gates in torch ops. Nothing calls cuDNN's
RNN (``torch.nn.LSTM``): the reference's arithmetic and its gradient are
the contract. Dropout between layers (training only) is the registered
``Dropout`` op, so on the card it is the hand-written dropout kernel.
"""
from __future__ import annotations

import torch

from . import register
from .nn import dropout_op

__all__ = ["rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def _unpack(params, mode, input_size, state_size, num_layers,
            bidirectional):
    """Views of the flat vector: [(i2h_w, h2h_w)] and [(i2h_b, h2h_b)]
    per (layer, direction)."""
    ng = _GATES[mode]
    ndir = 2 if bidirectional else 1
    shapes = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * ndir
        for _ in range(ndir):
            shapes.append(((ng * state_size, isz),
                           (ng * state_size, state_size)))
    ws, off = [], 0
    for wshape, rshape in shapes:
        wn, rn = wshape[0] * wshape[1], rshape[0] * rshape[1]
        ws.append((params[off:off + wn].view(wshape),
                   params[off + wn:off + wn + rn].view(rshape)))
        off += wn + rn
    bs = []
    for wshape, _ in shapes:
        bn = wshape[0]
        bs.append((params[off:off + bn], params[off + bn:off + 2 * bn]))
        off += 2 * bn
    return ws, bs


def _step(mode):
    """One time step ``(carry, gates_x, h2h_w, h2h_b) -> carry`` with the
    reference's association order; ``carry[0]`` is the output."""
    if mode == "lstm":
        def step(carry, gx, r, br):
            h, c = carry
            gates = gx + torch.matmul(h, r.t()) + br
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f * c + i * g
            return o * torch.tanh(c), c
    elif mode == "gru":
        def step(carry, gx, r, br):
            (h,) = carry
            rh = torch.matmul(h, r.t()) + br
            xr, xz, xn = torch.chunk(gx, 3, dim=-1)
            hr, hz, hn = torch.chunk(rh, 3, dim=-1)
            rg = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + rg * hn)
            return ((1 - z) * n + z * h,)
    else:
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(carry, gx, r, br):
            (h,) = carry
            return (act(gx + torch.matmul(h, r.t()) + br),)
    return step


def _run_layer(x, h0, c0, w, r, bw, br, mode, reverse):
    """x (T, N, I): returns (ys, h_T, c_T or None)."""
    gates_x = torch.matmul(x, w.t()) + bw
    step = _step(mode)
    carry = (h0, c0) if mode == "lstm" else (h0,)
    T = x.shape[0]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry = step(carry, gates_x[t], r, br)
        ys[t] = carry[0]
    return torch.stack(ys, 0), carry[0], \
        carry[1] if mode == "lstm" else None


@register("RNN", needs_rng=True, needs_train_flag=True)
def rnn(data, parameters, state, state_cell=None, *, state_size, num_layers,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=True,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, _train=False):
    """Fused RNN forward. data (T, N, I); state (L*D, N, H). Returns
    (out, state_h[, state_c])."""
    T, N, I = data.shape
    H, L = int(state_size), int(num_layers)
    ndir = 2 if bidirectional else 1
    ws, bs = _unpack(parameters, mode, I, H, L, bidirectional)
    x = data
    hs, cs = [], []
    for layer in range(L):
        outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            ys, hT, cT = _run_layer(
                x, state[idx], state_cell[idx] if mode == "lstm" else None,
                ws[idx][0], ws[idx][1], bs[idx][0], bs[idx][1], mode,
                reverse=d == 1)
            outs.append(ys)
            hs.append(hT)
            if mode == "lstm":
                cs.append(cT)
        x = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)
        if _train and p > 0.0 and layer < L - 1:
            x = dropout_op(x, p=float(p), _train=True)
    if mode == "lstm":
        return x, torch.stack(hs, 0), torch.stack(cs, 0)
    return x, torch.stack(hs, 0)


@register("_rnn_state_zeros")
def rnn_state_zeros(data, *, num_directions_layers, hidden_size):
    """Zero initial state shaped from the data's batch axis."""
    return torch.zeros((int(num_directions_layers), data.shape[1],
                        int(hidden_size)), dtype=data.dtype,
                       device=data.device)


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """Length of the packed parameter vector."""
    ng = _GATES[mode]
    ndir = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * ndir
        total += ndir * (ng * state_size * (isz + state_size)
                         + 2 * ng * state_size)
    return total
