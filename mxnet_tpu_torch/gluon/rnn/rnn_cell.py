"""Unfused recurrent cells (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``; ref:
python/mxnet/gluon/rnn/rnn_cell.py).

Each cell is one time step written against ``F``; ``unroll`` runs the
steps in a Python loop. The fused layers of :mod:`.rnn_layer` are the
path for long sequences.
"""
from __future__ import annotations

from ... import ndarray as nd
from ..block import HybridBlock

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


class RecurrentCell(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        assert not self._modified
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info.update(kwargs)
            if ctx is not None:
                info["ctx"] = ctx
            info = {k: v for k, v in info.items()
                    if k in ("shape", "ctx", "dtype")}
            states.append(func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch_size = seq[0].shape[0]
        else:
            batch_size = inputs.shape[layout.find("N")]
            seq = [x.squeeze(axis=axis) for x in
                   _split_seq(inputs, length, axis)]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=seq[0].ctx)
        outputs = []
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = nd.stack_list(outputs, axis=axis)
        return outputs, states

    def forward(self, x, states):
        self._counter += 1
        return super().forward(x, states)


def _split_seq(x, length, axis):
    return [nd.slice_axis(x, axis=axis, begin=i, end=i + 1)
            for i in range(length)]


class RNNCell(RecurrentCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "dtype": "float32"}]

    def infer_shape(self, x, *args):
        self.i2h_weight._shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(RecurrentCell):
    """Single LSTM step, gates [i, f, g, o] (ref: rnn_cell.py :: LSTMCell)."""

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(4 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(4 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "dtype": "float32"},
                {"shape": (batch_size, self._hidden_size), "dtype": "float32"}]

    def infer_shape(self, x, *args):
        self.i2h_weight._shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(RecurrentCell):
    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(3 * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(3 * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(3 * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(3 * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "dtype": "float32"}]

    def infer_shape(self, x, *args):
        self.i2h_weight._shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_s = F.split(i2h, num_outputs=3, axis=1)
        h2h_s = F.split(h2h, num_outputs=3, axis=1)
        reset_gate = F.sigmoid(i2h_s[0] + h2h_s[0])
        update_gate = F.sigmoid(i2h_s[1] + h2h_s[1])
        next_h_tmp = F.tanh(i2h_s[2] + reset_gate * h2h_s[2])
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def hybrid_forward(self, F, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states


class DropoutCell(RecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(RecurrentCell):
    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if self._zoneout_outputs > 0.0 and self._prev_output is not None:
            mask = F.Dropout(F.ones_like(next_output),
                             p=self._zoneout_outputs)
            next_output = F.where(mask, next_output, self._prev_output)
        self._prev_output = next_output
        return next_output, next_states


class ResidualCell(RecurrentCell):
    def __init__(self, base_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    def __init__(self, l_cell, r_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        l_cell, r_cell = self._children.values()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            seq = [x.squeeze(axis=axis) for x in
                   _split_seq(inputs, length, axis)]
        else:
            seq = list(inputs)
        batch_size = seq[0].shape[0]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=seq[0].ctx)
        n_l = len(l_cell.state_info())
        l_out, l_states = l_cell.unroll(length, seq, states[:n_l],
                                        layout=layout, merge_outputs=False)
        r_out, r_states = r_cell.unroll(length, list(reversed(seq)),
                                        states[n_l:], merge_outputs=False)
        outputs = [nd.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_out, reversed(r_out))]
        if merge_outputs:
            outputs = nd.stack_list(outputs, axis=axis)
        return outputs, l_states + r_states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError("use unroll() for BidirectionalCell")
