"""Fused RNN layers (counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``;
ref: python/mxnet/gluon/rnn/rnn_layer.py :: _RNNLayer/RNN/LSTM/GRU, the
PTB LSTM's layer).

Parameters are stored per (layer, direction) under the reference's
names, ``{l|r}{i}_i2h_weight``, ``_h2h_weight``, ``_i2h_bias`` and
``_h2h_bias``, so the weight carry moves them by name, and are packed in
``hybrid_forward`` into the one flat vector the ``RNN`` op takes, in the
reference's order (every weight, then every bias). ``hybridize()``
captures the layer, the packing included, through ``cached_op.py``."""
from __future__ import annotations

from ... import ndarray as nd
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), "Invalid layout %s" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][:self._dir]:
                    self._register_param(
                        "%s%d_i2h_weight" % (j, i), (ng * nh, ni),
                        i2h_weight_initializer)
                    self._register_param(
                        "%s%d_h2h_weight" % (j, i), (ng * nh, nh),
                        h2h_weight_initializer)
                    self._register_param(
                        "%s%d_i2h_bias" % (j, i), (ng * nh,),
                        i2h_bias_initializer)
                    self._register_param(
                        "%s%d_h2h_bias" % (j, i), (ng * nh,),
                        h2h_bias_initializer)
                ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = getattr(self, "l0_i2h_weight").shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, x, *args):
        ni = x.shape[2]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "%s%d_i2h_weight" % (j, i))._shape = \
                    (self._gates * self._hidden_size, ni)
            ni = self._hidden_size * self._dir

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states, one array per ``state_info`` entry, made
        by ``func`` (``nd.zeros`` by default)."""
        func = func or nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info.update(kwargs)
            if ctx is not None:
                info["ctx"] = ctx
            info = {k: v for k, v in info.items()
                    if k in ("shape", "ctx", "dtype")}
            states.append(func(**info))
        return states

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        skip_states = states is None
        if skip_states:
            states = self.begin_state(inputs.shape[1], ctx=inputs.ctx,
                                      dtype=inputs.dtype)
        if isinstance(states, NDArray):
            states = [states]
        # the flat parameter vector, in the reference's packing
        flat = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                flat.append(F.Reshape(params["%s%d_i2h_weight" % (j, i)],
                                      shape=(-1,)))
                flat.append(F.Reshape(params["%s%d_h2h_weight" % (j, i)],
                                      shape=(-1,)))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                flat.append(params["%s%d_i2h_bias" % (j, i)])
                flat.append(params["%s%d_h2h_bias" % (j, i)])
        packed = F.Concat(*flat, dim=0) if len(flat) > 1 else flat[0]
        out = F.RNN(inputs, packed, *states, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        if self._mode == "lstm":
            outputs, states = out[0], [out[1], out[2]]
        else:
            outputs, states = out[0], [out[1]]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, states


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN (relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "dtype": "float32"}]


class LSTM(_RNNLayer):
    """Fused multi-layer LSTM (the PTB model's)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "dtype": "float32"},
                {"shape": shape, "dtype": "float32"}]


class GRU(_RNNLayer):
    """Fused multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "dtype": "float32"}]
