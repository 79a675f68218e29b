"""Fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference:
python/mxnet/gluon/rnn/rnn_layer.py) over the fused ``RNN`` op
(``ops/rnn.py``).  Parameters are kept per layer and direction under the
reference's names (``{l,r}{i}_{i2h,h2h,h2r}_{weight,bias}``), so
``convert.load_gluon_params`` carries a JAX layer's weights across
unchanged, and are packed into the op's one vector at each forward.
"""

from __future__ import annotations

import torch

from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from ..block import HybridBlock


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 **kwargs):
        self._mode = mode  # before super(): _alias() runs in Block.__init__
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        if projection_size is not None and mode != "lstm":
            raise MXNetError("projection_size is LSTM-only (LSTMP)")
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        rec = projection_size if projection_size else nh
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, rec),
                                     h2h_weight_initializer)
                if projection_size:
                    # LSTMP recurrent projection (reference name: h2r)
                    self._register_param(f"{j}{i}_h2r_weight", (rec, nh),
                                         h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
            ni = rec * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, x, *args):
        """Layer 0's input width from ``x`` (C is axis 2 in both
        layouts); a later layer's is the previous layer's output."""
        ni = x.shape[2]
        ng, nh = self._gates, self._hidden_size
        rec = self._projection_size or nh
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, f"{j}{i}_i2h_weight").shape = (ng * nh, ni)
            ni = rec * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial recurrent states, ``func`` (default ``nd.zeros``)
        of each ``state_info`` shape; ``kwargs`` (``ctx=``, ``dtype=``)
        go to ``func``."""
        from ... import ndarray as nd

        if func is None:
            func = nd.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name=f"{self.prefix}h0_{i}", **info))
        return states

    def _pack_params(self, F, kwargs):
        """The op's packed vector: every weight (i2h, h2h[, h2r]) layer by
        layer and direction by direction, then every (i2h, h2h) bias."""
        parts = []
        conns_w = ["i2h", "h2h"] + (
            ["h2r"] if self._projection_size else [])
        for t, conns in (("weight", conns_w), ("bias", ["i2h", "h2h"])):
            for i in range(self._num_layers):
                for j in ["l", "r"][:self._dir]:
                    for conn in conns:
                        name = f"{j}{i}_{conn}_{t}"
                        parts.append(F.reshape(kwargs[name], (-1,)))
        return F.concat(*parts, dim=0) if len(parts) > 1 else parts[0]

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, 0, 1)
        batch_size = inputs.shape[1]
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(batch_size)]
        if isinstance(states, (NDArray, torch.Tensor)):
            states = [states]
        params = self._pack_params(F, kwargs)
        state_cell = states[1] if self._mode == "lstm" else None
        out = F.RNN(inputs, params, states[0], state_cell,
                    state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    projection_size=self._projection_size,
                    state_outputs=True)
        if self._mode == "lstm":
            outputs, h, c = out
            new_states = [h, c]
        else:
            outputs, h = out
            new_states = [h]
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, 0, 1)
        if skip_states:
            return outputs
        return outputs, new_states


class RNN(_RNNLayer):
    """Elman RNN with relu or tanh (reference: gluon.rnn.RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """LSTM (reference: gluon.rnn.LSTM; LSTMP with ``projection_size``)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", projection_size, **kwargs)

    def state_info(self, batch_size=0):
        rec = self._projection_size or self._hidden_size
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           rec), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """GRU (reference: gluon.rnn.GRU; gate order r z n)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
