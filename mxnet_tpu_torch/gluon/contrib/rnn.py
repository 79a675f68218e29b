"""Contrib recurrent cells: ``VariationalDropoutCell`` and
``Conv2DLSTMCell`` (counterpart of ``mxnet_tpu/gluon/contrib/rnn.py``;
reference: python/mxnet/gluon/contrib/rnn/)."""

from __future__ import annotations

from ..rnn.rnn_cell import HybridRecurrentCell, ModifierCell


class VariationalDropoutCell(ModifierCell):
    """Dropout with one mask for every time step of an unroll (reference:
    contrib.rnn.VariationalDropoutCell): on the inputs, the states and
    the outputs, each drawn at its first step and kept until ``reset``."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_masks = None
        self._output_mask = None

    def _mask_like(self, F, arr, p):
        # one bernoulli mask (scaled by 1 / (1 - p)), kept for the unroll
        return F.Dropout(F.ones_like(arr), p=p, _is_training=True)

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            if self._input_mask is None:
                self._input_mask = self._mask_like(F, inputs,
                                                   self.drop_inputs)
            inputs = inputs * self._input_mask
        if self.drop_states:
            if self._state_masks is None:
                self._state_masks = [
                    self._mask_like(F, s, self.drop_states)
                    for s in states]
            states = [s * m for s, m in zip(states, self._state_masks)]
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self._output_mask is None:
                self._output_mask = self._mask_like(F, output,
                                                    self.drop_outputs)
            output = output * self._output_mask
        return output, states


class Conv2DLSTMCell(HybridRecurrentCell):
    """Convolutional LSTM (Shi et al. 2015; reference:
    contrib.rnn.Conv2DLSTMCell) on (B, C, H, W) inputs: the i2h and h2h
    products of an LSTM cell are ``Convolution``s."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1),
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)  # (C, H, W)
        self._hc = hidden_channels
        self._i2h_kernel = i2h_kernel
        self._h2h_kernel = h2h_kernel
        self._i2h_pad = i2h_pad
        self._h2h_pad = (h2h_kernel[0] // 2, h2h_kernel[1] // 2)
        cin = self._input_shape[0]
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_channels, cin) + i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(4 * hidden_channels, hidden_channels) + h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_channels,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_channels,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        c, h, w = self._input_shape
        return [{"shape": (batch_size, self._hc, h, w),
                 "__layout__": "NCHW"},
                {"shape": (batch_size, self._hc, h, w),
                 "__layout__": "NCHW"}]

    def _alias(self):
        return "conv_lstm"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hc, x.shape[1]) \
            + tuple(self._i2h_kernel)

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=4 * self._hc)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=4 * self._hc)
        gates = i2h + h2h
        i, f, g, o = F.SliceChannel(gates, num_outputs=4, axis=1)
        i = F.Activation(i, act_type="sigmoid")
        f = F.Activation(f, act_type="sigmoid")
        g = F.Activation(g, act_type="tanh")
        o = F.Activation(o, act_type="sigmoid")
        next_c = f * states[1] + i * g
        next_h = o * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]
