"""Recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference:
python/mxnet/gluon/rnn/rnn_cell.py): ``RecurrentCell``,
``HybridRecurrentCell``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``SequentialRNNCell``, ``DropoutCell``, ``ModifierCell``, ``ZoneoutCell``,
``ResidualCell``, ``BidirectionalCell`` and ``unroll``.

A cell steps one time step on NDArrays (recorded inside
``autograd.record()``) or on tensors; ``unroll`` loops over the steps in
Python, with ``valid_length`` through ``SequenceLast`` and
``SequenceMask``.  For long sequences the fused layers of
``rnn_layer.py`` project the whole input in one product.
"""

from __future__ import annotations

import torch

from ...ndarray.ndarray import NDArray
from ..block import Block, HybridBlock


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, begin_state, inputs, batch_size):
    """``begin_state``, or the cell's zeros where the inputs live: on an
    NDArray's context, or as tensors on a tensor's device and dtype."""
    if begin_state is not None:
        return begin_state
    first = inputs[0] if isinstance(inputs, list) else inputs
    if isinstance(first, NDArray):
        return cell.begin_state(batch_size=batch_size, ctx=first.context)
    return cell.begin_state(
        batch_size=batch_size,
        func=lambda shape, **kw: torch.zeros(shape, dtype=first.dtype,
                                             device=first.device))


def _format_sequence(length, inputs, layout, merge):
    from ... import ndarray as nd

    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, (NDArray, torch.Tensor)):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is None:
                length = inputs.shape[axis]
            inputs = list(nd.split(inputs, axis=axis,
                                   num_outputs=inputs.shape[axis],
                                   squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = nd.stack(*inputs, axis=axis)
    if isinstance(inputs, list):
        length = len(inputs)
    return inputs, axis, batch_size, length


def _mask_sequence_variable_length(data, valid_length, time_axis):
    from ... import ndarray as nd

    assert valid_length is not None
    if not isinstance(data, list):
        return nd.SequenceMask(data, sequence_length=valid_length,
                               use_sequence_length=True, axis=time_axis)
    return [nd.SequenceMask(ele, sequence_length=valid_length,
                            use_sequence_length=True, axis=time_axis)
            for ele in data]


class RecurrentCell(Block):
    """Abstract cell (reference: rnn.RecurrentCell)."""

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
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, ``func`` (default ``nd.zeros``) of each
        ``state_info`` shape; ``kwargs`` (``ctx=`` ...) go to ``func``."""
        from ... import ndarray as nd

        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name=f"{self._prefix}begin_state_"
                              f"{self._init_counter}", **info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times over ``inputs`` (one array in
        ``layout``, or a list of per-step arrays); returns (outputs,
        final states).  With ``valid_length`` (B,), each sequence's final
        states are those of its last valid step and the outputs past it
        are masked."""
        from ... import ndarray as nd

        self.reset()
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = _mask_sequence_variable_length(outputs, valid_length,
                                                     axis)
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell computed by ``hybrid_forward`` (reference:
    rnn.HybridRecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell (reference: rnn.RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
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
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell (reference: rnn.LSTMCell; gates i f g o)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None,
                 activation="tanh", recurrent_activation="sigmoid"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
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
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4, axis=-1)
        in_gate = self._get_activation(F, slice_gates[0],
                                       self._recurrent_activation)
        forget_gate = self._get_activation(F, slice_gates[1],
                                           self._recurrent_activation)
        in_transform = self._get_activation(F, slice_gates[2],
                                            self._activation)
        out_gate = self._get_activation(F, slice_gates[3],
                                        self._recurrent_activation)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c,
                                                 self._activation)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell (reference: rnn.GRUCell; gates r z n)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
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
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def infer_shape(self, x, *args):
        self.i2h_weight.shape = (3 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp \
            + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stacks cells (reference: rnn.SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values())
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on the cell's input (reference: rnn.DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float)), "rate must be a number"
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base of the cells that modify another cell (reference:
    rnn.ModifierCell); its parameters are the base cell's."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout (reference: rnn.ZoneoutCell): each output and state element
    keeps its previous value with probability ``zoneout_outputs`` /
    ``zoneout_states`` in training mode."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds the input to the output (reference: rnn.ResidualCell)."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over opposite directions, outputs concatenated
    (reference: rnn.BidirectionalCell); it only unrolls."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd

        self.reset()
        inputs, axis, batch_size, length = _format_sequence(
            length, inputs, layout, False)
        reversed_inputs = list(reversed(inputs))
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=False,
            valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False,
            valid_length=valid_length)
        if valid_length is not None:
            r_outputs = list(reversed(_mask_sequence_variable_length(
                list(reversed(r_outputs)), valid_length, axis)))
        else:
            r_outputs = list(reversed(r_outputs))
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        states = l_states + r_states
        return outputs, states
