"""Recurrent layers and cells (counterpart of ``mxnet_tpu/gluon/rnn/``):
the fused ``RNN``, ``LSTM`` and ``GRU`` over the ``RNN`` op, and the
cells that ``unroll`` step by step."""

from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN
