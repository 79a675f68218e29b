"""Operators: plain PyTorch functions on tensors.

``registry`` holds the op families the imperative ``mx.nd`` surface
and Gluon's ``F`` wrap (``elemwise``, ``reduce``, ``matrix``,
``indexing``, ``random_ops``, ``nn``, ``ctc``, ``linalg``,
``legacy_output``, the fused recurrent op ``rnn``, the detection ops
``contrib_det``, the sparse MoE FFN ``moe``, the samplers and RPN of
``vision_extra`` and the int8 ops of ``quantization``);
``optimizer_op`` holds the trainer's update rules; ``control_flow`` the
higher-order ``foreach``/``while_loop``/``cond``; ``flash_attention``
wraps the hand-written attention kernels.
"""

from . import registry
from . import elemwise, indexing, matrix, random_ops, reduce
from . import attention, ctc, flash_attention, nn, optimizer_op
from . import control_flow, legacy_output, linalg, rnn
from . import contrib_det, moe, quantization, vision_extra
