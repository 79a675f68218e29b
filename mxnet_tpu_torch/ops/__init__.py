"""Operators: plain PyTorch functions on tensors (``optimizer_op``'s
update rules among them), and the wrappers of the hand-written kernels
(``flash_attention``)."""

from . import attention, flash_attention, nn, optimizer_op
