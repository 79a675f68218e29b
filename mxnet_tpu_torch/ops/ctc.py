"""CTC loss.

Counterpart of ``mxnet_tpu/ops/ctc.py`` (reference:
src/operator/nn/ctc_loss.cc): the negative log-likelihood of each label
sequence under (N, T, C) unnormalised activations, blank = 0 (the
reference's ``blank_label='first'``), labels >= 1, entries < 1 padding.
Computed by ``torch.nn.functional.ctc_loss`` on the log-softmax.  An
impossible alignment gives +inf here where the JAX op's -1e30 floor gives
1e30.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register("ctc_loss", aliases=("CTCLoss", "contrib_ctc_loss"))
def ctc_loss(pred, label, pred_lengths=None, label_lengths=None):
    """Per-sequence NLL; ``pred`` (N, T, C), ``label`` (N, L) padded with
    values < 1; lengths default to T and to the count of labels >= 1."""
    n, t, _ = pred.shape
    label = label.long()
    if pred_lengths is None:
        pred_lengths = torch.full((n,), t, dtype=torch.long)
    if label_lengths is None:
        label_lengths = (label >= 1).sum(dim=1)
    logp = torch.log_softmax(pred.float(), dim=-1).transpose(0, 1)
    return F.ctc_loss(logp, label.clamp(min=0), pred_lengths.long().cpu(),
                      label_lengths.long().cpu(), blank=0,
                      reduction="none").to(pred.dtype)
