"""CTC loss.

Counterpart of ``mxnet_tpu/ops/ctc.py`` (reference:
src/operator/nn/ctc_loss.cc): the negative log-likelihood of each label
sequence under (N, T, C) unnormalised activations, blank = 0 (the
reference's ``blank_label='first'``), labels >= 1, entries < 1 padding.
A sample whose labels fit its frames goes through
``torch.nn.functional.ctc_loss`` on the log-softmax, one native op.  A
sample that cannot fit (more labels and repeats than its frames allow),
for which that op gives inf and a NaN gradient, goes through the JAX op's
log-alpha recursion over time in plain PyTorch, with its -1e30 floor for
an impossible state, and autograd differentiates it: a loss of 1e30 and
a finite gradient, as the JAX op gives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

_NEG_INF = -1e30


def _logsumexp(x):
    """``log(sum(exp(x), 0))`` with the max held constant, as
    ``jax.scipy.special.logsumexp``: the gradient is the softmax of ``x``,
    so states tied at the floor share it (torch's own backward, exp(x -
    result), gives each of them 1 there, the floor swallowing log(3))."""
    amax = x.max(dim=0).values.detach()
    return torch.log(torch.exp(x - amax).sum(dim=0)) + amax


class _LogAddExp(torch.autograd.Function):
    """``logaddexp`` with ``jnp.logaddexp``'s derivative, exp(x - out) for
    each operand."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _shift(alpha, k):
    """``alpha`` moved ``k`` states to the right along dim 1, the vacated
    states at the floor."""
    pad = torch.full_like(alpha[:, :k], _NEG_INF)
    return torch.cat([pad, alpha[:, :-k]], dim=1)


def _ctc_alpha(logp, ext, ext_valid, pred_lengths):
    """logp: (N, T, C) log-probs; ext: (N, S) extended labels (blank
    interleaved, S = 2L+1); ext_valid: (N,) valid extended length;
    pred_lengths: (N,).  Returns the log-alpha at each sample's last
    frame."""
    n, t_max, _ = logp.shape
    s = ext.shape[1]
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]],
                       dim=1) if s > 2 else torch.full_like(ext, -1)
    can_skip = (ext != 0) & (ext != ext_m2)
    floor = torch.full((n, s), _NEG_INF, dtype=logp.dtype,
                       device=logp.device)
    emit0 = logp[:, 0].gather(1, ext)
    first = torch.zeros((n, s), dtype=torch.bool, device=logp.device)
    first[:, 0] = True
    if s > 1:
        first[:, 1] = ext_valid > 1
    alpha = torch.where(first, emit0, floor)
    for t in range(1, t_max):
        emit = logp[:, t].gather(1, ext)
        a_m1 = _shift(alpha, 1)
        a_m2 = torch.where(can_skip, _shift(alpha, 2), floor) if s > 2 \
            else floor
        new = _logsumexp(torch.stack([alpha, a_m1, a_m2])) + emit
        # freeze past the sequence end (the reference's per-sample T_n)
        active = (t < pred_lengths)[:, None]
        alpha = torch.where(active, new, alpha)
    return alpha


def _needed_frames(label, label_lengths):
    """Frames the shortest alignment of each label sequence takes: one a
    label, and a blank between each pair of equal adjacent labels."""
    if label.shape[1] < 2:
        return label_lengths
    pos = torch.arange(1, label.shape[1], device=label.device)
    repeats = (label[:, 1:] == label[:, :-1]) & (pos < label_lengths[:, None])
    return label_lengths + repeats.sum(dim=1)


def _native(logp, label, pred_lengths, label_lengths):
    """``F.ctc_loss`` on (N, T, C) log-probs, every sample able to fit;
    the lengths on the host."""
    return F.ctc_loss(logp.transpose(0, 1), label.clamp(min=0),
                      pred_lengths, label_lengths, blank=0,
                      reduction="none")


def _floored(logp, label, pred_lengths, label_lengths):
    """The JAX op's floored recursion: 1e30 where a sample cannot fit."""
    n = logp.shape[0]
    ext = torch.zeros((n, 2 * label.shape[1] + 1), dtype=torch.long,
                      device=logp.device)
    ext[:, 1::2] = label.clamp(min=0)
    alpha = _ctc_alpha(logp, ext, 2 * label_lengths + 1, pred_lengths)
    end = 2 * label_lengths                       # the blank after the last
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_last = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_last = torch.where(label_lengths > 0, a_last,
                         torch.full_like(a_last, _NEG_INF))
    return -_LogAddExp.apply(a_end, a_last)


@register("ctc_loss", aliases=("CTCLoss", "contrib_ctc_loss"))
def ctc_loss(pred, label, pred_lengths=None, label_lengths=None):
    """Per-sequence NLL; ``pred`` (N, T, C), ``label`` (N, L) padded with
    values < 1; lengths default to T and to the count of labels >= 1."""
    n, t, _ = pred.shape
    dev = pred.device
    label = label.long().to(dev)
    if pred_lengths is None:
        pred_lengths = torch.full((n,), t, dtype=torch.long, device=dev)
    if label_lengths is None:
        label_lengths = (label >= 1).sum(dim=1)
    pred_lengths = pred_lengths.long().to(dev)
    label_lengths = label_lengths.long().to(dev)
    logp = torch.log_softmax(pred.float(), dim=-1)
    fits = _needed_frames(label, label_lengths) <= pred_lengths
    # one read to the host: F.ctc_loss takes its lengths there
    fits_h, pred_h, label_h = torch.stack(
        [fits.long(), pred_lengths, label_lengths]).cpu()
    if bool(fits_h.all()):
        return _native(logp, label, pred_h, label_h).to(pred.dtype)
    good = fits_h.nonzero()[:, 0]
    bad = (fits_h == 0).nonzero()[:, 0]
    bad_d = bad.to(dev)
    # frames past a sample's length are frozen in the recursion: cut them
    t_bad = int(pred_h[bad].max())
    parts = [_floored(logp[bad_d, :t_bad], label[bad_d], pred_lengths[bad_d],
                      label_lengths[bad_d])]
    if good.numel():
        good_d = good.to(dev)
        parts.insert(0, _native(logp[good_d], label[good_d], pred_h[good],
                                label_h[good]))
    order = torch.cat([good, bad]).argsort().to(dev)
    return torch.cat(parts)[order].to(pred.dtype)
