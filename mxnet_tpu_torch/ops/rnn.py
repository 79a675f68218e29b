"""Fused multi-layer RNN op.

Counterpart of ``mxnet_tpu/ops/rnn.py`` (reference: src/operator/rnn.cc
and cudnn_rnn-inl.h): LSTM, GRU and the tanh/relu RNN over cuDNN's packed
parameter vector (all weights layer-major, then all biases; gate order
i f g o for LSTM, r z n for GRU), bidirectional, LSTMP, sequence-length
masking and the final-state clip.

The design is the JAX op's: per layer and direction, the input projection
of the whole sequence is one product (T*B x in) @ (in x G*H), accumulated
in f32 and cast to the input's dtype before ``+ bx``; only ``h @ Wh^T``
and the gates run inside the per-step loop, here a Python loop on tensors
where the JAX op has ``lax.scan``.  Gradients come from torch's autograd
through the loop.  No step goes through ``torch.nn.LSTM`` or cuDNN: their
dropout, masking and clip differ from the reference's.
"""

from __future__ import annotations

import torch

from .. import random as _random
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, input_size, state_size, num_layers=1,
                   bidirectional=False, projection_size=None):
    """Length of the packed parameter vector, the LSTMP projection rows
    included when ``projection_size`` is set."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    P = projection_size
    rec = P if P else state_size          # recurrent/output width
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else rec * dirs
        for _ in range(dirs):
            size += gates * state_size * (in_sz + rec)         # Wx, Wh
            if P:
                size += P * state_size                         # Wr
            size += 2 * gates * state_size                     # bx, bh
    return size


def _unpack_params(params, mode, input_size, state_size, num_layers,
                   dirs, projection_size=None):
    """Split the packed vector into per-layer/direction ``(Wx, Wh, Wr)``
    (``Wr`` None without LSTMP) and ``(bx, bh)``, as views."""
    gates = _GATES[mode]
    H = state_size
    P = projection_size
    rec = P if P else H
    weights, biases = [], []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else rec * dirs
        for _ in range(dirs):
            wx = params[off:off + gates * H * in_sz].reshape(
                gates * H, in_sz)
            off += gates * H * in_sz
            wh = params[off:off + gates * H * rec].reshape(gates * H, rec)
            off += gates * H * rec
            wr = None
            if P:
                wr = params[off:off + P * H].reshape(P, H)
                off += P * H
            weights.append((wx, wh, wr))
    for layer in range(num_layers):
        for _ in range(dirs):
            bx = params[off:off + gates * H]
            off += gates * H
            bh = params[off:off + gates * H]
            off += gates * H
            biases.append((bx, bh))
    return weights, biases


def _cell_step(mode, wr=None):
    """``step(carry, xproj, wh, bh) -> (carry, out)`` for one time step."""
    if mode == "lstm":
        def step(carry, xproj, wh, bh):
            h, c = carry
            gates = xproj + h @ wh.t() + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c = f * c + i * g
            h = o * torch.tanh(c)
            if wr is not None:  # LSTMP: project the recurrent output
                h = h @ wr.t()
            return (h, c), h
        return step
    if mode == "gru":
        def step(carry, xproj, wh, bh):
            (h,) = carry
            hproj = h @ wh.t() + bh
            xr, xz, xn = xproj.chunk(3, dim=-1)
            hr, hz, hn = hproj.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            return (h,), h
        return step
    act = torch.tanh if mode == "rnn_tanh" else torch.relu

    def step(carry, xproj, wh, bh):
        (h,) = carry
        h = act(xproj + h @ wh.t() + bh)
        return (h,), h
    return step


def _project(x, wx, bx):
    """The whole sequence's input projection, accumulated in f32 and cast
    to ``x``'s dtype before the bias."""
    if x.dtype == torch.float32:
        xw = torch.matmul(x, wx.t())
    else:
        xw = torch.matmul(x.float(), wx.float().t()).to(x.dtype)
    return xw + bx


def _run_direction(x, h0, c0, wx, wh, bx, bh, mode, reverse, wr=None,
                   seq_len=None):
    """x: (T, B, in) -> outputs (T, B, H|P) and the final carry (h[, c]).

    With ``seq_len`` (B,), a step at t >= len neither updates the carry
    nor emits output (it emits zeros).  The reverse direction walks the
    global flip of the sequence, t = T-1 .. 0, so its invalid tail steps
    come first and are frozen no-ops: each sequence is reversed within
    its own valid region."""
    T = x.shape[0]
    step = _cell_step(mode, wr)
    xproj = _project(x, wx, bx)
    carry = (h0, c0) if mode == "lstm" else (h0,)
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new_carry, out = step(carry, xproj[t], wh, bh)
        if seq_len is not None:
            valid = (t < seq_len)[:, None]
            new_carry = tuple(torch.where(valid, n, o)
                              for n, o in zip(new_carry, carry))
            out = torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
        carry = new_carry
        outs[t] = out
    return torch.stack(outs), carry


@register("RNN", aliases=("rnn",), mode_dependent=True, random=True)
def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, use_sequence_length=False,
        sequence_length=None, projection_size=None, _is_training=True,
        _key=None):
    """Fused RNN forward.  data: (T, B, input) TNC; state: (L*D, B, H|P)
    (and state_cell (L*D, B, H) for LSTM); returns the output (T, B,
    (H|P)*D), with the final states when ``state_outputs``.

    The state clip bounds the final ``c`` only, not the recurrence (the
    reference's cuDNN path clips inside).  Dropout ``p`` applies between
    layers, never after the last, in training mode, as
    ``where(mask, x / (1 - p), 0)``; the mask is drawn from the generator
    ``_key`` on the data's device."""
    T, B, input_size = data.shape
    H = state_size
    dirs = 2 if bidirectional else 1
    seq_len = None
    if use_sequence_length:
        if sequence_length is None:
            raise ValueError("use_sequence_length=True needs "
                             "sequence_length (B,)")
        seq_len = sequence_length.to(torch.int32)
    weights, biases = _unpack_params(parameters, mode, input_size, H,
                                     num_layers, dirs, projection_size)
    x = data
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs_dir = []
        for d in range(dirs):
            idx = layer * dirs + d
            wx, wh, wr = weights[idx]
            bx, bh = biases[idx]
            h0 = state[idx]
            c0 = state_cell[idx] if mode == "lstm" else None
            outs, final = _run_direction(x, h0, c0, wx, wh, bx, bh, mode,
                                         reverse=(d == 1), wr=wr,
                                         seq_len=seq_len)
            outs_dir.append(outs)
            h_finals.append(final[0])
            if mode == "lstm":
                c = final[1]
                if lstm_state_clip_min is not None and \
                        lstm_state_clip_max is not None:
                    c = torch.clamp(c, lstm_state_clip_min,
                                    lstm_state_clip_max)
                c_finals.append(c)
        x = outs_dir[0] if dirs == 1 else torch.cat(outs_dir, dim=-1)
        if p > 0 and _is_training and layer < num_layers - 1:
            mask = _random.keep_mask(x.shape, 1.0 - p, _key, x.device)
            x = torch.where(mask, x / (1.0 - p), torch.zeros(
                (), dtype=x.dtype, device=x.device)).to(x.dtype)
    output = x
    if not state_outputs:
        return output
    h_out = torch.stack(h_finals, dim=0)
    if mode == "lstm":
        return output, h_out, torch.stack(c_finals, dim=0)
    return output, h_out
