"""Gradient compression for KVStore synchronisation.

Counterpart of ``mxnet_tpu/gradient_compression.py`` (reference:
src/kvstore/gradient_compression.cc): threshold 2-bit quantisation with
per-key error feedback (residuals), enabled with
``kvstore.set_gradient_compression({'type': '2bit', 'threshold': t})`` or
``gluon.Trainer(compression_params=...)``.  ``2bit`` packs four 2-bit
codes a uint8, and the cross-process exchange is an all-gather of the
packed codes, decoded and summed on the rank's device; ``fp16`` sends
half-precision values with error feedback.  The quantisation is the
reference's:

    q_i =  +threshold   if (g+r)_i >= threshold
           -threshold   if (g+r)_i <= -threshold
           0            otherwise
    r   <- (g+r) - q          (error feedback)
"""

from __future__ import annotations

import torch

from .base import MXNetError

_SHIFTS = (0, 2, 4, 6)


class GradientCompression:
    """Per-KVStore compression state: type, threshold, per-key
    residuals."""

    # Every mode keeps a PER-KEY residual of the key's own shape:
    # compressing a flat bucket of many keys would merge their residuals,
    # so KVStore.bucketed_pushpull falls back to per-key pushpull.
    supports_bucketing = False

    def __init__(self, params):
        params = dict(params or {})
        self.type = params.pop("type", "2bit")
        self.threshold = float(params.pop("threshold", 0.5))
        if params:
            raise MXNetError(
                f"unknown gradient compression params {sorted(params)}")
        if self.type not in ("2bit", "fp16"):
            raise MXNetError(
                f"gradient compression type '{self.type}' is not "
                "supported (2bit, fp16)")
        if self.type == "2bit" and self.threshold <= 0:
            raise MXNetError("2bit compression needs a positive threshold")
        self._residual = {}

    def _accumulate(self, key, grad):
        r = self._residual.get(key)
        return grad if r is None else grad + r

    def _threshold_quantize(self, acc):
        t = torch.tensor(self.threshold, dtype=acc.dtype, device=acc.device)
        pos = acc >= t
        neg = acc <= -t
        q = torch.where(pos, t, torch.where(neg, -t, torch.zeros_like(acc)))
        return pos, neg, q

    def quantize(self, key, grad):
        """This worker's dequantised contribution; updates the
        residual."""
        acc = self._accumulate(key, grad)
        if self.type == "fp16":
            q = acc.to(torch.float16).to(grad.dtype)
        else:
            _, _, q = self._threshold_quantize(acc)
        self._residual[key] = acc - q
        return q

    def quantize_fp16_wire(self, key, grad):
        """fp16 mode: the half-precision tensor itself, so the exchange
        carries f16 bytes; the residual holds what the rounding lost."""
        if self.type != "fp16":
            raise MXNetError("quantize_fp16_wire needs type 'fp16'")
        acc = self._accumulate(key, grad)
        h = acc.to(torch.float16)
        self._residual[key] = acc - h.to(grad.dtype)
        return h

    def quantize_rowsparse(self, key, ids, vals):
        """Error feedback for a compact row-sparse gradient, over the
        union of this gradient's rows and the rows still owing residual;
        the residual stays compact (rows whose residual quantises away are
        dropped).  Returns ``(union_ids, q_vals)``, the ids sorted."""
        ids = torch.as_tensor(ids).to(torch.int64).reshape(-1)
        vals = torch.as_tensor(vals)
        uid, inv = torch.unique(ids, sorted=True, return_inverse=True)
        summed = vals.new_zeros((uid.shape[0],) + tuple(vals.shape[1:]))
        summed.index_add_(0, inv.reshape(-1), vals)
        prev = self._residual.get(key)
        if prev is None:
            union, acc = uid, summed
        else:
            pids, pvals = prev
            union = torch.unique(torch.cat([pids, uid]), sorted=True)
            acc = vals.new_zeros((union.shape[0],) + tuple(vals.shape[1:]))
            acc.index_add_(0, torch.searchsorted(union, pids), pvals)
            acc.index_add_(0, torch.searchsorted(union, uid), summed)
        if self.type == "fp16":
            q = acc.to(torch.float16).to(vals.dtype)
        else:
            _, _, q = self._threshold_quantize(acc)
        res = acc - q
        owing = (res != 0).reshape(res.shape[0], -1).any(dim=1)
        keep = torch.nonzero(owing).reshape(-1)
        if keep.numel():
            self._residual[key] = (union[keep], res[keep])
        else:
            self._residual.pop(key, None)
        return union, q

    def codes(self, key, grad):
        """2bit only: quantise with error feedback and return the PACKED
        uint8 codes (four values a byte: 1 = +t, 2 = -t, 0 = 0)."""
        if self.type != "2bit":
            raise MXNetError("codes needs type '2bit'")
        acc = self._accumulate(key, grad)
        pos, neg, q = self._threshold_quantize(acc)
        self._residual[key] = acc - q
        c = pos.to(torch.uint8) | (neg.to(torch.uint8) << 1)
        flat = c.reshape(-1)
        pad = (-flat.numel()) % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        quads = flat.reshape(-1, 4)
        return (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
                | (quads[:, 3] << 6))

    @staticmethod
    def decode_sum(packed_rows, n, threshold, dtype):
        """Decode a (W, ceil(n/4)) stack of packed code rows and sum the
        dequantised contributions -> dense (n,) of ``dtype``."""
        from .base import torch_dtype

        dtype = torch_dtype(dtype)
        shifts = torch.tensor(_SHIFTS, dtype=torch.uint8,
                              device=packed_rows.device)
        bits = (packed_rows[:, :, None] >> shifts[None, None, :]) & 3
        codes = bits.reshape(packed_rows.shape[0], -1)[:, :n]
        t = torch.tensor(threshold, dtype=dtype, device=packed_rows.device)
        vals = torch.where(codes == 1, t,
                           torch.where(codes == 2, -t,
                                       torch.zeros((), dtype=dtype,
                                                   device=t.device)))
        return vals.sum(dim=0, dtype=dtype)

    def reset(self):
        self._residual.clear()
