"""Quantization ops (int8 inference).

Counterpart of ``mxnet_tpu/ops/quantization.py`` (reference:
src/operator/quantization/): ``quantize``/``quantize_v2``, ``dequantize``,
``requantize``, ``quantized_fully_connected`` and ``quantized_conv``,
registered under the JAX package's names and aliases, each returning the
reference's (data, min, max) triple where it does.

The numbers follow the JAX ops step by step:

- Every scale is an f32 tensor on the data's device, computed in the JAX
  op's order (``127 / max(|min|, |max|, 1e-8)``, ``max(|min|, |max|) /
  127``, ``s_data * s_w`` ...), never a Python double, and never a
  division by a Python scalar (CUDA divides by a host scalar as a
  multiplication by its reciprocal, which rounds differently).  Data of
  another float type is quantized in f32.
- Rounding is half to even (``torch.round``, as ``jnp.round``), then a
  clip to [-127, 127].
- int8 x int8 products accumulate exactly in int32.  On the card they run
  through ``torch._int_mm`` (cuBLASLt's int8 GEMM; the JAX op is a
  ``lax.dot_general`` with an int32 accumulator, XLA code, not a Pallas
  kernel), with zero rows and columns padded to its shape rules (more
  than 16 rows, K and N multiples of 8) and stripped after.  On the host
  the plain version multiplies the codes in f64, exact for any K below
  2^53 / 127^2, so both devices give the same int32 accumulators bit for
  bit.  torch's own int8 convolution is not used: on the CPU it returns
  int8 and wraps, and CUDA has none.
- A convolution is an im2col GEMM: the int8 data is padded, unfolded as
  a view (``Tensor.unfold`` a spatial axis, exact for any dtype) and laid
  out as channels-last rows (N * out spatial, C * kernel), the weight as
  (O, C * kernel).  A 1x1 convolution at stride 1 is a GEMM over the
  channels-last rows with no copy beyond the layout change.  The int32
  result comes back as an (N, O, *spatial) view of channels-last memory,
  which the elementwise ops after it keep, so the next convolution's
  rows are a view too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn import _tuple
from .registry import register

_INT32_LEVELS = 2147483647.0
_INT8_LEVELS = 127.0


def _f32(value, device):
    """``value`` (a tensor or a Python number) as an f32 tensor on
    ``device``: the JAX op's ``jnp.asarray`` of a range."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def _absmax(lo, hi, device):
    return torch.maximum(_f32(lo, device).abs(), _f32(hi, device).abs())


def _step(lo, hi, levels, device):
    """``max(|lo|, |hi|) / levels`` in f32: the value of one code."""
    return _absmax(lo, hi, device) / _f32(levels, device)


@register("_contrib_quantize", aliases=("quantize",))
def quantize(data, min_range, max_range, out_type="int8"):
    """Affine-quantize to int8 over the given range (reference:
    quantize.cc).  Returns (q, -r, r), r = 127 / scale."""
    if out_type != "int8":
        raise NotImplementedError("only int8 quantization is supported")
    dev = data.device
    levels = _f32(_INT8_LEVELS, dev)
    scale = levels / torch.maximum(_absmax(min_range, max_range, dev),
                                   _f32(1e-8, dev))
    q = torch.clamp(torch.round(data.to(torch.float32) * scale), -127, 127)
    r = levels / scale
    return q.to(torch.int8), -r, r


@register("_contrib_quantize_v2", aliases=("quantize_v2",))
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """Quantize over the data's own range, or over a calibrated one
    (reference: quantize_v2.cc)."""
    if min_calib_range is None or max_calib_range is None:
        lo, hi = torch.aminmax(data)
    else:
        lo, hi = min_calib_range, max_calib_range
    return quantize(data, lo, hi, out_type)


def _quant_levels(dtype):
    """int32 codes span 2^31 - 1, int8 codes 127 (the reference's range
    convention: the (min, max) pair spans the whole code range)."""
    return _INT32_LEVELS if dtype == torch.int32 else _INT8_LEVELS


@register("_contrib_dequantize", aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    step = _step(min_range, max_range, _quant_levels(data.dtype), data.device)
    return data.to(torch.float32) * step


@register("_contrib_requantize", aliases=("requantize",))
def requantize(data, min_range, max_range, out_type="int8",
               min_calib_range=None, max_calib_range=None):
    """int32 accumulator -> int8 over a new range (reference:
    requantize.cc)."""
    f = data.to(torch.float32) * _step(min_range, max_range,
                                       _quant_levels(data.dtype), data.device)
    if min_calib_range is None:
        lo, hi = torch.aminmax(f)
    else:
        lo, hi = min_calib_range, max_calib_range
    return quantize(f, lo, hi, out_type)


# -- int8 products ------------------------------------------------------------

def _pad_to(n, multiple, least=0):
    return max(least, -(-n // multiple) * multiple)


def int8_matmul(a, w):
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact: ``torch._int_mm``
    on the card (padded to its shape rules), the codes multiplied in f64
    on the host."""
    if a.device.type != "cuda":
        return (a.to(torch.float64) @ w.to(torch.float64).t()).to(torch.int32)
    M, K = a.shape
    N = w.shape[0]
    Mp, Kp, Np = _pad_to(M, 8, least=32), _pad_to(K, 8), _pad_to(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w = F.pad(w, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    if (Mp, Np) != (M, N):
        out = out[:M, :N]
    return out


def _im2col(x, kernel, stride, pad):
    """(N, C, *spatial) int8 -> ((N * out spatial, C * prod(kernel)) rows
    in channels-last order, out spatial)."""
    spatial = x.dim() - 2
    if any(pad):
        x = F.pad(x, [p for p in reversed(pad) for _ in (0, 1)])
    for i, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + i, k, s)
    # (N, C, *out, *kernel) -> (N, *out, C, *kernel)
    out = tuple(x.shape[2:2 + spatial])
    perm = [0] + list(range(2, 2 + spatial)) + [1] + list(
        range(2 + spatial, 2 + 2 * spatial))
    rows = x.permute(perm).reshape(-1, x.shape[1] * math.prod(kernel))
    return rows, out


def int8_conv(x, w, stride, pad, groups=1):
    """Grouped int8 convolution, (N, C, *spatial) by (O, C / groups,
    *kernel) -> (N, O, *out) int32, exact: im2col rows through
    :func:`int8_matmul`; the result is a channels-last view."""
    spatial = x.dim() - 2
    kernel = tuple(w.shape[2:])
    cg, og = x.shape[1] // groups, w.shape[0] // groups
    parts = []
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg] if groups > 1 else x
        wg = w[g * og:(g + 1) * og] if groups > 1 else w
        rows, out = _im2col(xg, kernel, stride, pad)
        parts.append(int8_matmul(rows, wg.reshape(og, -1)))
    acc = parts[0] if groups == 1 else torch.cat(parts, dim=1)
    acc = acc.reshape(x.shape[0], *out, w.shape[0])
    return acc.permute(0, spatial + 1, *range(1, spatial + 1))


def _with_bias(out, bias, min_bias, max_bias, out_scale, shape):
    s_b = _step(min_bias, max_bias, _INT8_LEVELS, out.device)
    b_i32 = torch.round(bias.to(torch.float32) * s_b / out_scale)
    return out + b_i32.to(torch.int32).reshape(shape)


def _out_scale(min_data, max_data, min_weight, max_weight, device):
    return _step(min_data, max_data, _INT8_LEVELS, device) * \
        _step(min_weight, max_weight, _INT8_LEVELS, device)


@register("_contrib_quantized_fully_connected",
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden=None,
                              no_bias=False, flatten=True):
    """int8 x int8 -> int32 FullyConnected (reference:
    quantized_fully_connected.cc).  Returns (out_i32, min_out, max_out)."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    out = int8_matmul(data.reshape(-1, data.shape[-1]).to(torch.int8),
                      weight.to(torch.int8)).reshape(*lead, weight.shape[0])
    out_scale = _out_scale(min_data, max_data, min_weight, max_weight,
                           out.device)
    if bias is not None and not no_bias:
        out = _with_bias(out, bias, min_bias, max_bias, out_scale, (-1,))
    r = _f32(_INT32_LEVELS, out.device) * out_scale
    return out, -r, r


@register("_contrib_quantized_conv", aliases=("quantized_conv",))
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None, kernel=None,
                   stride=None, pad=None, num_filter=None, num_group=1,
                   no_bias=False, layout=None):
    """int8 convolution with an int32 accumulator, channel-first data
    (reference: quantized_conv.cc)."""
    spatial = data.dim() - 2
    out = int8_conv(data.to(torch.int8), weight.to(torch.int8),
                    _tuple(stride or 1, spatial), _tuple(pad or 0, spatial),
                    int(num_group))
    out_scale = _out_scale(min_data, max_data, min_weight, max_weight,
                           out.device)
    if bias is not None and not no_bias:
        out = _with_bias(out, bias, min_bias, max_bias, out_scale,
                         (1, -1) + (1,) * spatial)
    r = _f32(_INT32_LEVELS, out.device) * out_scale
    return out, -r, r
