"""The dense product, normalisation, activation and dropout of the
transformer models.

Counterpart of the pieces of ``mxnet_tpu/ops/nn.py`` the GPT and BERT
paths use: ``fully_connected``, ``layer_norm`` (biased variance, eps 1e-5,
computed in the input's dtype as the JAX op does), ``activation`` (GELU,
ReLU, tanh) and inverted ``dropout``.  ``jax.nn.gelu`` defaults to the
tanh approximation, so ``gelu`` here is the tanh form; the erf form
differs by up to ~1e-3 and fails parity.

Products in the stream dtype.  The JAX op multiplies with
``preferred_element_type=float32`` and casts the result back: bf16
operands, an f32 accumulator, a bf16 result.  ``fully_connected`` hands
``torch.matmul`` the operands in their own dtype when they share it.  A
bf16 matmul has just that contract on both devices: cuBLAS runs bf16
GEMMs on the tensor cores with an f32 compute type, and the CPU's bf16
GEMM accumulates in f32; either rounds the sum to bf16 once.  The other
route, ``torch.mm(..., out_dtype=torch.float32)`` and a cast, has no CPU
kernel in every build and writes an f32 intermediate twice the size.
Nothing here touches ``torch.backends.cuda.matmul`` flags: how far cuBLAS
may reduce in bf16 is the calling program's setting.  Operands of
different dtypes (a bf16 stream through f32 weights) multiply in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fully_connected(data, weight, bias=None, flatten=True):
    """y = x W^T + b with ``weight`` laid out (num_hidden, in), as the JAX
    op; ``flatten`` folds every axis after the first into one first.  The
    product runs in the operands' dtype with an f32 accumulator (module
    note), the result is cast to ``data``'s dtype, then the bias is
    added."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    if data.dtype == weight.dtype:
        out = torch.matmul(data, weight.t())
    else:
        out = torch.matmul(data.float(), weight.float().t()).to(data.dtype)
    return out if bias is None else out + bias


def layer_norm(data, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis: (x - mean) / sqrt(var + eps) * gamma
    + beta with the biased variance."""
    mean = data.mean(dim=-1, keepdim=True)
    var = (data - mean).square().mean(dim=-1, keepdim=True)
    return (data - mean) * torch.rsqrt(var + eps) * gamma + beta


def gelu(x):
    """GELU, tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def activation(x, act_type):
    """An activation by name: ``gelu`` (tanh form), ``relu`` or
    ``tanh``."""
    if act_type == "gelu":
        return gelu(x)
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unsupported activation {act_type!r}")


def dropout(x, p, generator):
    """Inverted dropout in training mode: keep each element with
    probability ``1 - p`` and scale it by ``1 / (1 - p)``, as the JAX op's
    ``where(bernoulli(keep), x / keep, 0)``.  The mask is drawn from
    ``generator``, which must live on x's device type."""
    if p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))
