"""Normalisation, activation and dropout for the transformer trunk.

Counterpart of the pieces of ``mxnet_tpu/ops/nn.py`` the decoder path
uses: ``layer_norm`` (biased variance, eps 1e-5, computed in the input's
dtype as the JAX op does), the trunk's GELU and inverted ``dropout``.
``jax.nn.gelu`` defaults to the tanh approximation, so ``gelu`` here is
the tanh form; the erf form differs by up to ~1e-3 and fails parity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    """The trunk's activation by name: ``gelu`` or ``relu``."""
    if act_type == "gelu":
        return gelu(x)
    if act_type == "relu":
        return torch.relu(x)
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
