"""Neural-network ops on tensors.

Counterpart of ``mxnet_tpu/ops/nn.py`` (reference: src/operator/nn/):
FullyConnected, the activations, the softmax family, SoftmaxOutput,
Convolution and Deconvolution, Pooling, the normalisations (BatchNorm,
LayerNorm, RMSNorm, InstanceNorm, GroupNorm), Dropout, UpSampling and
BilinearResize2D, each registered under the JAX package's names and
aliases so ``mx.nd`` and Gluon's ``F`` reach them, and ``Cast_storage``
(the identity on a tensor; on NDArrays the storage dispatch in
``ndarray/register.py`` makes the compact arrays), and ``Custom``, the
opaque op that runs a registered ``operator.CustomOp`` on NDArrays.

Products in the stream dtype.  The JAX ops multiply with
``preferred_element_type=float32`` and cast the result back: bf16
operands, an f32 accumulator, a bf16 result.  ``fully_connected`` and
``convolution`` hand torch the operands in their own dtype when they share
it: cuBLAS and cuDNN run bf16 products on the tensor cores with an f32
accumulator, and the CPU's bf16 GEMM and convolution accumulate in f32;
either rounds the sum to bf16 once.  A bf16 convolution's backward runs
in bf16 too, as the JAX op's custom VJP does.  Nothing here touches
``torch.backends`` flags: TF32 and cuDNN's autotuner are the calling
program's settings.  Operands of different dtypes multiply in f32.

Layouts.  ``layout`` picks channel-first (``NCHW``, the default) or
channel-last (``NHWC`` ...) data; weights are O-I-spatial in both
(``_conv_dn`` of the JAX op), so one checkpoint loads into either.
Channel-last data reaches torch as a permuted view, (N, H, W, C) seen as
(N, C, H, W) with channels-last strides, which cuDNN runs as a
channels-last convolution: no copy of the activation is made.

Ties.  ``relu`` is ``jnp.maximum(x, 0)`` in the JAX package, whose
gradient at exactly 0 is 1/2 (``lax.max`` splits ties); ``torch.relu``'s
is 0.  The port follows the JAX package (``_Relu``).  Max-pooling routes a
window's gradient to its first maximum in both packages.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register
from .. import random as _random
from .._parallel_scope import current_scope, stat_group


def _tuple(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


# -- linear --------------------------------------------------------------------

@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x W^T + b with ``weight`` laid out (num_hidden, in), as the JAX
    op; ``flatten`` folds every axis after the first into one first.  The
    product runs in the operands' dtype with an f32 accumulator (module
    note), the result is cast to ``data``'s dtype, then the bias is
    added.

    Inside a sharded step (``parallel.collectives.parallel_scope``) a
    weight that holds a tp shard runs Megatron's way: sharded on its
    output dim (column-parallel), the rank's output columns are gathered
    over the tp group before the bias; sharded on its input dim
    (row-parallel), the rank multiplies its slice of the input features
    and the products are summed over the group, the bias added once
    after."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    scope = current_scope()
    shard = scope.shard_of(weight) if scope is not None else None
    if shard is not None:
        return _tp_fully_connected(data, weight, bias, no_bias, shard,
                                   scope.tp_group)
    out = _matmul_nt(data, weight)
    if bias is None or no_bias:
        return out
    return out + bias


def _tp_fully_connected(data, weight, bias, no_bias, shard, group):
    from ..parallel import collectives as coll

    dim, offset, _full = shard
    if dim == 0:
        out = _matmul_nt(coll.copy_to_region(data, group), weight)
        out = coll.gather_from_region(out, group, dim=-1)
    else:
        # the slice after the region: its backward sums every rank's
        # gradient of its own features into the whole input's
        x = coll.copy_to_region(data, group)[
            ..., offset:offset + weight.shape[1]]
        out = coll.reduce_from_region(_matmul_nt(x, weight), group)
    if bias is None or no_bias:
        return out
    return out + bias


def _matmul_nt(data, weight):
    if data.dtype == weight.dtype:
        return torch.matmul(data, weight.t())
    return torch.matmul(data.float(), weight.float().t()).to(data.dtype)


# -- activations ---------------------------------------------------------------

class _Relu(torch.autograd.Function):
    """max(x, 0) with the JAX package's gradient: 1 above 0, 1/2 at 0, 0
    below (``heaviside(x, 1/2)``).  Saves its input."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.heaviside(x, x.new_full((), 0.5))


def relu(x):
    """ReLU whose gradient at 0 is 1/2, as ``jnp.maximum(x, 0)``'s."""
    return _Relu.apply(x)


def gelu(x):
    """GELU, tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def _softsign(x):
    return x / (1 + x.abs())


_ACTS = {
    "relu": relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": _softsign,
    "gelu": gelu,
    "silu": F.silu,
    "swish": F.silu,
    "erf": torch.erf,
}


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    """An activation by name, the JAX op's ``_ACTS`` table: relu (tie
    gradient 1/2), sigmoid, tanh, softrelu, softsign, gelu (tanh form),
    silu/swish and erf."""
    if act_type not in _ACTS:
        raise ValueError(f"unsupported activation {act_type!r}")
    return _ACTS[act_type](data)


@register("LeakyReLU", aliases=("leaky_relu",))
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky, prelu (``gamma`` per channel on axis 1), elu, selu and rrelu
    (its mean slope, as the JAX op in every mode)."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() < data.dim() and data.dim() > 1:
            shape = [1] * data.dim()
            if g.numel() > 1:
                shape[1] = g.numel()
            g = g.reshape(shape)
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(pos, data, alpha * torch.expm1(data))
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, mid * data)
    raise ValueError(f"unknown LeakyReLU act_type {act_type}")


# -- softmax family ------------------------------------------------------------

@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax along ``axis``; ``length`` (one per row of dim 0) masks the
    positions at or past it with -inf first."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is not None:
        steps = torch.arange(data.shape[axis], device=data.device)
        shape = [1] * data.dim()
        shape[axis] = data.shape[axis]
        mask = steps.reshape(shape) < length.reshape(
            [-1] + [1] * (data.dim() - 1))
        data = data.masked_fill(~mask, float("-inf"))
    return torch.softmax(data, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


@register("softmin")
def softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed cross entropy of (batch, classes) logits against integer
    labels (given as floats)."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long()[:, None]).sum()


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax whose backward ignores the incoming gradient and emits
    ``grad_scale * (p - onehot(y))`` (src/operator/nn/softmax_output.cc),
    masked where the label is ``ignore_label`` and normalised by
    ``normalization``: "null" none, "batch" the batch size, "valid" the
    count of labels kept; the label's gradient is zero."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, smooth_alpha):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, normalization,
                   smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization, smooth_alpha = \
            ctx.cfg
        classes = out.shape[-1]
        ilabel = label.long()
        hit = (ilabel >= 0) & (ilabel < classes)
        onehot = F.one_hot(ilabel.clamp(0, classes - 1), classes).to(
            out.dtype) * hit[..., None].to(out.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / classes
        grad = out - onehot
        valid = None
        if use_ignore:
            mask = (ilabel != int(ignore_label)).to(out.dtype)
            grad = grad * mask[..., None]
            valid = torch.clamp(mask.sum(), min=1.0)
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid":
            if valid is None:
                valid = float(math.prod(out.shape[:-1]))
            grad = grad / valid
        return (grad_scale * grad, torch.zeros_like(label), None, None, None,
                None, None)


@register("SoftmaxOutput", aliases=("softmax_output",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1,
                   use_ignore=False, multi_output=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                int(ignore_label), bool(use_ignore),
                                str(normalization), float(smooth_alpha))


# -- convolution ---------------------------------------------------------------

_DEFAULT_LAYOUT = {3: "NCW", 4: "NCHW", 5: "NCDHW"}


def _layout(ndim, layout):
    lay = layout or _DEFAULT_LAYOUT[ndim]
    if len(lay) != ndim or set("NC") - set(lay):
        raise ValueError(f"bad conv layout {lay!r} for {ndim}d data")
    return lay


def _channel_pos(ndim, layout):
    return _layout(ndim, layout).index("C")


def _to_channel_first(data, layout):
    """``data`` as an (N, C, *spatial) view, and the permutation back
    (None when it already is)."""
    lay = _layout(data.dim(), layout)
    if lay.index("C") == 1:
        return data, None
    perm = [lay.index("N"), lay.index("C")] + [
        i for i, c in enumerate(lay) if c not in "NC"]
    inv = [perm.index(i) for i in range(data.dim())]
    return data.permute(perm), inv


def _back(out, inv):
    return out if inv is None else out.permute(inv)


def _same_dtype(data, weight, bias):
    """Operands for a product in ``data``'s dtype: a weight of another
    dtype makes the product run in f32 (module note)."""
    if weight.dtype == data.dtype:
        return data, weight, bias, None
    return (data.float(), weight.float(),
            None if bias is None else bias.float(), data.dtype)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Convolution", aliases=("convolution",))
def convolution(data, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                cudnn_tune=None, cudnn_off=False, workspace=1024, layout=None):
    """Grouped 1/2/3-D convolution; ``layout`` channel-first or
    channel-last, the weight O-I-spatial either way (module note).  The
    bias rides in the product call, so a bf16 output is rounded once."""
    spatial = data.dim() - 2
    x, inv = _to_channel_first(data, layout)
    b = None if no_bias else bias
    x, w, b, cast = _same_dtype(x, weight, b)
    out = _CONV[spatial](x, w, b, _tuple(stride or 1, spatial),
                         _tuple(pad or 0, spatial),
                         _tuple(dilate or 1, spatial), num_group)
    if cast is not None:
        out = out.to(cast)
    return _back(out, inv)


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, workspace=512,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution, weight (in, out/group, *k) as in the
    reference (src/operator/nn/deconvolution.cc); ``adj`` adds to the
    output's far edge.  ``target_shape`` is ignored, as in the JAX op."""
    spatial = data.dim() - 2
    x, inv = _to_channel_first(data, layout)
    b = None if no_bias else bias
    x, w, b, cast = _same_dtype(x, weight, b)
    out = _DECONV[spatial](x, w, b, _tuple(stride or 1, spatial),
                           _tuple(pad or 0, spatial),
                           _tuple(adj or 0, spatial), num_group,
                           _tuple(dilate or 1, spatial))
    if cast is not None:
        out = out.to(cast)
    return _back(out, inv)


# -- pooling -------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, stride, pads, value=0.0):
    """The sum over each window of ``x`` (N, C, *spatial) padded by
    ``pads`` ((lo, hi) per spatial axis) with ``value``."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat, value=value)
    if x.dim() == 3:        # avg_pool1d takes no divisor_override
        return F.avg_pool1d(x, kernel, stride) * kernel[0]
    return _AVG_POOL[x.dim() - 2](x, kernel, stride, 0, False, True,
                                  divisor_override=1)


@register("Pooling", aliases=("pooling",))
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None, p_value=2):
    """max, avg, sum and lp pooling, or their global forms, as the JAX op:
    ``stride`` defaults to 1; "valid" pads ``pad`` on both sides, "full"
    pads the far side up to the ceil-mode window count (never less than
    ``pad``); max pads with -inf; avg divides by the kernel's size, or
    with ``count_include_pad=False`` by the count of unpadded elements
    under each window."""
    spatial = data.dim() - 2
    x, inv = _to_channel_first(data, layout)
    if global_pool:
        axes = tuple(range(2, x.dim()))
        if pool_type == "max":
            out = x.amax(dim=axes, keepdim=True)
        elif pool_type == "avg":
            out = x.mean(dim=axes, keepdim=True)
        elif pool_type == "sum":
            out = x.sum(dim=axes, keepdim=True)
        elif pool_type == "lp":
            out = x.abs().pow(p_value).sum(dim=axes, keepdim=True).pow(
                1.0 / p_value)
        else:
            raise ValueError(f"unknown pool_type {pool_type}")
        return _back(out, inv)
    kernel = _tuple(kernel, spatial)
    stride = _tuple(stride or 1, spatial)
    pad = _tuple(pad or 0, spatial)
    if pooling_convention == "full":
        pads = []
        for n, k, s, p in zip(x.shape[2:], kernel, stride, pad):
            out_n = -(-(n + 2 * p - k) // s) + 1
            pads.append((p, max((out_n - 1) * s + k - n - p, p)))
    else:
        pads = [(p, p) for p in pad]
    symmetric = all(lo == hi and 2 * lo <= k
                    for (lo, hi), k in zip(pads, kernel))
    if pool_type != "max" and x.is_cuda and not x.is_contiguous():
        # avg_pool2d's CUDA backward on a channels-last view with padding
        # returns wrong gradients (PyTorch 2.11, checked on the H100
        # against the host): such windows pool a channel-first copy
        x = x.contiguous()
    if pool_type == "max":
        if symmetric:
            out = _MAX_POOL[spatial](x, kernel, stride, pad)
        else:
            flat = [p for lo_hi in reversed(pads) for p in lo_hi]
            out = _MAX_POOL[spatial](F.pad(x, flat, value=float("-inf")),
                                     kernel, stride)
    elif pool_type == "avg" and symmetric:
        out = _AVG_POOL[spatial](x, kernel, stride, pad, False,
                                 bool(count_include_pad))
    elif pool_type in ("avg", "sum"):
        out = _window_sum(x, kernel, stride, pads)
        if pool_type == "avg":
            if count_include_pad:
                out = out / math.prod(kernel)
            else:
                ones = torch.ones((1, 1) + tuple(x.shape[2:]),
                                  dtype=x.dtype, device=x.device)
                out = out / _window_sum(ones, kernel, stride, pads)
    elif pool_type == "lp":
        out = _window_sum(x.abs().pow(p_value), kernel, stride, pads).pow(
            1.0 / p_value)
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    return _back(out, inv)


# -- normalization -------------------------------------------------------------

def _stat_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm with ``_bn_train_core``'s arithmetic
    (``mxnet_tpu/ops/nn.py:403-471``): the sum and the sum of squares in
    f32 (f64 for f64 data; for bf16 data each is a reduction that widens
    ``x`` inside the kernel, no f32 copy of the activation), the biased
    variance clamped at 0, the output rounded to ``x``'s dtype once, and a
    backward that keeps ``(x, gamma, mean, inv)`` and takes gradients on
    the mean and variance outputs too."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, axis, group=None):
        axes = [i for i in range(x.dim()) if i != axis]
        shape = _stat_shape(x, axis)
        n = x.numel() // x.shape[axis]
        acc = torch.promote_types(x.dtype, torch.float32)
        s1 = torch.sum(x, dim=axes, dtype=acc)
        if x.dtype == acc:
            s2 = torch.sum(x * x, dim=axes)
        else:
            s2 = torch.linalg.vector_norm(x, 2, dim=axes, dtype=acc).square()
        if group is not None:
            # global statistics: the sums of every dp rank's batch
            from ..parallel.collectives import all_reduce_

            both = all_reduce_(torch.stack([s1, s2]), group, "bn_stats")
            s1, s2 = both[0], both[1]
            n = n * torch.distributed.get_world_size(group)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        g = gamma.to(acc)
        scale = (g * inv).reshape(shape)
        shift = (beta.to(acc) - g * inv * mean).reshape(shape)
        out = torch.addcmul(shift, x, scale).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axis, ctx.n, ctx.group = axis, n, group
        ctx.set_materialize_grads(False)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        axis, n = ctx.axis, ctx.n
        axes = [i for i in range(x.dim()) if i != axis]
        shape = _stat_shape(x, axis)
        acc = mean.dtype
        xc = x.to(acc) - mean.reshape(shape)
        dx = None
        dgamma = dbeta = None
        if dy is not None:
            dyf = dy.to(acc)
            xhat = xc * inv.reshape(shape)
            sum_dy = dyf.sum(dim=axes)
            sum_dy_xhat = (dyf * xhat).sum(dim=axes)
            # gamma and beta take this rank's sums (the trainer averages
            # their gradients over the dp ranks); x takes the global ones
            dgamma = sum_dy_xhat.to(gamma.dtype)
            dbeta = sum_dy.to(gamma.dtype)
            if ctx.group is not None:
                from ..parallel.collectives import all_reduce_

                both = all_reduce_(torch.stack([sum_dy, sum_dy_xhat]),
                                   ctx.group, "bn_grad_stats")
                sum_dy, sum_dy_xhat = both[0], both[1]
            coef = (gamma.to(acc) * inv).reshape(shape)
            dx = coef * (dyf - (sum_dy / n).reshape(shape)
                         - xhat * (sum_dy_xhat / n).reshape(shape))
        if ctx.group is not None and (dmean is not None
                                      or dvar is not None):
            from ..parallel.collectives import all_reduce_

            if dmean is not None:
                dmean = all_reduce_(dmean.to(acc).clone(), ctx.group)
            if dvar is not None:
                dvar = all_reduce_(dvar.to(acc).clone(), ctx.group)
        if dmean is not None:
            term = (dmean.to(acc) / n).reshape(shape).expand_as(xc)
            dx = term if dx is None else dx + term
        if dvar is not None:
            term = (dvar.to(acc) / n).reshape(shape) * 2.0 * xc
            dx = term if dx is None else dx + term
        if dx is not None:
            dx = dx.to(x.dtype)
        return dx, dgamma, dbeta, None, None, None


@register("BatchNorm", aliases=("batch_norm",), mode_dependent=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _is_training=True):
    """Functional BatchNorm.  In training mode (and without
    ``use_global_stats``) it normalises with the batch's statistics
    (``_BatchNormTrain``) and, with ``output_mean_var``, returns them in
    the moving statistics' dtype; the Gluon layer owns the moving-average
    update.  Inside a sharded step the statistics are those of the global
    batch: the sums are all-reduced over the dp group, forward and
    backward, as the JAX package's mean over a dp-sharded array is.  Otherwise it normalises with ``moving_mean``/``moving_var`` in
    f32.  ``fix_gamma`` uses ones for gamma."""
    axis = axis % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _is_training and not use_global_stats:
        out, mean, var = _BatchNormTrain.apply(data, g, beta, eps, axis,
                                               stat_group())
        if output_mean_var:
            return (out, mean.to(moving_mean.dtype),
                    var.to(moving_var.dtype))
        return out
    shape = _stat_shape(data, axis)
    inv = torch.rsqrt(moving_var.float() + eps).reshape(shape)
    meanf = moving_mean.float().reshape(shape)
    out = ((data.float() - meanf) * inv * g.float().reshape(shape)
           + beta.float().reshape(shape)).to(data.dtype)
    if output_mean_var:
        return out, moving_mean, moving_var
    return out


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """(x - mean) / sqrt(var + eps) * gamma + beta along ``axis`` with the
    biased variance, in the input's dtype, as the JAX op."""
    mean = data.mean(dim=axis, keepdim=True)
    var = (data - mean).square().mean(dim=axis, keepdim=True)
    shape = _stat_shape(data, axis % data.dim())
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


@register("RMSNorm", aliases=("rms_norm",))
def rms_norm(data, gamma, axis=-1, eps=1e-6):
    ms = data.square().mean(dim=axis, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma.reshape(
        _stat_shape(data, axis % data.dim()))


def _normalize(x, axes, eps):
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


@register("InstanceNorm", aliases=("instance_norm",))
def instance_norm(data, gamma, beta, eps=1e-3):
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return _normalize(data, tuple(range(2, data.dim())), eps) \
        * gamma.reshape(shape) + beta.reshape(shape)


@register("GroupNorm", aliases=("group_norm",))
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    x = _normalize(x, tuple(range(2, x.dim())), eps).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


# -- dropout -------------------------------------------------------------------

@register("Dropout", aliases=("dropout",), mode_dependent=True, random=True)
def dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            _is_training=True, _key=None):
    """Inverted dropout: in training mode (or ``mode="always"``) keep each
    element with probability ``1 - p`` and scale it by ``1 / (1 - p)``,
    the mask shared along ``axes``, as the JAX op's ``where(bernoulli(keep),
    x / keep, 0)``.  The mask is drawn from the generator ``_key``, which
    must live on the data's device type (the ``mx.nd`` wrapper passes the
    package chain's)."""
    if (not _is_training and mode != "always") or p <= 0.0:
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    mask = _random.keep_mask(shape, keep, _key, data.device)
    return torch.where(mask, data / keep,
                       torch.zeros((), dtype=data.dtype, device=data.device))


# -- resize / upsample ---------------------------------------------------------

def _bilinear(data, height, width):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres, a
    triangle filter widened when shrinking (antialiasing)."""
    return F.interpolate(data, size=(int(height), int(width)),
                         mode="bilinear", align_corners=False,
                         antialias=True)


@register("UpSampling", aliases=("upsampling",))
def upsampling(data, scale=2, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", workspace=512):
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    return _bilinear(data, data.shape[2] * scale, data.shape[3] * scale)


@register("BilinearResize2D", aliases=("bilinear_resize_2d",))
def bilinear_resize_2d(data, like=None, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size", align_corners=True):
    """Reference: src/operator/contrib/bilinear_resize.cc; ``mode`` picks
    how the output size is derived (size / scale / odd_scale / like /
    to_even_* / to_odd_*).  The resize itself is the JAX op's half-pixel
    bilinear one whatever ``align_corners`` says."""
    h, w = data.shape[2], data.shape[3]
    if mode == "like" and like is not None:
        height, width = like.shape[-2], like.shape[-1]
    elif scale_height is not None:
        sw = scale_width if scale_width is not None else scale_height
        height, width = int(h * scale_height), int(w * sw)
        if mode == "odd_scale":
            height += (height + 1) % 2
            width += (width + 1) % 2
    elif mode == "to_even_down":
        height, width = h - h % 2, w - w % 2
    elif mode == "to_even_up":
        height, width = h + h % 2, w + w % 2
    elif mode == "to_odd_down":
        height, width = h - (h + 1) % 2, w - (w + 1) % 2
    elif mode == "to_odd_up":
        height, width = h + (h + 1) % 2, w + (w + 1) % 2
    return _bilinear(data, height, width)


@register("Cast_storage", aliases=("cast_storage",))
def cast_storage(data, stype="default"):
    """A tensor is dense storage: the identity.  An NDArray's cast is
    ``ndarray.sparse.cast_storage``, reached through the storage
    dispatch."""
    return data


@register("Custom", opaque=True)
def custom(*data, op_type=None, **kwargs):
    """Run the ``operator.CustomOp`` registered as ``op_type`` (reference:
    src/operator/custom/custom.cc): opaque, it takes the NDArrays
    themselves and keeps its own tape entry."""
    from .. import operator as custom_mod

    return custom_mod._invoke_custom(op_type, data, kwargs)
