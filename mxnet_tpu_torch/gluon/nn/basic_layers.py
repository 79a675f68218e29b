"""Basic neural-network layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (reference:
python/mxnet/gluon/nn/basic_layers.py): Sequential, HybridSequential,
Dense, Dropout, BatchNorm, InstanceNorm, LayerNorm, GroupNorm, Embedding,
Flatten, Lambda, HybridLambda.

BatchNorm keeps the reference's rules: its mode is
``autograd.is_training()``; in training it moves the running statistics
to ``m * running + (1 - m) * batch`` (m = ``momentum``, 0.9) with the
batch's *biased* variance, in place and outside the tape (torch's
``batch_norm`` counts momentum the other way and keeps the unbiased
variance, so it is not used); ``cast("float16")`` keeps its parameters
in f32 while ``cast("bfloat16")`` casts them, running statistics
included.  ``Embedding(sparse_grad=True)`` gives its weight a row-sparse
gradient on the eager tape (``ops.indexing.sparse_embedding``).
"""

from __future__ import annotations

import warnings

import numpy as _np
import torch

from ... import autograd as _ag
from ...base import torch_dtype
from ...symbol.symbol import Symbol
from ..block import Block, HybridBlock
from .activations import Activation


class Sequential(Block):
    """Stacks Blocks sequentially (reference: nn.Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join([f"  ({key}): " +
                            repr(block).replace("\n", "\n  ")
                            for key, block in self._children.items()])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            warnings.warn(
                f"All children of this Sequential layer '{self.prefix}' are "
                "HybridBlocks. Consider using HybridSequential for the best "
                "performance.", stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Stacks HybridBlocks (reference: nn.HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join([f"  ({key}): " +
                            repr(block).replace("\n", "\n  ")
                            for key, block in self._children.items()])
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer y = act(xW^T + b) (reference: nn.Dense;
    op: src/operator/nn/fully_connected.cc)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def infer_shape(self, x, *args):
        if self._flatten:
            in_units = int(_np.prod(x.shape[1:]))
        else:
            in_units = x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units,
                               flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        shape = self.weight.shape
        return "{name}({layout}, {act})".format(
            name=self.__class__.__name__,
            act=self.act if self.act else "linear",
            layout=f"{shape[0]} -> {shape[1] if shape[1] else None}")


class Dropout(HybridBlock):
    """Dropout (reference: nn.Dropout; op: src/operator/nn/dropout.cc);
    the mask is drawn from the generator of the innermost
    ``random.generator_scope`` (the trainer's step generator)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def __repr__(self):
        return f"{self.__class__.__name__}(p = {self._rate}, " \
               f"axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization with moving-average running statistics
    (reference: nn.BatchNorm; op: src/operator/nn/batch_norm.cc); see the
    module note for the update rule."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        if in_channels != 0:
            self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (channels,)

    def cast(self, dtype):
        if torch_dtype(dtype) == torch.float16:
            dtype = "float32"  # reference: BN statistics stay fp32
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        if isinstance(x, Symbol):
            # a graph node: its executor picks the mode and, in training,
            # updates the auxiliary moving statistics (symbol.run_node)
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               **self._kwargs)
        training = _ag.is_training() and not self._use_global_stats
        if not training:
            return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                               output_mean_var=False, _is_training=False,
                               **self._kwargs)
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var,
            output_mean_var=True, _is_training=True, **self._kwargs)
        m = self._momentum
        with torch.no_grad():
            running_mean.copy_(m * running_mean + (1.0 - m) * mean)
            running_var.copy_(m * running_var + (1.0 - m) * var)
        return out

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return "{name}({content}, in_channels={in_channels})".format(
            name=self.__class__.__name__,
            content=", ".join(f"{k}={v}" for k, v in self._kwargs.items()),
            in_channels=in_channels if in_channels else None)


class InstanceNorm(HybridBlock):
    """Instance normalization (reference: nn.InstanceNorm)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    """Layer normalization (reference: nn.LayerNorm; op added ≥1.3)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "axis": axis, "center": center,
                        "scale": scale}
        self._axis = axis
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Group normalization (reference: nn.GroupNorm, ≥1.6)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x, *args):
        channels = x.shape[1]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Index -> vector lookup (reference: nn.Embedding;
    op: src/operator/tensor/indexing_op.cc)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = bool(sparse_grad)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight):
        if self._sparse_grad and isinstance(weight, torch.Tensor) \
                and torch.is_grad_enabled() and weight.requires_grad:
            # the eager tape: a compact row-sparse weight gradient
            from ...ops.indexing import sparse_embedding

            return sparse_embedding(x, weight)
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "{block_name}({input_dim} -> {output_dim}, {dtype})".format(
            block_name=self.__class__.__name__,
            input_dim=self._input_dim, output_dim=self._output_dim,
            dtype=self.weight.dtype)


class Flatten(HybridBlock):
    """Flattens to (batch, -1) (reference: nn.Flatten)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


class Lambda(Block):
    """Wraps a function or op name as a Block (reference: nn.Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            assert hasattr(nd, function), \
                f"Function name {function} is not found in ndarray."
            self._func_impl = getattr(nd, function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._func_name})"


class HybridLambda(HybridBlock):
    """Wraps a function or op name as a HybridBlock (reference:
    nn.HybridLambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            assert hasattr(nd, function), \
                f"Function name {function} is not found in ndarray."
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        elif callable(function):
            self._func = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: "
                             f"{function} of type {type(function)}")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._func_name})"
