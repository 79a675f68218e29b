"""Contrib layers: ``Concurrent``, ``HybridConcurrent``, ``Identity``,
``SparseEmbedding``, ``SyncBatchNorm`` and ``PixelShuffle1D/2D/3D``.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py`` (reference:
python/mxnet/gluon/contrib/nn/basic_layers.py).  ``HybridConcurrent`` is
the model zoo's (``vision/squeezenet.py``), as in the JAX package.
``SparseEmbedding`` is ``nn.Embedding(sparse_grad=True)``: its weight
gets a row-sparse gradient on the eager tape
(``ops.indexing.sparse_embedding``).  ``SyncBatchNorm`` normalises with
the statistics of every rank's batch: inside a sharded step over the dp
group (where every ``BatchNorm`` does, as in the JAX package), elsewhere
over the whole process group (``collectives.sync_stats_scope``);
``num_devices`` is accepted and unused, the process group giving the
count.
"""

from __future__ import annotations

from .. import nn
from ..block import Block, HybridBlock
from ..model_zoo.vision.squeezenet import HybridConcurrent  # noqa: F401


class Concurrent(Block):
    """Parallel branches, their outputs concatenated along ``axis``
    (reference: contrib.nn.Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        from ... import ndarray as nd

        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """The identity (reference: contrib.nn.Identity)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(nn.Embedding):
    """An embedding whose weight gradient is row-sparse (reference:
    contrib.nn.SparseEmbedding)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         weight_initializer=weight_initializer,
                         sparse_grad=True, **kwargs)


class SyncBatchNorm(nn.BatchNorm):
    """Cross-device BatchNorm over axis 1 (reference:
    contrib.nn.SyncBatchNorm): training-mode statistics are summed over
    the ranks, forward and backward."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=
                         running_variance_initializer,
                         in_channels=in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ...parallel.collectives import sync_stats_scope

        with sync_stats_scope():
            return super().hybrid_forward(F, x, gamma, beta, running_mean,
                                          running_var)


class PixelShuffle1D(HybridBlock):
    """(N, C*f, W) -> (N, C, W*f) (reference: contrib.nn.PixelShuffle1D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        N, Cf, W = x.shape
        x = x.reshape((N, Cf // f, f, W))
        x = F.transpose(x, axes=(0, 1, 3, 2))
        return x.reshape((N, Cf // f, W * f))


class PixelShuffle2D(HybridBlock):
    """(N, C*f1*f2, H, W) -> (N, C, H*f1, W*f2) (reference:
    contrib.nn.PixelShuffle2D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor, factor)
        self._factors = tuple(int(f) for f in factor)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        N, C, H, W = x.shape
        c = C // (f1 * f2)
        x = x.reshape((N, c, f1, f2, H, W))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return x.reshape((N, c, H * f1, W * f2))


class PixelShuffle3D(HybridBlock):
    """(N, C*f1*f2*f3, D, H, W) -> (N, C, D*f1, H*f2, W*f3) (reference:
    contrib.nn.PixelShuffle3D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        if isinstance(factor, int):
            factor = (factor, factor, factor)
        self._factors = tuple(int(f) for f in factor)

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factors
        N, C, D, H, W = x.shape
        c = C // (f1 * f2 * f3)
        x = x.reshape((N, c, f1, f2, f3, D, H, W))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return x.reshape((N, c, D * f1, H * f2, W * f3))
