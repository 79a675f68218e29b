"""ShardedEmbedding: the capture-eligible row-sparse embedding table."""

from __future__ import annotations

import torch

from ..gluon.block import HybridBlock
from ..symbol.symbol import Symbol
from . import prep as _prep


class ShardedEmbedding(HybridBlock):
    """Index -> vector lookup whose row-sparse gradient runs inside the
    captured train step (counterpart of
    ``mxnet_tpu/embedding/sharded.py``).

    The table parameter is ``embed_table`` (``weight`` aliases it).
    Three forward modes, chosen per call:

    - captured (``gluon.captured`` has ``prep.capture_scope`` open with
      this table's entry): the lookup reads the step's gathered unique
      rows by inverse index (``prep.rows_lookup``);
    - the eager tape (gradients on and the table trainable): the compact
      ``ops.indexing.sparse_embedding``, the captured step's oracle;
    - otherwise (inference, ``sparse_grad=False``): the dense
      ``F.Embedding`` gather.

    ``feature`` selects the id column(s) from the last axis of the input
    (an int or a slice), for recommender batches that carry categorical
    fields inside one feature tensor; None means the input is the ids.
    The host id prep applies the same selector to the same batch, so the
    block must read the step's ``data`` (or its feature slice) directly.
    Called with a Symbol it builds the dense ``Embedding`` node (feature
    selection raises there, as in the JAX package).  The JAX package's
    row-sharding of the table over a mesh waits for the next multi-GPU
    slice (ROADMAP queue 1 item 1b).
    """

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=True, feature=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._input_dim = int(input_dim)
        self._output_dim = int(output_dim)
        self._sparse_grad = bool(sparse_grad)
        if feature is not None and not isinstance(feature, (int, slice)):
            raise TypeError(
                "ShardedEmbedding: feature must be None, an int, or a "
                f"slice of the last input axis, got {type(feature)}")
        self._feature = feature
        self._kwargs = {"input_dim": int(input_dim),
                        "output_dim": int(output_dim)}
        with self.name_scope():
            self.embed_table = self.params.get(
                "embed_table", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    @property
    def weight(self):
        """Alias matching ``gluon.nn.Embedding.weight``."""
        return self.embed_table

    def _ids_shape(self, x):
        shp = tuple(x.shape)
        if self._feature is None:
            return shp
        if isinstance(self._feature, slice):
            start, stop, step = self._feature.indices(int(shp[-1]))
            return shp[:-1] + (len(range(start, stop, step)),)
        return shp[:-1]

    def hybrid_forward(self, F, x, embed_table):
        if isinstance(x, Symbol):
            if self._feature is not None:
                raise NotImplementedError(
                    "ShardedEmbedding feature selection has no symbolic "
                    "path: export the surrounding block with feature=None "
                    "inputs")
            return F.Embedding(x, embed_table, **self._kwargs)
        entry = _prep.scope_entry(id(self.weight))
        if entry is not None:
            rows, inv = entry
            return _prep.rows_lookup(
                rows, inv, self._ids_shape(x) + (self._output_dim,))
        ids = x if self._feature is None else x[..., self._feature]
        if self._sparse_grad and torch.is_grad_enabled() \
                and embed_table.requires_grad:
            from ..ops.indexing import sparse_embedding

            return sparse_embedding(ids, embed_table)
        return F.Embedding(ids, embed_table, **self._kwargs)

    def __repr__(self):
        return "{name}({i} -> {o}, {dt}{sp})".format(
            name=self.__class__.__name__, i=self._input_dim,
            o=self._output_dim, dt=self.weight.dtype,
            sp=", sparse_grad" if self._sparse_grad else "")
