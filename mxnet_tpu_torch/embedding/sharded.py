"""ShardedEmbedding: the capture-eligible row-sparse embedding table,
and its lookup when the table's vocab rows are split over ranks."""

from __future__ import annotations

import torch

from .._parallel_scope import current_scope

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
    selection raises there, as in the JAX package).  Under
    ``parallel.ShardedTrainer`` on a rank mesh, ``EmbeddingRules`` splits
    the table's vocab rows over the data axis: a rank holds its block of
    rows, and the lookup is ``row_sharded_lookup`` over the dp group (a
    vocab the axis does not divide replicates, and the lookup is local).
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
        scope = current_scope()
        rows = scope.rows_of(embed_table) if scope is not None else None
        if rows is not None:
            ids = x if self._feature is None else x[..., self._feature]
            return row_sharded_lookup(ids, embed_table, rows[0], rows[1],
                                      scope.dp_group)
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


def row_sharded_lookup(ids, local, first, vocab, group):
    """``table[ids]`` where this rank holds rows ``[first, first +
    local.shape[0])`` of a ``vocab``-row table whose rows are split in
    equal blocks over ``group``: each id goes to the rank owning its row
    and the row comes back, through two padded exchanges
    (``collectives.all_to_all_single``, each rank's block padded to the
    most ids any rank sends any other, the counts all-gathered first).
    Differentiable: the gradient rows travel back to their owner, which
    sums them into its block (its gradient holds every rank's ids).  Ids
    clip into [0, vocab), as ``Embedding`` clips them."""
    import torch.distributed as dist

    from ..parallel import collectives as _coll

    n = dist.get_world_size(group)
    per = local.shape[0]
    flat = ids.reshape(-1).to(device=local.device, dtype=torch.int64) \
        .clamp(0, vocab - 1)
    owner = flat // per
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n)
    table = _coll.all_gather_dim(counts[None], group)     # (src, dst)
    width = max(int(table.max()), 1)
    # slot k of block j: this rank's k-th id owned by rank j (padded
    # with row 0 of the owner's block, whose row is dropped on return)
    starts = torch.cumsum(counts, 0) - counts
    rank_of = owner[order]
    slot = torch.arange(flat.numel(), device=flat.device) - starts[rank_of]
    send = torch.zeros((n, width), dtype=torch.int64, device=flat.device)
    send[rank_of, slot] = flat[order] - rank_of * per
    asked = _coll.all_to_all_single(send, group)          # (src, width)
    rows = local.index_select(0, asked.reshape(-1)).reshape(
        n, width, local.shape[1])
    back = _coll.all_to_all_single(rows, group)           # (owner, ...)
    got = back[rank_of, slot]
    out = torch.empty_like(got)
    out[order] = got
    return out.reshape(tuple(ids.shape) + (local.shape[1],))
