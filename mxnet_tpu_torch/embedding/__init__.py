"""Row-sparse embedding tables on the captured-step path (the recommender
workload).

Counterpart of ``mxnet_tpu/embedding/``:

- ``ShardedEmbedding``: a Gluon block whose table parameter is
  ``embed_table``.  Inside a captured step its lookup reads the batch's
  unique rows, gathered once, by inverse index (``prep.rows_lookup``);
  on the eager tape it is ``ops.indexing.sparse_embedding``, the oracle
  the captured step is held to bit for bit;
- the host id prep (``prep.prepare_step``): unique ids and the inverse
  index in numpy, padded to a power-of-two bucket that joins the capture
  key, so recordings are bounded by the buckets a workload hits; the
  ``DevicePrefetcher``'s producer thread can compute it one batch ahead
  (``stash_prep``/``pop_prep``);
- the row update runs through ``optimizer.grouped.sparse_row_kernel``,
  eager and captured alike.

``MXTPU_SPARSE_CAPTURED=0`` pins sparse configurations to the eager
oracle; every fallback emits a ``sparse_fallback{reason}`` telemetry
event.  The JAX package's row-sharding over a mesh (``EmbeddingRules``)
and its symbol path wait for the next multi-GPU slice (ROADMAP queue 1
item 1b) and the symbol slice.
"""

from .prep import (SparsePrep, bucket_for, capture_scope,
                   find_sparse_embeddings, pop_prep, prepare_one,
                   prepare_step, rows_lookup, scope_entry,
                   sparse_capture_reason, sparse_captured_enabled,
                   stash_prep, unique_bucket_env)
from .sharded import ShardedEmbedding

__all__ = [
    "ShardedEmbedding", "SparsePrep", "bucket_for", "capture_scope",
    "find_sparse_embeddings", "pop_prep", "prepare_one", "prepare_step",
    "rows_lookup", "scope_entry", "sparse_capture_reason",
    "sparse_captured_enabled", "stash_prep", "unique_bucket_env",
]
