"""The scope a sharded step runs its forward under: which process group
a batch statistic is summed over (dp) and which tensors hold a tp shard.

A leaf module, outside ``parallel/`` so that the ops (``ops.nn``,
``ops.indexing``, ``ops.attention``) and the model zoo's losses import it
when they are loaded, without the package's import chain: each call
reads the open scope with one function call, and outside a sharded step
there is none.  ``parallel.collectives`` re-exports every name here.
"""

from __future__ import annotations

import contextlib
import threading

import torch.distributed as dist


def _size(group):
    return dist.get_world_size(group) if group is not None else 1


class _State(threading.local):
    def __init__(self):
        self.scopes = []


_STATE = _State()


class ParallelScope:
    """What a sharded forward runs under.

    ``dp_group``/``dp_size``: the group whose statistics are global, the
    ranks that split the global batch's tokens (dp, with sp and ep where
    the mesh has them), in the order of their blocks of the batch.
    ``tp_group``/``tp_size``/``tp_rank``: the tensor-parallel group.
    ``tp_shards``: {id(tensor): (dim, offset, full size)} for each
    tensor that holds a tp shard; an op that reads one marks it consumed
    (``consume``), and the trainer refuses a step that left a shard
    unread by a tp-aware op.  ``sp_group``/``sp_size``/``sp_rank``: the
    sequence-parallel group (a rank holds positions ``[sp_rank * T,
    (sp_rank + 1) * T)`` of each sequence, ``seq_offset``).
    ``ep_group``/``ep_shards``: the expert-parallel group and the tensors
    that hold this rank's experts, {id(tensor): (first expert, experts)},
    consumed like the tp shards.  ``row_shards``: the embedding tables
    whose vocab rows are split over the dp group (``EmbeddingRules``),
    {id(tensor): (first row, full rows)}, read by ``ShardedEmbedding``
    and consumed like the tp shards."""

    def __init__(self, dp_group=None, tp_group=None, tp_shards=None,
                 sp_group=None, ep_group=None, ep_shards=None,
                 row_shards=None):
        self.dp_group = dp_group
        self.dp_size = _size(dp_group)
        self.tp_group = tp_group
        self.tp_size = _size(tp_group)
        self.tp_rank = dist.get_rank(tp_group) if tp_group is not None \
            else 0
        self.tp_shards = dict(tp_shards or {})
        self.sp_group = sp_group
        self.sp_size = _size(sp_group)
        self.sp_rank = dist.get_rank(sp_group) if sp_group is not None \
            else 0
        self.ep_group = ep_group
        self.ep_shards = dict(ep_shards or {})
        self.row_shards = dict(row_shards or {})
        self.consumed = set()

    def shard_of(self, t):
        """(dim, offset, full size) when ``t`` holds a tp shard, else
        None; marks it consumed."""
        info = self.tp_shards.get(id(t))
        if info is not None:
            self.consumed.add(id(t))
        return info

    def rows_of(self, t):
        """(first row, full rows) when ``t`` holds this rank's block of a
        row-sharded table, else None; marks it consumed."""
        info = self.row_shards.get(id(t))
        if info is not None:
            self.consumed.add(id(t))
        return info

    def experts_of(self, t):
        """(first expert, experts) when ``t`` holds this rank's experts,
        else None; marks it consumed."""
        info = self.ep_shards.get(id(t))
        if info is not None:
            self.consumed.add(id(t))
        return info


@contextlib.contextmanager
def parallel_scope(scope):
    _STATE.scopes.append(scope)
    try:
        yield scope
    finally:
        _STATE.scopes.pop()


def current_scope():
    return _STATE.scopes[-1] if _STATE.scopes else None


def stat_group():
    """The group a batch statistic is summed over: the open scope's dp
    group, or None (local statistics)."""
    s = current_scope()
    return None if s is None else s.dp_group


def seq_offset(T):
    """The first position of this rank's T positions of each sequence: 0
    outside a sequence-parallel step."""
    s = current_scope()
    return 0 if s is None or s.sp_group is None else s.sp_rank * int(T)
