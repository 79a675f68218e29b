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

    ``dp_group``/``dp_size``: the data-parallel group whose statistics
    are global.  ``tp_group``/``tp_size``/``tp_rank``: the tensor-parallel
    group.  ``tp_shards``: {id(tensor): (dim, offset, full size)} for each
    tensor that holds a tp shard; an op that reads one marks it consumed
    (``consume``), and the trainer refuses a step that left a shard
    unread by a tp-aware op."""

    def __init__(self, dp_group=None, tp_group=None, tp_shards=None):
        self.dp_group = dp_group
        self.dp_size = _size(dp_group)
        self.tp_group = tp_group
        self.tp_size = _size(tp_group)
        self.tp_rank = dist.get_rank(tp_group) if tp_group is not None \
            else 0
        self.tp_shards = dict(tp_shards or {})
        self.consumed = set()

    def shard_of(self, t):
        """(dim, offset, full size) when ``t`` holds a tp shard, else
        None; marks it consumed."""
        info = self.tp_shards.get(id(t))
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

