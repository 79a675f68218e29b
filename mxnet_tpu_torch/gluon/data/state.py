"""Checkpointable input-pipeline state (exactly-once sample accounting).

Counterpart of ``mxnet_tpu/gluon/data/state.py``:
:class:`DataPipelineState` is one small, JSON-serializable record of
WHERE the pipeline is (epoch, global sample cursor, batch ordinal,
quarantined batches) that `DataLoader`, `DevicePrefetcher` and the `io`
iterators expose through ``state_dict()/load_state_dict()``.

Exactness model
---------------
The epoch's global sample order is a **pure function of (seed, epoch)**
(:func:`epoch_order` — its own `numpy.random.Generator`, never the
global RNG), so any rank of any world size can reconstruct it, and the
two packages draw the same order.  The cursor counts samples *delivered*
this epoch, globally: rank ``r`` of ``w`` draws ``order[cursor:][r::w]``,
which partitions the REMAINING sample space of the in-flight epoch for
ANY ``w``.  The cursor advances at batch *delivery* time (never at
prefetch or submission time), so prefetched-but-undelivered batches are
simply discarded on restore and re-fetched from the cursor.

Quarantine: batches identified by ``(epoch, batch ordinal)`` are skipped
on replay, loudly (one ``batch_quarantined`` telemetry event per skip,
emitted by the consuming iterator).

This module is numpy and the standard library only: it loads in spawned
loader workers.
"""

from __future__ import annotations

import numpy as _np

#: bumped when the state_dict layout changes incompatibly
STATE_VERSION = 1


def epoch_order(seed, epoch, length, shuffle=True):
    """The global sample order of one epoch, as a numpy index array.

    A pure function of ``(seed, epoch)``: the permutation comes from a
    dedicated ``numpy.random.Generator`` seeded with exactly those two
    ints (never the global RNG), so every rank — and every *future*
    rank, after an elastic reshape — reconstructs the identical order.
    """
    if not shuffle:
        return _np.arange(int(length), dtype=_np.int64)
    rng = _np.random.default_rng([int(seed) & 0xffffffff, int(epoch)])
    return rng.permutation(int(length)).astype(_np.int64)


class DataPipelineState:
    """Position of a resumable input pipeline.

    Global fields (identical on every rank, adopted by
    ``load_state_dict``): ``seed``, ``shuffle``, ``epoch``, ``cursor``
    (samples consumed this epoch, across all ranks), ``batch_idx`` (batch
    rounds delivered or quarantine-skipped this epoch), ``samples_seen``
    (lifetime samples delivered, across all ranks), and the quarantine
    set.  Local fields (kept through ``load_state_dict`` — this is the
    N→M re-shard): ``rank`` and ``world``.
    """

    def __init__(self, length, seed=0, shuffle=True, rank=0, world=1):
        self.length = int(length)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.rank = int(rank)
        self.world = int(world)
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"DataPipelineState: rank {self.rank} outside world "
                f"{self.world}")
        self.epoch = 0
        self.cursor = 0
        self.batch_idx = 0
        self.samples_seen = 0
        self.quarantined = set()   # {(epoch, batch_idx)}
        self.last_delivered = None  # (epoch, batch_idx) of newest batch

    # -- sharding --------------------------------------------------------------

    def order(self):
        return epoch_order(self.seed, self.epoch, self.length,
                           self.shuffle)

    def remaining(self):
        """Samples of the in-flight epoch not yet consumed (global)."""
        return max(0, self.length - self.cursor)

    def shard(self):
        """THIS rank's slice of the remaining epoch, in delivery order.

        ``order[cursor:][rank::world]`` — the union over ranks is
        exactly the un-consumed sample set, for any world size.
        """
        return self.order()[self.cursor:][self.rank::self.world]

    def shard_len(self):
        rem = self.remaining()
        if rem <= self.rank:
            return 0
        return (rem - self.rank + self.world - 1) // self.world

    # -- accounting (delivery order only) --------------------------------------

    def _global_advance(self, n_local):
        """Samples the whole gang consumed when this rank consumed
        ``n_local``: every rank's round draws from the same interleaved
        remainder, so one round is ``n_local * world`` capped at what
        was left (ragged final round)."""
        return min(int(n_local) * self.world, self.remaining())

    def advance(self, n_local):
        """One batch of ``n_local`` samples DELIVERED on this rank."""
        adv = self._global_advance(n_local)
        self.cursor += adv
        self.samples_seen += adv
        self.last_delivered = (self.epoch, self.batch_idx)
        self.batch_idx += 1
        return adv

    def skip(self, n_local):
        """One quarantined batch skipped: the cursor moves past its
        samples but nothing was delivered (``samples_seen`` untouched)."""
        adv = self._global_advance(n_local)
        self.cursor += adv
        self.batch_idx += 1
        return adv

    def next_epoch(self):
        self.epoch += 1
        self.cursor = 0
        self.batch_idx = 0

    # -- quarantine ------------------------------------------------------------

    @staticmethod
    def _batch_id(bid):
        if isinstance(bid, (tuple, list)) and len(bid) == 2:
            return (int(bid[0]), int(bid[1]))
        raise ValueError(
            f"batch id must be an (epoch, batch_idx) pair, got {bid!r}")

    def quarantine(self, batch_ids):
        """Add ``(epoch, batch_idx)`` ids to the quarantine set."""
        for bid in batch_ids:
            self.quarantined.add(self._batch_id(bid))

    def is_quarantined(self, epoch, batch_idx):
        return (int(epoch), int(batch_idx)) in self.quarantined

    # -- (de)serialization -----------------------------------------------------

    def state_dict(self):
        """JSON-serializable snapshot (rides MANIFEST.json verbatim)."""
        return {
            "version": STATE_VERSION,
            "length": self.length,
            "seed": self.seed,
            "shuffle": self.shuffle,
            "rank": self.rank,
            "world": self.world,
            "epoch": self.epoch,
            "cursor": self.cursor,
            "batch_idx": self.batch_idx,
            "samples_seen": self.samples_seen,
            "quarantined": sorted([list(q) for q in self.quarantined]),
        }

    def load_state_dict(self, sd):
        """Adopt a snapshot's GLOBAL position; keep the local
        rank/world (an N→M reshape is just a load under new ones).
        Raises ``ValueError`` on a version or dataset-length mismatch —
        silently mis-aligning the sample stream is the one failure mode
        this subsystem exists to prevent."""
        if not isinstance(sd, dict):
            raise ValueError(
                f"data pipeline state must be a dict, got "
                f"{type(sd).__name__}")
        version = sd.get("version")
        if version != STATE_VERSION:
            raise ValueError(
                f"data pipeline state version {version!r} "
                f"(this build reads {STATE_VERSION})")
        if int(sd["length"]) != self.length:
            raise ValueError(
                f"data pipeline state is for a dataset of "
                f"{sd['length']} samples; this loader has {self.length}")
        self.seed = int(sd["seed"])
        self.shuffle = bool(sd["shuffle"])
        self.epoch = int(sd["epoch"])
        self.cursor = int(sd["cursor"])
        self.batch_idx = int(sd["batch_idx"])
        self.samples_seen = int(sd["samples_seen"])
        self.quarantined = set(
            self._batch_id(q) for q in sd.get("quarantined", ()))
        self.last_delivered = None
        if not 0 <= self.cursor <= self.length:
            raise ValueError(
                f"data pipeline state cursor {self.cursor} outside "
                f"dataset of {self.length} samples")
        return self
