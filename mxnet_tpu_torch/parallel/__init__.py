"""Training on one device: ``ShardedTrainer`` and ``DataParallelTrainer``
(meshes, sharding rules and multi-GPU collectives come later)."""

from .trainer import DataParallelTrainer, ShardedTrainer

__all__ = ["DataParallelTrainer", "ShardedTrainer"]
