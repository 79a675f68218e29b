"""Training on one device: ``ShardedTrainer`` and ``DataParallelTrainer``,
and the device ``Mesh`` they are given (a mesh of one device; sharding
rules and multi-GPU collectives come later)."""

from .mesh import (Mesh, data_parallel_mesh, make_mesh, mesh_axis_size)
from .trainer import DataParallelTrainer, ShardedTrainer

__all__ = ["DataParallelTrainer", "Mesh", "ShardedTrainer",
           "data_parallel_mesh", "make_mesh", "mesh_axis_size"]
