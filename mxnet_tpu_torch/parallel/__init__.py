"""Training over one device or the ranks of a process group:
``ShardedTrainer`` and ``DataParallelTrainer``, the ``Mesh`` they are
given, the sharding rules and their placements, the collectives, ring and
Ulysses attention over an sp axis (``ring``) and the pipeline over a pp
axis (``pipeline``)."""

from . import collectives, mesh, sharding
from .mesh import (DP, EP, PP, SP, TP, Mesh, data_parallel_mesh,
                   default_mesh, make_mesh, mesh_axis_size, replicated,
                   set_default_mesh, sharded)
from .sharding import (EmbeddingRules, FSDPRules, MOE_EP_RULES, PPRules,
                       PartitionSpec, ShardingRules, TRANSFORMER_TP_RULES,
                       annotate_activations, annotate_block, batch_sharding,
                       combined_rules, constrain, embedding_rules,
                       fsdp_rules, match_partition_rules, mesh_of_params,
                       param_sharding, pp_rules, shard_model)
from . import ring
from .ring import ring_attention, ulysses_attention
from . import pipeline
from .pipeline import (PipelineTrainer, pipeline_apply,
                       stack_stage_params)
from .trainer import DataParallelTrainer, ShardedTrainer

__all__ = ["DP", "EP", "PP", "SP", "TP", "DataParallelTrainer",
           "EmbeddingRules", "FSDPRules", "MOE_EP_RULES", "Mesh", "PPRules",
           "PartitionSpec", "PipelineTrainer", "ShardedTrainer",
           "ShardingRules", "TRANSFORMER_TP_RULES", "annotate_activations",
           "annotate_block", "batch_sharding", "collectives",
           "combined_rules", "constrain", "data_parallel_mesh",
           "default_mesh", "embedding_rules", "fsdp_rules", "make_mesh",
           "match_partition_rules", "mesh_axis_size", "mesh_of_params",
           "param_sharding", "pipeline", "pipeline_apply", "pp_rules",
           "replicated", "ring", "ring_attention", "set_default_mesh",
           "shard_model", "sharded", "sharding", "stack_stage_params",
           "ulysses_attention"]
