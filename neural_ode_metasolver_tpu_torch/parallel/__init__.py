"""Parallelism (port of parallel/): the process mesh, data, tensor and
spatial parallelism, ensemble parallelism and GPipe pipeline
parallelism."""
from .ensemble import ensemble_integrate, stack_solver_params
from .pipeline import PipelineConfig, pipeline_apply, stack_stage_params
from .mesh import (
    Mesh,
    Shard,
    barrier,
    batch_sharding,
    gather_tree,
    host_local_batch_to_global,
    initialize_distributed,
    make_mesh,
    make_parallel_train_step,
    replicated,
    shard_opt_state_tp,
    shard_params_tp,
    shard_tree,
)

__all__ = [
    "ensemble_integrate",
    "PipelineConfig",
    "pipeline_apply",
    "stack_stage_params",
    "stack_solver_params",
    "batch_sharding",
    "host_local_batch_to_global",
    "initialize_distributed",
    "make_mesh",
    "make_parallel_train_step",
    "replicated",
    "shard_opt_state_tp",
    "shard_params_tp",
    "Mesh",
    "Shard",
    "barrier",
    "shard_tree",
    "gather_tree",
]
