"""Parallelism: the process mesh, data parallelism and ensemble parallelism
(port of parallel/; pipeline parallelism, ``PipelineConfig``,
``pipeline_apply`` and ``stack_stage_params``, is ROADMAP A21)."""
from .ensemble import ensemble_integrate, stack_solver_params
from .mesh import (
    Mesh,
    Shard,
    barrier,
    batch_sharding,
    host_local_batch_to_global,
    initialize_distributed,
    make_mesh,
    make_parallel_train_step,
    replicated,
    shard_opt_state_tp,
    shard_params_tp,
)

__all__ = [
    "ensemble_integrate",
    "stack_solver_params",
    "Mesh",
    "Shard",
    "barrier",
    "batch_sharding",
    "host_local_batch_to_global",
    "initialize_distributed",
    "make_mesh",
    "make_parallel_train_step",
    "replicated",
    "shard_opt_state_tp",
    "shard_params_tp",
]
