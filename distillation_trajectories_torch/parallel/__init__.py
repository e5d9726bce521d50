"""Multi-device lanes over ``torch.distributed``: the ``(data, model)``
mesh with its sharded train state and batches, process-group
initialization, spatial partitioning of the eval forward, and the student
sweep that trains every student at once.

Usage: ``torchrun --nproc_per_node=N`` one process per rank,
``initialize_distributed()``, then ``Config.mesh_shape`` (or
``spatial_shape``) selects the lane in the trainers and samplers.
"""
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    mesh_from_config,
    batch_sharding,
    replicated,
    param_spec,
    shard_params,
    shard_train_state,
    shard_batch,
)
from .distributed import initialize_distributed, make_global_mesh
from .spatial import (
    SPATIAL_AXIS,
    make_spatial_mesh,
    spatial_batch_sharding,
    shard_batch_spatial,
    make_spatial_eval_fn,
    make_spatial_forward,
)
from .sweep import distill_students_parallel
