"""Data-parallel training over ranks, the 2-D data × model mesh, and
sharded volume inference (port of the JAX package's ``parallel``; see
``mesh.py`` and ``distributed.py``)."""
from .distributed import (global_batch_from_host, initialize_distributed,
                          is_main_process, launch, process_count,
                          process_index)
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh2D, create_mesh, create_mesh_2d,
                   gather_state_2d, local_mesh,
                   make_sharded_batched_synthesizer, make_sharded_synthesizer,
                   make_sharded_train_step, make_sharded_train_step_2d,
                   replicate_state, shard_batch, shard_state_2d,
                   state_sharding_2d)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "create_mesh", "local_mesh", "shard_batch",
    "replicate_state", "make_sharded_train_step",
    "create_mesh_2d", "Mesh2D", "make_sharded_train_step_2d",
    "shard_state_2d", "state_sharding_2d", "gather_state_2d",
    "make_sharded_synthesizer", "make_sharded_batched_synthesizer",
    "initialize_distributed", "launch", "process_count", "process_index",
    "is_main_process", "global_batch_from_host",
]
