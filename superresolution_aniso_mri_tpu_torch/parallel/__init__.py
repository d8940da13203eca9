"""Data-parallel training over ranks and sharded volume inference (port
of the JAX package's ``parallel``; see ``mesh.py`` and
``distributed.py``)."""
from .distributed import (global_batch_from_host, initialize_distributed,
                          is_main_process, launch, process_count,
                          process_index)
from .mesh import (create_mesh, local_mesh,
                   make_sharded_batched_synthesizer, make_sharded_synthesizer,
                   make_sharded_train_step, replicate_state, shard_batch)

__all__ = [
    "create_mesh", "local_mesh", "shard_batch",
    "replicate_state", "make_sharded_train_step",
    "make_sharded_synthesizer", "make_sharded_batched_synthesizer",
    "initialize_distributed", "launch", "process_count", "process_index",
    "is_main_process", "global_batch_from_host",
]
