"""Data parallelism and spatial partitioning over `torch.distributed` (the
JAX package's `parallel`)."""
from .mesh import (DATA_AXIS, DCN_AXIS, SPATIAL_AXIS,  # noqa: F401
                   Mesh, NamedSharding, all_gather_rows, all_reduce_grads,
                   all_reduce_sum, axis_group, batch_sharding,
                   current_mesh, data_shard,
                   data_axis_names, data_group, draw_rows, global_rows,
                   image_sharding, initialize, is_first_rank,
                   is_main_process, local_batch_size, make_hybrid_mesh,
                   make_mesh, make_mesh_for_batch, make_serve_mesh,
                   make_train_mesh, process_index, reduce_sum, replicate,
                   replicated_sharding, shard_batch, shard_batch_auto,
                   shard_batch_local, use_mesh, world_size)
from . import spatial  # noqa: F401,E402
