"""Data and spatial parallelism over ``torch.distributed`` (the port of
``masklab_tpu/parallel``): the mesh, the process-group helpers, the
parallel train and eval steps, the dp x sp layout (``mesh``) and the
multi-process worker (``multihost``)."""
from .mesh import (Mesh, data_ranks, free_port, initialize, make_mesh,
                   make_parallel_eval_step, make_parallel_train_step, rank,
                   replicate_state, shard_batch, sharded,
                   spatial_batch_sharding, spatial_ranks,
                   spatial_shard_batch, world)

__all__ = ['Mesh', 'make_mesh', 'initialize', 'world', 'rank', 'data_ranks',
           'shard_batch', 'replicate_state', 'spatial_batch_sharding',
           'spatial_shard_batch', 'spatial_ranks', 'sharded',
           'make_parallel_train_step', 'make_parallel_eval_step',
           'free_port']
