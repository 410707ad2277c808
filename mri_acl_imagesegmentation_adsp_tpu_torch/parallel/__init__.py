"""Data parallelism over ranks of ``torch.distributed`` (the JAX package's
``parallel/mesh.py``); the model-parallel parts of its ``parallel/`` are
not ported yet."""

from .mesh import (
    DataGroup, all_reduce_, all_reduce_sum, any_rank, average_flat,
    barrier, choose_backend, distributed_init, env_group,
    gather_rows, host_major_grid, make_mesh, mesh_devices, row_slice,
    shard_rows, spawn, volume_affine_shards)

__all__ = [
    "DataGroup", "all_reduce_", "all_reduce_sum", "any_rank",
    "average_flat", "barrier", "choose_backend",
    "distributed_init", "env_group", "gather_rows", "host_major_grid",
    "make_mesh", "mesh_devices", "row_slice", "shard_rows", "spawn",
    "volume_affine_shards",
]
