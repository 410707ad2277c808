"""Data and coil parallelism over ranks of ``torch.distributed`` (the JAX
package's ``parallel/mesh.py``); its point-to-point parts
(``parallel/pipeline.py``, ``parallel/spatial.py``) are not ported yet."""

from .mesh import (
    DataGroup, ReconGrid, all_reduce_, all_reduce_sum, any_rank,
    average_flat, barrier, choose_backend, distributed_init, env_group,
    gather_rows, grid_average, host_major_grid, make_mesh, make_recon_grid,
    mesh_devices, row_slice, shard_dim, shard_rows, spawn,
    volume_affine_shards)

__all__ = [
    "DataGroup", "ReconGrid", "all_reduce_", "all_reduce_sum", "any_rank",
    "average_flat", "barrier", "choose_backend",
    "distributed_init", "env_group", "gather_rows", "grid_average",
    "host_major_grid", "make_mesh", "make_recon_grid", "mesh_devices",
    "row_slice", "shard_dim", "shard_rows", "spawn",
    "volume_affine_shards",
]
