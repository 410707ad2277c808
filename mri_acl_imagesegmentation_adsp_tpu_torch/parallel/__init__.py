"""Data, coil, depth and pipeline parallelism over ranks of
``torch.distributed`` (the JAX package's ``parallel/``): the collectives
and the rank grids (``mesh.py``), the depth-halo 3-D convolutions and the
depth-sharded 3-D U-Net (``spatial.py``), and GPipe over VarNet's cascades
(``pipeline.py``)."""

from .mesh import (
    DataGroup, ReconGrid, all_reduce_, all_reduce_sum, any_rank,
    average_flat, barrier, choose_backend, distributed_init, env_group,
    gather_rows, grid_average, host_major_grid, make_mesh, make_recon_grid,
    mesh_devices, row_slice, shard_dim, shard_rows, spawn,
    volume_affine_shards)
from .pipeline import gpipe, stack_cascade_params, varnet_apply_pipelined
from .spatial import (
    DepthGrid, conv3d_depth_sharded, conv3d_stack_depth_sharded,
    make_depth_mesh, unet3d_depth_sharded_apply)

__all__ = [
    "DataGroup", "ReconGrid", "all_reduce_", "all_reduce_sum", "any_rank",
    "average_flat", "barrier", "choose_backend",
    "distributed_init", "env_group", "gather_rows", "grid_average",
    "host_major_grid", "make_mesh", "make_recon_grid", "mesh_devices",
    "row_slice", "shard_dim", "shard_rows", "spawn",
    "volume_affine_shards",
    "DepthGrid", "conv3d_depth_sharded", "conv3d_stack_depth_sharded",
    "make_depth_mesh", "unet3d_depth_sharded_apply",
    "gpipe", "stack_cascade_params", "varnet_apply_pipelined",
]
