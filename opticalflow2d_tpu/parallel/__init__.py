"""Scaling layer: device meshes, batched (DP) registration, spatially-sharded
stencils with halo exchange, and the distributed DCT."""

from opticalflow2d_tpu.parallel.mesh import make_mesh
from opticalflow2d_tpu.parallel.batch import register_batch
from opticalflow2d_tpu.parallel.spatial import (
    register_sharded,
    make_diffusion_sweeps_sharded,
    make_sor_sweeps_sharded,
    make_gaussian_smooth_sharded,
    make_warp2d_sharded,
    make_demons_step_sharded,
    make_demons_level_sharded,
    make_fluid_level_sharded,
    make_variational_level_sharded,
    make_register_demons_sp,
    make_register_sp,
)
from opticalflow2d_tpu.parallel.dct_dist import (
    make_dct2_sharded,
    make_curvature_step_sharded,
)
from opticalflow2d_tpu.parallel.multihost import (
    initialize_multihost,
    shard_batch_for_host,
)

__all__ = [
    "make_mesh", "register_batch", "register_sharded",
    "make_diffusion_sweeps_sharded", "make_sor_sweeps_sharded",
    "make_gaussian_smooth_sharded", "make_warp2d_sharded",
    "make_demons_step_sharded", "make_demons_level_sharded",
    "make_fluid_level_sharded", "make_variational_level_sharded",
    "make_register_demons_sp", "make_register_sp",
    "make_dct2_sharded", "make_curvature_step_sharded",
    "initialize_multihost", "shard_batch_for_host",
]
