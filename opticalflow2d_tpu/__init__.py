"""tpuflow2d — 2D deformable image registration in JAX.

A JAX/XLA framework with the full capabilities of the C++ MEX
library tjwdraper/OpticalFlow2d (see SURVEY.md): six PDE/demons solvers inside a
multi-resolution pyramid, estimating a dense motion field u with T(x+u) ~= R(x).

Conventions
-----------
- Images are ``f32[nx, ny]`` arrays. Axis 0 is the reference's "x" dimension
  (the contiguous, stride-1 dimension of the column-major MATLAB layout,
  reference ``src/Field.tpp:13``), axis 1 is "y".
- Motion fields are ``f32[2, nx, ny]``: channel 0 = displacement along axis 0
  ("x"), channel 1 = displacement along axis 1 ("y").
- All ops are pure functions; batching is via ``jax.vmap`` and sharding via
  ``jax.sharding`` / ``shard_map`` (see ``opticalflow2d_tpu.parallel``).
"""

from opticalflow2d_tpu.config import (
    Method,
    MotionAccumulation,
    CompatFlags,
    RegConfig,
)
from opticalflow2d_tpu.engine.registration import (
    register,
    register_phased,
    RegistrationResult,
)
from opticalflow2d_tpu.engine.session import OpticalFlow2d

__version__ = "0.1.0"

__all__ = [
    "Method",
    "MotionAccumulation",
    "CompatFlags",
    "RegConfig",
    "register",
    "register_phased",
    "RegistrationResult",
    "OpticalFlow2d",
]
