"""Grid-op library: the data-parallel equivalents of the reference's L1 numeric
primitives (``src/gradients.h``, ``src/Field.tpp``, ``src/Image.cpp``,
``src/Motion.cpp``, ``src/Kernel.cpp``)."""

from opticalflow2d_tpu.ops.grid import (
    partial_x,
    partial_y,
    partial_xx,
    partial_yy,
    partial_xy,
    qlaplacian,
    spatial_gradient,
    jacobian_det,
)
from opticalflow2d_tpu.ops.warp import warp2d, compose, expmap
from opticalflow2d_tpu.ops.resample import (
    downsample_image,
    upsample_image,
    downsample_motion,
    upsample_motion,
)
from opticalflow2d_tpu.ops.conv import (
    gaussian_kernel_1d,
    gaussian_kernel_2d,
    box_kernel_2d,
    convolve2d_clip,
    convolve2d_flatwrap,
    convolve2d_kernel,
    gaussian_smooth,
)
from opticalflow2d_tpu.ops.dct import (
    dct2_fftw,
    idct2_fftw,
    dct2_fft,
    idct2_fft,
    curvature_eigenvalues,
)
from opticalflow2d_tpu.ops.boundary import dirichlet_boundary, neumann_boundary
from opticalflow2d_tpu.ops.reduce import (
    motion_norm,
    motion_maxabs,
    normalize_minmax,
    ssd,
)

__all__ = [
    "partial_x", "partial_y", "partial_xx", "partial_yy", "partial_xy",
    "qlaplacian", "spatial_gradient", "jacobian_det",
    "warp2d", "compose", "expmap",
    "downsample_image", "upsample_image", "downsample_motion", "upsample_motion",
    "gaussian_kernel_1d", "gaussian_kernel_2d", "box_kernel_2d",
    "convolve2d_clip", "convolve2d_flatwrap", "convolve2d_kernel",
    "gaussian_smooth",
    "dct2_fftw", "idct2_fftw", "dct2_fft", "idct2_fft", "curvature_eigenvalues",
    "dirichlet_boundary", "neumann_boundary",
    "motion_norm", "motion_maxabs", "normalize_minmax", "ssd",
]
