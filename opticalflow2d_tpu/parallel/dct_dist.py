"""Distributed 2D DCT and the spatially-sharded curvature solver.

The reference's curvature solve is a single-node FFTW DCT pair
(``OpticalFlowCurvature.cpp:144-167``). Sharded over the mesh ``"x"`` axis,
the transform becomes: local matmul along the unsharded y axis, an
``all_to_all`` transpose between devices, local matmul along the (now-local) x axis
— the classic distributed-FFT decomposition (SURVEY.md §2.2).

The full semi-implicit update
``u <- idct2(eig * dct2(u - tau f)) / (4 nx ny)`` needs only TWO
all_to_alls: forward-y, transpose, forward-x, eigenvalue multiply,
inverse-x, transpose back, inverse-y (the eigenvalue multiply happens in the
transposed layout on each device's y-slice).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from opticalflow2d_tpu.ops.dct import _dct_matrix
from opticalflow2d_tpu.parallel.spatial import _curvature_solve_strip
from opticalflow2d_tpu.solvers.base import Derivatives, lssd_force


def _mm(a, b):
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def make_curvature_step_sharded(
    mesh: Mesh, nx: int, ny: int, alpha: float, tau: float, dtype=jnp.float32,
    precision=lax.Precision.HIGH,
):
    """Build the curvature update for ``u [2, nx, ny]`` sharded as
    ``P(None, 'x', None)``. Numerically equivalent to the serial
    ``make_curvature_step`` (same transform matrices, same normalization);
    the DCT body is ``parallel.spatial._curvature_solve_strip``.
    ``precision``: HIGH (default — the precision class of the serial
    ``dct_impl="auto"`` -> ``split_high`` resolution; the sharded body
    keeps the dense per-axis transform) or HIGHEST (the parity-grade
    transform, matching ``dct_impl="matmul"``)."""
    n_x = mesh.shape["x"]
    if nx % n_x != 0 or ny % n_x != 0:
        raise ValueError(
            f"nx ({nx}) and ny ({ny}) must be divisible by the x-axis size {n_x}"
        )

    spec_u = P(None, "x", None)
    spec_im = P("x", None)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_u, spec_u, spec_im),
        out_specs=spec_u,
        check_vma=False,
    )
    def step(u_loc, grad_loc, it_loc):
        d = Derivatives(grad_loc, it_loc)
        f = lssd_force(d, u_loc)
        rhs = u_loc - tau * f  # [2, nxl, ny]
        return _curvature_solve_strip(rhs, nx, ny, alpha, tau, "x", precision)

    return step


def make_dct2_sharded(mesh: Mesh, nx: int, ny: int, inverse: bool = False,
                      dtype=jnp.float32):
    """Standalone distributed 2D DCT (FFTW conventions) on ``[nx, ny]``
    arrays sharded ``P('x', None)``; mainly for testing and composition."""
    n_x = mesh.shape["x"]
    if nx % n_x != 0 or ny % n_x != 0:
        raise ValueError("dims must divide the mesh x-axis size")
    cx = _dct_matrix(nx, 3 if inverse else 2, dtype)
    cy = _dct_matrix(ny, 3 if inverse else 2, dtype)

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("x", None),), out_specs=P("x", None),
        check_vma=False,
    )
    def dct(a_loc):
        t = _mm(a_loc, cy.T)
        t = lax.all_to_all(t, "x", split_axis=1, concat_axis=0, tiled=True)
        t = _mm(cx, t)
        t = lax.all_to_all(t, "x", split_axis=0, concat_axis=1, tiled=True)
        return t

    return dct
