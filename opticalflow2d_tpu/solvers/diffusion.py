"""Horn-Schunck diffusion solver.

One Jacobi-style fixed-point iteration
``u <- qbar(u) - f(qbar(u)) / (alpha^2 + |grad I|^2)`` where ``qbar`` is the
4-neighbour average and the force is evaluated *at* ``qbar(u)`` (reference
``src/regularization/OpticalFlow/OpticalFlowDiffusion.cpp:19-84``).

The step is three elementwise/stencil passes, which XLA fuses into one
loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from opticalflow2d_tpu.ops.grid import qlaplacian
from opticalflow2d_tpu.solvers.base import Derivatives, lssd_force


def diffusion_step(u: jnp.ndarray, d: Derivatives, alpha: float) -> jnp.ndarray:
    """One Horn-Schunck update of the motion estimate ``u [2, nx, ny]``."""
    q = qlaplacian(u)
    f = lssd_force(d, q)
    den = alpha * alpha + d.grad_i[0] ** 2 + d.grad_i[1] ** 2
    return q - f / den[None]
