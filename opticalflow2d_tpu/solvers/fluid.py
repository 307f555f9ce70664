"""Viscous fluid solver (Christensen): SOR solve for the *velocity* field,
material-derivative increment, adaptive explicit-Euler timestep.

Per iteration (reference ``src/regularization/OpticalFlow/
OpticalFlowFluid.cpp:123-140``):
  1. force at the current motion,
  2. one SOR sweep of the Navier-Lame system on the persistent velocity
     field (warm-started across iterations/refinements, like the reference's
     per-level member field),
  3. increment ``R = v - (du/dx) v_x - (du/dy) v_y`` (``:60-90``),
  4. ``dt = dumax / maxabs(R)`` (``:92-95``); if ``dt >= timestep_skip`` skip
     the integration (``:135-137``), else ``u += R * dt``.

``maxabs_bug=True`` reproduces the reference's ``Motion::maxabs`` defect,
which changes the timestep sequence (SURVEY.md §2.3.1).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from opticalflow2d_tpu.ops.grid import partial_x, partial_y
from opticalflow2d_tpu.ops.reduce import motion_maxabs
from opticalflow2d_tpu.solvers.base import Derivatives, lssd_force
from opticalflow2d_tpu.solvers.elastic import sor_sweep


def make_fluid_step(
    mu: float,
    lam: float,
    omega: float,
    dumax: float = 0.65,
    timestep_skip: float = 65.0,
    maxabs_bug: bool = False,
    reference_stencil: bool = True,
    sor_ordering: str = "redblack",
    spectral_solve=None,
):
    """Build the fluid step. State is ``(u, velocity)``; returns the updated
    pair plus the timestep for diagnostics.

    With ``spectral_solve`` (a ``make_spectral_navier_lame_solver`` result),
    the velocity is the exact Navier-Lame solution of the current force each
    iteration instead of one warm-started SOR sweep.
    """

    def step(
        u: jnp.ndarray, velocity: jnp.ndarray, d: Derivatives
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        f = lssd_force(d, u)
        if spectral_solve is not None:
            velocity = spectral_solve(f)
        else:
            velocity = sor_sweep(
                velocity, f, mu, lam, omega, reference_stencil, sor_ordering
            )

        # Material derivative:
        # R_c = v_c - (d u_c/dx) v_x - (d u_c/dy) v_y
        dudx = partial_x(u)  # [2, nx, ny]: per-component d/dx
        dudy = partial_y(u)
        r = velocity - dudx * velocity[0:1] - dudy * velocity[1:2]

        m = motion_maxabs(r, bug=maxabs_bug)
        # m == 0 -> dt = inf -> skip branch, matching C++ float division.
        dt = dumax / m
        do_step = dt < timestep_skip
        u = jnp.where(do_step, u + r * jnp.where(do_step, dt, 0.0), u)
        return u, velocity, dt

    return step
