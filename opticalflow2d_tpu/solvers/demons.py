"""Thirion and diffeomorphic demons solvers.

Per iteration (reference ``src/regularization/Demons/DemonsThirions.cpp:18-42``
and ``DemonsDiffeomorphic.cpp:15-35``):
  1. warp the (already pyramid-level, already refinement-warped) moving image
     by the current motion estimate,
  2. recompute image derivatives on the warped image,
  3. demons correspondence force,
  4. Gaussian-smooth the correspondence ("fluid" smoothing),
  5. Thirion: compose or add the correspondence into the motion
     (per ``MotionAccumulation``); diffeomorphic: exponentiate the smoothed
     correspondence (scaling-and-squaring) then always compose,
  6. Gaussian-smooth the motion ("diffusion" smoothing).
"""

from __future__ import annotations

import jax.numpy as jnp

from opticalflow2d_tpu.config import MotionAccumulation
from opticalflow2d_tpu.ops.conv import gaussian_smooth
from opticalflow2d_tpu.ops.warp import warp2d, compose, expmap
from opticalflow2d_tpu.solvers.base import derivatives, demons_force


def logger_sums(u_new: jnp.ndarray, u_prev: jnp.ndarray) -> jnp.ndarray:
    """Logger partial pair ``[sum |u_new - u_prev|, sum |u_prev|]`` (pixel
    magnitudes; reference src/Logger.cpp:30-60 tracks their ratio /N /N).
    Full-array order, so ``sums/N`` equals ``ops.reduce.motion_norm``
    bitwise — the driver's error from these matches ``_rel_step_error``.
    """
    diff = u_new - u_prev
    dsum = jnp.sum(jnp.sqrt(diff[0] ** 2 + diff[1] ** 2))
    psum = jnp.sum(jnp.sqrt(u_prev[0] ** 2 + u_prev[1] ** 2))
    return jnp.stack([dsum, psum])


def make_demons_step(
    sigma_i: float,
    sigma_x: float,
    sigma_diffusion: float,
    sigma_fluid: float,
    kernelwidth: int,
    diffeomorphic: bool,
    accumulation: MotionAccumulation = MotionAccumulation.COMPOSITION,
    conv_flatwrap: bool = False,
    maxabs_bug: bool = False,
    warp_halo: int = 0,
    with_errors: bool = False,
):
    """Build the demons step ``(u, iref, imov) -> u`` (or ``-> (u, sums)``
    with ``with_errors`` — ``sums = logger_sums(u_new, u)``). ``imov`` is
    the refinement-level warped moving image (the reference's ``Iaux``)."""

    def step(u: jnp.ndarray, iref: jnp.ndarray, imov: jnp.ndarray):
        u_prev = u
        iwar = warp2d(imov, u, warp_halo)
        d = derivatives(iref, iwar)
        c = demons_force(d, sigma_i, sigma_x)
        c = gaussian_smooth(c, sigma_fluid, kernelwidth, flatwrap=conv_flatwrap)
        if diffeomorphic:
            c = expmap(c, maxabs_bug=maxabs_bug, halo=warp_halo)
            u = compose(u, c, warp_halo)
        elif accumulation == MotionAccumulation.COMPOSITION:
            u = compose(u, c, warp_halo)
        else:
            u = u + c
        u = gaussian_smooth(u, sigma_diffusion, kernelwidth, flatwrap=conv_flatwrap)
        return (u, logger_sums(u, u_prev)) if with_errors else u

    return step
