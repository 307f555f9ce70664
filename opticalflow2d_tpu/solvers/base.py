"""Shared solver primitives: image derivatives and force fields.

- ``derivatives``: gradient of the (warped) moving image + temporal difference
  (reference ``src/regularization/IterativeSolver.cpp:22-56``).
- ``lssd_force``: the linearized-SSD force shared by all variational solvers,
  ``f = grad(I) * (It + u . grad(I))``
  (reference ``src/regularization/OpticalFlow/OpticalFlow.cpp:15-39``).
- ``demons_force``: Thirion's demons correspondence force
  (reference ``src/regularization/Demons/Demons.cpp:34-64``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from opticalflow2d_tpu.ops.grid import spatial_gradient


class Derivatives(NamedTuple):
    """Per-level image derivatives. ``grad_i`` is ``[2, nx, ny]`` (gradient of
    the warped moving image), ``it`` is ``[nx, ny]`` (Imov - Iref)."""

    grad_i: jnp.ndarray
    it: jnp.ndarray


def derivatives(iref: jnp.ndarray, imov: jnp.ndarray) -> Derivatives:
    """grad(Imov) via central differences and It = Imov - Iref
    (reference ``IterativeSolver.cpp:22-56``; note the gradient is taken on
    the *moving* (warped) image)."""
    return Derivatives(grad_i=spatial_gradient(imov), it=imov - iref)


def stack_derivs(grad_i: jnp.ndarray, it_img: jnp.ndarray) -> jnp.ndarray:
    """Pack (gx, gy, It) into one ``[3, nx, ny]`` array — the layout the
    host-stepped fluid driver carries between its programs, so no
    iteration re-stacks it."""
    return jnp.concatenate([grad_i, it_img[None]], axis=0)


def lssd_force(d: Derivatives, u: jnp.ndarray) -> jnp.ndarray:
    """Linearized-SSD force ``f = grad(I) * (It + ux*dIx + uy*dIy)``,
    shape ``[2, nx, ny]`` (reference ``OpticalFlow.cpp:15-39``)."""
    inner = d.it + u[0] * d.grad_i[0] + u[1] * d.grad_i[1]
    return d.grad_i * inner[None]


def demons_force(d: Derivatives, sigma_i: float, sigma_x: float) -> jnp.ndarray:
    """Demons correspondence update
    ``c = -grad(I) * It / (|grad(I)|^2 + It^2 * sigma_i^2 / sigma_x^2)``
    (reference ``Demons.cpp:34-64``).

    The reference divides unguarded — 0/0 at perfectly flat, perfectly matched
    pixels yields NaN in C++ (latent UB); we define the force as 0 there,
    which is the correct limit (no information, no update).
    """
    den = (
        d.grad_i[0] ** 2
        + d.grad_i[1] ** 2
        + d.it**2 * (sigma_i * sigma_i) / (sigma_x * sigma_x)
    )
    num = d.grad_i * d.it[None] * -1.0
    return jnp.where(den[None] > 0, num / jnp.where(den[None] > 0, den[None], 1.0), 0.0)
