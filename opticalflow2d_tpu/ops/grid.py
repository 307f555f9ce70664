"""Finite-difference stencils.

Semantics match the reference's inline stencils exactly (one-sided borders,
zeroed borders for the mixed derivative and quasi-laplacian) — reference
``src/gradients.h:9-80``. All functions operate on the trailing two axes
``[..., nx, ny]`` (axis -2 = "x", axis -1 = "y") so they broadcast over any
leading batch/component axes and vmap cleanly. Everything is shift-and-add on
static shapes: XLA fuses these into single elementwise passes.
"""

from __future__ import annotations

import jax.numpy as jnp


def partial_x(f: jnp.ndarray) -> jnp.ndarray:
    """d/dx: central difference, one-sided at the x borders
    (reference ``src/gradients.h:9-19``)."""
    interior = (f[..., 2:, :] - f[..., :-2, :]) * 0.5
    first = f[..., 1:2, :] - f[..., 0:1, :]
    last = f[..., -1:, :] - f[..., -2:-1, :]
    return jnp.concatenate([first, interior, last], axis=-2)


def partial_y(f: jnp.ndarray) -> jnp.ndarray:
    """d/dy: central difference, one-sided at the y borders
    (reference ``src/gradients.h:21-32``)."""
    interior = (f[..., :, 2:] - f[..., :, :-2]) * 0.5
    first = f[..., :, 1:2] - f[..., :, 0:1]
    last = f[..., :, -1:] - f[..., :, -2:-1]
    return jnp.concatenate([first, interior, last], axis=-1)


def partial_xx(f: jnp.ndarray) -> jnp.ndarray:
    """d2/dx2: 3-point interior, 4-point one-sided border stencils
    (reference ``src/gradients.h:36-46``)."""
    interior = f[..., 2:, :] - 2.0 * f[..., 1:-1, :] + f[..., :-2, :]
    first = (
        2.0 * f[..., 0:1, :]
        - 5.0 * f[..., 1:2, :]
        + 4.0 * f[..., 2:3, :]
        - f[..., 3:4, :]
    )
    last = (
        -f[..., -4:-3, :]
        + 4.0 * f[..., -3:-2, :]
        - 5.0 * f[..., -2:-1, :]
        + 2.0 * f[..., -1:, :]
    )
    return jnp.concatenate([first, interior, last], axis=-2)


def partial_yy(f: jnp.ndarray) -> jnp.ndarray:
    """d2/dy2 (reference ``src/gradients.h:48-59``)."""
    interior = f[..., :, 2:] - 2.0 * f[..., :, 1:-1] + f[..., :, :-2]
    first = (
        2.0 * f[..., :, 0:1]
        - 5.0 * f[..., :, 1:2]
        + 4.0 * f[..., :, 2:3]
        - f[..., :, 3:4]
    )
    last = (
        -f[..., :, -4:-3]
        + 4.0 * f[..., :, -3:-2]
        - 5.0 * f[..., :, -2:-1]
        + 2.0 * f[..., :, -1:]
    )
    return jnp.concatenate([first, interior, last], axis=-1)


def partial_xy(f: jnp.ndarray) -> jnp.ndarray:
    """Mixed d2/dxdy: 4-point interior stencil, zero on every border
    (reference ``src/gradients.h:62-69``)."""
    out = jnp.zeros_like(f)
    interior = (
        f[..., 2:, 2:] - f[..., 2:, :-2] - f[..., :-2, 2:] + f[..., :-2, :-2]
    ) * 0.25
    return out.at[..., 1:-1, 1:-1].set(interior)


def qlaplacian(f: jnp.ndarray) -> jnp.ndarray:
    """Quasi-laplacian: 4-neighbour average in the interior, zero on the
    borders (reference ``src/gradients.h:72-80``)."""
    out = jnp.zeros_like(f)
    interior = (
        f[..., :-2, 1:-1] + f[..., 2:, 1:-1] + f[..., 1:-1, :-2] + f[..., 1:-1, 2:]
    ) * 0.25
    return out.at[..., 1:-1, 1:-1].set(interior)


def spatial_gradient(image: jnp.ndarray) -> jnp.ndarray:
    """Stack (d/dx, d/dy) of an image into a motion-shaped ``[2, nx, ny]``
    array (reference ``src/regularization/IterativeSolver.cpp:22-44``)."""
    return jnp.stack([partial_x(image), partial_y(image)], axis=-3)


def jacobian_det(u: jnp.ndarray) -> jnp.ndarray:
    """Jacobian determinant of the deformation x + u:
    ``det(I + grad u) = (1+du_x/dx)(1+du_y/dy) - (du_y/dx)(du_x/dy)``
    (reference ``src/Image.cpp:189-218``; the reference computes
    ``(1+dudx.x)(1+dudy.y) - dudx.y*dudy.x`` with dudx = partial_x of the
    vector field)."""
    ux, uy = u[..., 0, :, :], u[..., 1, :, :]
    duxdx = partial_x(ux)
    duydx = partial_x(uy)
    duxdy = partial_y(ux)
    duydy = partial_y(uy)
    return (1.0 + duxdx) * (1.0 + duydy) - duydx * duxdy
