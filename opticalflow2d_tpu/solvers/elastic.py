"""Elastic (Navier-Lame) solver via red-black SOR.

The reference performs one in-place lexicographic Gauss-Seidel/SOR sweep over
interior points per iteration (``src/regularization/OpticalFlow/
OpticalFlowElastic.cpp:21-55``). A strictly sequential sweep does not vectorize,
so this implementation uses *red-black* ordering: two
masked, fully-vectorized half-sweeps (checkerboard colors) per sweep. Both
orderings are SOR on the same linear system and converge to the same fixed
point; iterate-for-iterate values differ (SURVEY.md §7 "hard parts" #1), so
parity with the C++ oracle is asserted at convergence.

``reference_stencil=True`` (default) reproduces the reference's discretization
exactly, including the asymmetric ``(mu+lambda)`` term in the y-component that
reads x-direction neighbours (``OpticalFlowElastic.cpp:46-49``, SURVEY.md
§2.3.5). ``False`` selects the textbook symmetric Navier-Lame operator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opticalflow2d_tpu.solvers.base import Derivatives, lssd_force


def _sh(f: jnp.ndarray, di: int, dj: int) -> jnp.ndarray:
    """Value at (i+di, j+dj) over the trailing two axes, zero outside.
    Only interior results are consumed. Pad by ``max(-d, 0)`` low /
    ``max(d, 0)`` high so ``fp[k] = f[k - max(-d, 0)]`` and
    ``out[i] = f[i + d] = fp[i + d + max(-d, 0)]``."""
    nx, ny = f.shape[-2], f.shape[-1]
    lo_x, lo_y = max(-di, 0), max(-dj, 0)
    pad = [(0, 0)] * (f.ndim - 2) + [(lo_x, max(di, 0)), (lo_y, max(dj, 0))]
    fp = jnp.pad(f, pad)
    return fp[..., di + lo_x : di + lo_x + nx, dj + lo_y : dj + lo_y + ny]


def _gs_candidate(
    x: jnp.ndarray,
    b: jnp.ndarray,
    mu: float,
    lam: float,
    omega: float,
    reference_stencil: bool,
) -> jnp.ndarray:
    """The SOR update value at every pixel, computed from the current field
    (validity only at interior pixels; callers mask)."""
    inv_diag = omega / (-6.0 * mu - 2.0 * lam)

    def comp(c: int) -> jnp.ndarray:
        o = 1 - c
        xc = x[c]
        xo = x[o]
        xp = _sh(xc, 1, 0)
        xm = _sh(xc, -1, 0)
        yp = _sh(xc, 0, 1)
        ym = _sh(xc, 0, -1)
        lap4 = xp + xm + yp + ym
        cross = 0.25 * (
            _sh(xo, 1, 1) - _sh(xo, -1, 1) - _sh(xo, 1, -1) + _sh(xo, -1, -1)
        )
        if c == 0 or reference_stencil:
            # x-component always uses x-direction neighbours; the reference's
            # y-component does too (the asymmetry bug).
            second = xp + xm
        else:
            second = yp + ym
        num = b[c] - mu * lap4 - (mu + lam) * (second + cross)
        return (1.0 - omega) * xc + inv_diag * num

    return jnp.stack([comp(0), comp(1)], axis=0)


@functools.lru_cache(maxsize=64)
def _color_masks(nx: int, ny: int):
    """NumPy masks (cached); converted to device constants at each use site so
    no traced array ever leaks across jit traces."""
    import numpy as np

    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    interior = (i >= 1) & (i <= nx - 2) & (j >= 1) & (j <= ny - 2)
    red = ((i + j) % 2 == 0) & interior
    black = ((i + j) % 2 == 1) & interior
    return red, black


def sor_sweep(
    x: jnp.ndarray,
    b: jnp.ndarray,
    mu: float,
    lam: float,
    omega: float,
    reference_stencil: bool = True,
    ordering: str = "redblack",
) -> jnp.ndarray:
    """One SOR sweep of the Navier-Lame system ``A x = b`` on interior
    points; borders untouched.

    ``ordering="redblack"`` (default, data-parallel): two masked vectorized
    half-sweeps. ``ordering="lexicographic"``: *exact* reproduction of the
    reference's sequential in-place sweep via an anti-diagonal wavefront —
    for the lexicographic order (i outer, j inner) the update at (i, j) reads
    already-updated values at (i-1, j-1), (i-1, j), (i-1, j+1), (i, j-1) and
    old values elsewhere, so the diagonals ``d = 2i + j`` form a valid
    dependency frontier; scanning d and masking to the diagonal gives the
    identical floating-point sequence. O(2*nx+ny) scan steps of full-grid
    work — used for bit-parity tests and compat runs, not production.
    """
    if ordering == "redblack":
        nx, ny = x.shape[-2], x.shape[-1]
        red_np, black_np = _color_masks(nx, ny)
        red = jnp.asarray(red_np)
        black = jnp.asarray(black_np)
        cand = _gs_candidate(x, b, mu, lam, omega, reference_stencil)
        x = jnp.where(red[None], cand, x)
        cand = _gs_candidate(x, b, mu, lam, omega, reference_stencil)
        x = jnp.where(black[None], cand, x)
        return x
    if ordering != "lexicographic":
        raise ValueError(f"unknown SOR ordering {ordering!r}")

    nx, ny = x.shape[-2], x.shape[-1]
    ii = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 1)
    interior = (ii >= 1) & (ii <= nx - 2) & (jj >= 1) & (jj <= ny - 2)
    diag = 2 * ii + jj

    def step(xc, d):
        cand = _gs_candidate(xc, b, mu, lam, omega, reference_stencil)
        mask = interior & (diag == d)
        return jnp.where(mask[None], cand, xc), None

    # Interior diagonals run from 2*1+1 to 2*(nx-2)+(ny-2).
    ds = jnp.arange(3, 2 * (nx - 2) + (ny - 2) + 1, dtype=jnp.int32)
    x, _ = jax.lax.scan(step, x, ds)
    return x


def elastic_step(
    u: jnp.ndarray,
    d: Derivatives,
    mu: float,
    lam: float,
    omega: float,
    reference_stencil: bool = True,
    ordering: str = "redblack",
) -> jnp.ndarray:
    """One elastic iteration: force at current motion, then one SOR sweep on
    the motion itself (reference ``OpticalFlowElastic.cpp:13-19``)."""
    f = lssd_force(d, u)
    return sor_sweep(u, f, mu, lam, omega, reference_stencil, ordering)
