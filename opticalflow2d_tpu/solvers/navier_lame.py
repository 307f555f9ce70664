"""Spectral (FFT-based) Navier-Lame solver.

The reference relaxes the Navier-Lame system with one sequential SOR sweep
per iteration (``OpticalFlowElastic.cpp:21-55``, ``OpticalFlowFluid.cpp:
7-41``). This module solves the SAME finite-difference system *exactly* in
one shot per iteration via a real 2D FFT — the "FFT-based Navier-Lame
solve" upgrade named in BASELINE.json's north star (the reference's fluid
header even includes fftw3.h but never uses it, SURVEY.md §2.3.10).

Discretization solved (the symmetric/textbook stencil, i.e.
``CompatFlags.elastic_stencil_reference=False`` semantics), with periodic
boundary conditions:

  mu * Lap5(v_c) + (mu+lam) * (d2_c(v_c) + dxy(v_other)) = f_c

whose Fourier symbols are ``L = dxx + dyy``, ``dxx = 2cos(wx)-2``,
``dyy = 2cos(wy)-2`` (3-point second differences) and
``dxy = -sin(wx) sin(wy)`` (4-point mixed difference). Per frequency this
is a symmetric 2x2 system inverted analytically; the k=0 (mean) mode is
null and set to zero.

The whole solve is two rfft2/irfft2 pairs plus elementwise work —
O(N log N), massively faster to convergence than per-sweep SOR for stiff
parameters, at the cost of periodic (not reference) boundary behavior.
Select with ``RegConfig.navier_lame_solver="spectral"``.

``make_dirichlet_navier_lame_solver`` (below) is the reference-BC variant:
it solves the exact interior-point system the reference's SOR converges to
(homogeneous Dirichlet borders) via DST-I matmul transforms plus a short
preconditioned Richardson loop for the non-sine-diagonal mixed term.
Select with ``RegConfig.navier_lame_solver="spectral_dirichlet"``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp


@functools.lru_cache(maxsize=32)
def _inverse_coeffs(nx: int, ny: int, mu: float, lam: float):
    """NumPy [nx, ny//2+1] arrays (i00, i01, i11): the 2x2 inverse of the
    Navier-Lame symbol at each rfft2 frequency."""
    wx = 2.0 * np.pi * np.arange(nx) / nx
    wy = 2.0 * np.pi * np.arange(ny // 2 + 1) / ny
    cx = (2.0 * np.cos(wx) - 2.0)[:, None]
    cy = (2.0 * np.cos(wy) - 2.0)[None, :]
    sx = np.sin(wx)[:, None]
    sy = np.sin(wy)[None, :]

    lap = cx + cy
    a00 = mu * lap + (mu + lam) * cx          # x-equation diagonal
    a11 = mu * lap + (mu + lam) * cy          # y-equation diagonal
    a01 = -(mu + lam) * sx * sy               # mixed term (both equations)

    det = a00 * a11 - a01 * a01
    det_safe = np.where(np.abs(det) > 1e-30, det, 1.0)
    i00 = np.where(np.abs(det) > 1e-30, a11 / det_safe, 0.0)
    i11 = np.where(np.abs(det) > 1e-30, a00 / det_safe, 0.0)
    i01 = np.where(np.abs(det) > 1e-30, -a01 / det_safe, 0.0)
    return i00, i11, i01


def make_spectral_navier_lame_solver(nx: int, ny: int, mu: float, lam: float,
                                     dtype=jnp.float32):
    """Build ``solve(f [2, nx, ny]) -> v`` with
    ``mu*Lap(v) + (mu+lam)*grad(div(v)) = f`` (discrete, periodic BCs)."""
    i00_np, i11_np, i01_np = _inverse_coeffs(nx, ny, mu, lam)
    i00 = jnp.asarray(i00_np, jnp.float32)
    i11 = jnp.asarray(i11_np, jnp.float32)
    i01 = jnp.asarray(i01_np, jnp.float32)

    def solve(f: jnp.ndarray) -> jnp.ndarray:
        fhat = jnp.fft.rfft2(f.astype(jnp.float32))  # [2, nx, ny//2+1]
        vx = i00 * fhat[0] + i01 * fhat[1]
        vy = i01 * fhat[0] + i11 * fhat[1]
        v = jnp.fft.irfft2(jnp.stack([vx, vy]), s=(nx, ny))
        return v.astype(dtype)

    return solve


# ---------------------------------------------------------------------------
# Dirichlet (reference-BC) spectral solver via DST-I
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _dst1_matrix(m: int) -> np.ndarray:
    """DST-I matrix ``S[k, i] = sin(pi (k+1)(i+1) / (m+1))`` (symmetric;
    ``S @ S = (m+1)/2 * I``). Diagonalizes the 1D Dirichlet second
    difference: eigenvalues ``2 cos(pi (k+1)/(m+1)) - 2``."""
    k = np.arange(1, m + 1)
    return np.sin(np.pi * np.outer(k, k) / (m + 1))


def _dirichlet_eigs(m: int) -> np.ndarray:
    k = np.arange(1, m + 1)
    return 2.0 * np.cos(np.pi * k / (m + 1)) - 2.0


def _dxy_interior(v: jnp.ndarray) -> jnp.ndarray:
    """Mixed difference ``0.25 (v_{++} - v_{-+} - v_{+-} + v_{--})`` on the
    interior grid with homogeneous Dirichlet neighbours (zero ring),
    matching the reference's cross term (``OpticalFlowElastic.cpp:34-38``)
    at interior points when the boundary iterate is zero."""
    vp = jnp.pad(v, [(0, 0)] * (v.ndim - 2) + [(1, 1), (1, 1)])
    return 0.25 * (
        vp[..., 2:, 2:] - vp[..., :-2, 2:] - vp[..., 2:, :-2] + vp[..., :-2, :-2]
    )


def apply_navier_lame_operator(
    v: jnp.ndarray, mu: float, lam: float, reference_stencil: bool = True
) -> jnp.ndarray:
    """The reference's discrete Navier-Lame operator ``A v`` on the FULL
    grid at interior points (zeros on the border ring), derived from the
    SOR fixed-point relation of ``OpticalFlowElastic.cpp:21-55``:

      (A v)_c = mu * lap4(v_c) + (mu+lam) * (second_c + cross_c)
                - (6 mu + 2 lam) v_c

    with ``second_c`` the x-direction (reference stencil; the y-component
    asymmetry bug) or per-component-direction (symmetric) second neighbour
    sum, and ``cross_c`` the mixed difference of the other component.
    Boundary values of ``v`` participate as neighbour values.
    """
    vx, vy = v[0], v[1]

    def lap4(a):
        ap = jnp.pad(a, 1)
        return (ap[2:, 1:-1] + ap[:-2, 1:-1] + ap[1:-1, 2:] + ap[1:-1, :-2])

    def secx(a):
        ap = jnp.pad(a, 1)
        return ap[2:, 1:-1] + ap[:-2, 1:-1]

    def secy(a):
        ap = jnp.pad(a, 1)
        return ap[1:-1, 2:] + ap[1:-1, :-2]

    def dxy(a):
        ap = jnp.pad(a, 1)
        return 0.25 * (ap[2:, 2:] - ap[:-2, 2:] - ap[2:, :-2] + ap[:-2, :-2])

    diag = -(6.0 * mu + 2.0 * lam)
    ax = mu * lap4(vx) + (mu + lam) * (secx(vx) + dxy(vy)) + diag * vx
    sec_y = secx(vy) if reference_stencil else secy(vy)
    ay = mu * lap4(vy) + (mu + lam) * (sec_y + dxy(vx)) + diag * vy
    out = jnp.stack([ax, ay])
    # The operator is defined on interior points only.
    mask = jnp.zeros(v.shape[-2:], bool).at[1:-1, 1:-1].set(True)
    return jnp.where(mask, out, 0.0)


def make_dirichlet_navier_lame_solver(
    nx: int, ny: int, mu: float, lam: float, dtype=jnp.float32,
    reference_stencil: bool = True, inner_iters: int = 0,
    precision=None,
):
    """Build ``solve(f [2, nx, ny]) -> v`` for the reference's
    interior-point Navier-Lame system with homogeneous Dirichlet boundaries
    — the true fixed point of the reference's SOR relaxation from a
    zero-initialized iterate (``OpticalFlowElastic.cpp:21-55``: borders are
    never written, so they stay at their initial zeros and act as Dirichlet
    data). Select with ``RegConfig.navier_lame_solver="spectral_dirichlet"``.

    Method: the per-component diagonal part
    ``mu (d2x + d2y) + (mu+lam) d2_{x|y}`` diagonalizes in the DST-I basis
    (a matmul transform), but the
    ``(mu+lam) dxy`` cross coupling maps sine modes onto the opposite
    parity and is NOT sine-diagonal. The full operator IS symmetric (the
    coupling blocks are the self-adjoint mixed difference; the asymmetric
    reference term is a self-adjoint diagonal block), so the solve is
    DST-preconditioned conjugate gradients: each inner iteration is one
    cheap stencil apply plus one exact sine-space diagonal solve
    (8 matmuls). Unlike plain preconditioned Richardson — which
    diverges once ``lam`` dominates ``mu`` (the ``D^{-1}C`` spectral
    radius crosses 1) — CG converges for every valid ``(mu, lam)``.
    ``inner_iters=0`` picks the default: 12 (≈1e-6 relative residual for
    the common ``lam <= mu`` range) or 32 for ``lam > mu``.

    ``reference_stencil`` reproduces the y-equation x-neighbour asymmetry.
    Caveat: that asymmetric stencil (a reference discretization defect) is
    badly conditioned under the sine-diagonal preconditioner once
    ``lam >> mu`` (measured: fine at ``lam = 4 mu``, ~1e-1 residual at
    ``lam = 20 mu``); for such extreme ratios use the symmetric stencil,
    more ``inner_iters``, or the SOR path. The symmetric (textbook)
    operator converges at every tested ratio.
    """
    from jax import lax

    if inner_iters <= 0:
        if reference_stencil and lam > 4 * mu:
            # The documented ill-conditioned corner: CG with the
            # sine-diagonal preconditioner stalls around 1e-1 residual for
            # the asymmetric stencil once lam dominates mu, and this API
            # promises the exact fixed point. Refuse rather than silently
            # return a ~10%-wrong "exact" solve; the caller can opt in with
            # an explicit inner_iters, switch to the symmetric stencil
            # (reference_stencil=False), or use the SOR path.
            raise ValueError(
                f"spectral_dirichlet with the reference (asymmetric) stencil "
                f"is ill-conditioned for lam ({lam}) > 4*mu ({mu}): the "
                f"preconditioned CG does not reach solve accuracy. Use "
                f"reference_stencil=False, the SOR solver, or pass an "
                f"explicit inner_iters to accept partial convergence."
            )
        inner_iters = 12 if lam <= mu else 32
    if precision is None:
        # HIGH: the preconditioner's matmul precision barely affects the
        # converged residual (CG self-corrects against the f32 stencil
        # operator).
        precision = lax.Precision.HIGH
    mx, my = nx - 2, ny - 2
    if mx < 1 or my < 1:
        raise ValueError("grid too small for an interior Dirichlet solve")
    sx = jnp.asarray(_dst1_matrix(mx), jnp.float32)
    sy = jnp.asarray(_dst1_matrix(my), jnp.float32)
    norm = (2.0 / (mx + 1)) * (2.0 / (my + 1))
    lx = _dirichlet_eigs(mx)[:, None]
    ly = _dirichlet_eigs(my)[None, :]
    d0 = mu * (lx + ly) + (mu + lam) * lx
    d1 = mu * (lx + ly) + (mu + lam) * (lx if reference_stencil else ly)
    # Work with the positive-definite negation: M = -D, Apos = -A.
    inv_md = jnp.asarray(np.stack([-1.0 / d0, -1.0 / d1]), jnp.float32)
    diag = -(6.0 * mu + 2.0 * lam)

    def _precond(r):
        """Exact solve of the decoupled diagonal system ``M z = r`` in sine
        space: 4 matmuls per component."""
        t = jnp.einsum("ki,cij->ckj", sx, r, precision=precision)
        t = jnp.einsum("cij,jl->cil", t, sy, precision=precision)
        t = t * inv_md
        t = jnp.einsum("ki,cij->ckj", sx, t, precision=precision)
        t = jnp.einsum("cij,jl->cil", t, sy, precision=precision)
        return t * norm

    def _apply_apos(v):
        """``-A v`` on interior arrays ``[2, mx, my]`` with homogeneous
        Dirichlet neighbours (zero ring)."""
        vp = jnp.pad(v, ((0, 0), (1, 1), (1, 1)))

        def lap4(a):
            return a[2:, 1:-1] + a[:-2, 1:-1] + a[1:-1, 2:] + a[1:-1, :-2]

        def secx(a):
            return a[2:, 1:-1] + a[:-2, 1:-1]

        def secy(a):
            return a[1:-1, 2:] + a[1:-1, :-2]

        def dxy(a):
            return 0.25 * (a[2:, 2:] - a[:-2, 2:] - a[2:, :-2] + a[:-2, :-2])

        ax = mu * lap4(vp[0]) + (mu + lam) * (secx(vp[0]) + dxy(vp[1])) + diag * v[0]
        sec1 = secx(vp[1]) if reference_stencil else secy(vp[1])
        ay = mu * lap4(vp[1]) + (mu + lam) * (sec1 + dxy(vp[0])) + diag * v[1]
        return -jnp.stack([ax, ay])

    def _dot(a, b):
        return jnp.sum(a * b)

    def solve(f: jnp.ndarray) -> jnp.ndarray:
        b = -f[:, 1:-1, 1:-1].astype(jnp.float32)  # Apos x = -f_int
        x = jnp.zeros_like(b)
        r = b
        z = _precond(r)
        p = z
        rz = _dot(r, z)
        for _ in range(inner_iters):
            ap = _apply_apos(p)
            pap = _dot(p, ap)
            alpha = jnp.where(pap != 0, rz / jnp.where(pap != 0, pap, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = _precond(r)
            rz_new = _dot(r, z)
            beta = jnp.where(rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            rz = rz_new
            p = z + beta * p
        out = jnp.zeros((2, nx, ny), jnp.float32).at[:, 1:-1, 1:-1].set(x)
        return out.astype(dtype)

    return solve
