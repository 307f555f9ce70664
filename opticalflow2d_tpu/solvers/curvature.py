"""Curvature (biharmonic) solver — semi-implicit time marching solved
spectrally in the DCT basis.

Per iteration (reference ``src/regularization/OpticalFlow/
OpticalFlowCurvature.cpp:144-167``):
  1. force ``f`` at the current motion,
  2. rhs = ``u - tau * f``,
  3. forward DCT-II per component,
  4. multiply by precomputed inverse eigenvalues of ``(I + tau*alpha*B^2)``,
  5. inverse DCT-III, normalize by ``4*nx*ny``.

The reference's row-major transposition dance (``:70-124``) disappears: the
matmul DCT acts directly on the array's trailing axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from opticalflow2d_tpu.ops.dct import (
    dct2_fftw,
    idct2_fftw,
    dct2_fft,
    idct2_fft,
    dct2_split,
    idct2_split,
    split_permutation,
    effective_split_depth,
    curvature_eigenvalues,
)
from opticalflow2d_tpu.solvers.base import Derivatives, lssd_force


def make_curvature_step(nx: int, ny: int, alpha: float, tau: float,
                        dtype=jnp.float32, dct_impl: str = "auto"):
    """Build the curvature step for a fixed level shape (the eigenvalue
    matrix is a per-level constant, like the reference's per-level FFTW
    plans).

    ``dct_impl``:
    - "split_high" (= "auto"): split-radix matmul factorization
      (``ops/dct.py::dct2_split``) with its matmuls at
      ``lax.Precision.HIGH``, which lets XLA use reduced-precision
      products (TF32 or a bf16 split) for float32 inputs; about 1/3 the
      multiply-adds of the dense transform;
    - "split" / "split_fast": the split factorization at
      ``Precision.HIGHEST`` (full float32) / ``Precision.DEFAULT``;
    - "matmul": dense transform matmuls at ``Precision.HIGHEST`` —
      bit-closest; the parity/compat setting
      (``RegConfig.resolved_dct_impl`` selects it automatically when
      bug-compat flags are on);
    - "matmul_high" / "matmul_fast": the dense transform at
      ``Precision.HIGH`` / ``Precision.DEFAULT``;
    - "fft": O(N log N) Makhoul factorization on ``jnp.fft``, exact to
      float32 rounding.

    The split path absorbs its coefficient permutation into the
    eigenvalue table (no runtime reorder) and degrades per axis to the
    dense transform when the extent is odd or < 128
    (``effective_split_depth``), so "auto" is safe at every pyramid level.

    Large-extent note: past ``ops.dct._DEVICE_GEN_MIN`` the eigenvalue
    table and transform matrices are generated on device. Call this
    factory UNDER a jit trace (the registration driver does) so they stay
    in-program ops; built eagerly, the table becomes a concrete [nx, ny]
    device array that a later jit captures as a program constant
    (256 MB at 8192^2).
    """
    solve = make_curvature_solve(nx, ny, alpha, tau, dtype, dct_impl)

    def step(u: jnp.ndarray, d: Derivatives) -> jnp.ndarray:
        f = lssd_force(d, u)
        return solve(u - tau * f)

    return step


def make_curvature_solve(nx: int, ny: int, alpha: float, tau: float,
                         dtype=jnp.float32, dct_impl: str = "auto"):
    """The spectral half of the curvature step: ``rhs -> idct(dct(rhs) *
    eig) / (4 nx ny)`` (reference OpticalFlowCurvature.cpp:144-167 minus
    the force). Split out of ``make_curvature_step`` so the huge-grid
    host-stepped driver can run force/rhs and the spectral solve as two
    separate programs, so the combined program's intermediates (rhs +
    spectrum + eigenvalue table + transform temporaries) never sit on top
    of the persistent level state (engine.registration._jitted_stepped)."""
    scale = 1.0 / (4.0 * nx * ny)
    if dct_impl == "auto":
        dct_impl = "split_high"
    from jax import lax

    _PRECS = {"": lax.Precision.HIGHEST, "_high": lax.Precision.HIGH,
              "_fast": lax.Precision.DEFAULT}
    if dct_impl.startswith("split"):
        prec = _PRECS[dct_impl[len("split"):]]
        px = split_permutation(nx, effective_split_depth(nx))
        py = split_permutation(ny, effective_split_depth(ny))
        # The permutation folds into the (separable) eigenvalue table's 1D
        # cosine factors — no runtime reorder, and no permuted-grid gather
        # when the table is device-assembled at large extents.
        eig = curvature_eigenvalues(nx, ny, alpha, tau, dtype,
                                    perm_x=px, perm_y=py)
        fwd = lambda a: dct2_split(a, precision=prec)
        inv = lambda a: idct2_split(a, precision=prec)
    else:
        eig = curvature_eigenvalues(nx, ny, alpha, tau, dtype)
        if dct_impl == "fft":
            fwd, inv = dct2_fft, idct2_fft
        elif dct_impl in ("matmul_fast", "matmul_high"):
            prec = (lax.Precision.DEFAULT if dct_impl == "matmul_fast"
                    else lax.Precision.HIGH)
            fwd = lambda a: dct2_fftw(a, precision=prec)
            inv = lambda a: idct2_fftw(a, precision=prec)
        else:
            fwd, inv = dct2_fftw, idct2_fftw

    def solve(rhs: jnp.ndarray) -> jnp.ndarray:
        spec = fwd(rhs) * eig[None]
        return inv(spec) * scale

    return solve


def make_curvature_solve_phases(alpha: float, tau: float,
                                dtype=jnp.float32,
                                dct_impl: str = "auto"):
    """The spectral solve as a tuple of SHAPE-AGNOSTIC single-array
    functions applied in order (``x = ph(x)``), for the huge-grid
    host-stepped driver: each phase alone peaks at ~2-3 planes, where the
    one-component solve's per-axis transposes + recursion temporaries +
    eigenvalue table would share one program. Composition equals
    ``make_curvature_solve`` up to program-boundary fusion ulps — the
    same per-axis matmuls on the same stored values. Shapes are read at
    trace time, so each phase jits per shape and the device-generated
    tables stay in-program (the no-giant-constants rule, ops/dct.py).

    Split impls return 5 phases (fwd-y | fwd-x | eig | inv-y | inv-x +
    scale); non-split impls (compat/parity grade, never used at huge
    extents) return the whole solve as one phase."""
    if dct_impl == "auto":
        dct_impl = "split_high"
    if not dct_impl.startswith("split"):
        def solve_whole(a):
            nc, nx, ny = a.shape
            return make_curvature_solve(nx, ny, alpha, tau, dtype,
                                        dct_impl)(a)

        return (solve_whole,)

    from jax import lax

    _PRECS = {"": lax.Precision.HIGHEST, "_high": lax.Precision.HIGH,
              "_fast": lax.Precision.DEFAULT}
    prec = _PRECS[dct_impl[len("split"):]]
    from opticalflow2d_tpu.ops.dct import _split_axis

    def fwd_y(a):
        return _split_axis(a, -1, effective_split_depth(a.shape[-1]),
                           prec, False)

    def fwd_x(a):
        return _split_axis(a, -2, effective_split_depth(a.shape[-2]),
                           prec, False)

    def eig_mul(a):
        nx, ny = a.shape[-2], a.shape[-1]
        px = split_permutation(nx, effective_split_depth(nx))
        py = split_permutation(ny, effective_split_depth(ny))
        eig = curvature_eigenvalues(nx, ny, alpha, tau, dtype,
                                    perm_x=px, perm_y=py)
        return a * eig[None]

    def inv_y(a):
        return _split_axis(a, -1, effective_split_depth(a.shape[-1]),
                           prec, True)

    def inv_x_scale(a):
        nx, ny = a.shape[-2], a.shape[-1]
        out = _split_axis(a, -2, effective_split_depth(nx), prec, True)
        return out * (1.0 / (4.0 * nx * ny))

    return (fwd_y, fwd_x, eig_mul, inv_y, inv_x_scale)
