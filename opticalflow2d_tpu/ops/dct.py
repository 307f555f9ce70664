"""Matmul-based 2D DCT-II/DCT-III in FFTW's r2r conventions, plus the
curvature-operator eigenvalues.

The reference runs FFTW REDFT10 (forward) / REDFT01 (inverse) plans per
component and divides by ``4 * N`` afterwards (``src/regularization/
OpticalFlow/OpticalFlowCurvature.cpp:52-55, 99-167``). Here the transform is
expressed as two dense matmuls ``C2x @ A @ C2y^T`` (or their split-radix
factorization), replacing FFTW's CPU butterflies; ``dct2_fft`` is the
FFT-based alternative.

FFTW conventions implemented (unnormalized, matching fftw3 docs):
- REDFT10: ``Y[k] = 2 * sum_n X[n] cos(pi (n+1/2) k / N)``
- REDFT01: ``Y[k] = X[0] + 2 * sum_{n>=1} X[n] cos(pi n (k+1/2) / N)``
so REDFT01(REDFT10(x)) = 2N * x per axis, and the reference's ``/(4*size)``
normalization is applied by the caller (curvature solver).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax


@functools.lru_cache(maxsize=64)
def _dct2_matrix(n: int) -> np.ndarray:
    """REDFT10 (DCT-II) matrix, float64 then cast at use site."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * (j + 0.5) * k / n)


@functools.lru_cache(maxsize=64)
def _dct3_matrix(n: int) -> np.ndarray:
    """REDFT01 (DCT-III) matrix."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = 2.0 * np.cos(np.pi * j * (k + 0.5) / n)
    m[:, 0] = 1.0
    return m


def _mm(a, b, precision=lax.Precision.HIGHEST):
    return jnp.matmul(a, b, precision=precision)


# Transform matrices with extent >= this are generated ON DEVICE inside the
# traced program (exact integer phase + one f32 cos) instead of being
# embedded as host constants. An n x n f32 constant is n^2*4 bytes — 256 MB
# at 8192 — and jit embeds closure constants in the compiled program. Device
# generation costs one fused iota+cos kernel per level
# (hoisted out of the iteration while_loop as a loop invariant) and differs
# from the float64 host tables by <= 2 ulp per entry.
_DEVICE_GEN_MIN = 2048
# The integer phase numerator (2j+1)(2k+1) must stay inside int32.
_DEVICE_GEN_MAX = 16384


def _dct_matrix_dev(n: int, kind: int, dtype) -> jnp.ndarray:
    """DCT-II/III/IV matrix built on device: the cos argument is reduced
    exactly in int32 (numerator mod the cosine's integer period) before the
    single f32 multiply+cos, so there is no large-argument phase error.
    kinds: 2 -> REDFT10 rows ``2 cos(pi (j+1/2) k / n)``; 3 -> REDFT01
    (column 0 fixed to 1); 4 -> DCT-IV ``2 cos(pi (j+1/2)(k+1/2) / n)``."""
    if n > _DEVICE_GEN_MAX:  # pragma: no cover - no such grid target
        raise ValueError(f"device DCT matrix gen needs n <= {_DEVICE_GEN_MAX}")
    k = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    j = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    if kind == 2:
        num, period = (2 * j + 1) * k, 4 * n
    elif kind == 3:
        num, period = j * (2 * k + 1), 4 * n
    else:
        num, period = (2 * j + 1) * (2 * k + 1), 8 * n
    phase = (num % period).astype(dtype) * jnp.asarray(
        2.0 * np.pi / period, dtype
    )
    m = 2.0 * jnp.cos(phase)
    if kind == 3:
        m = jnp.where(j == 0, jnp.asarray(1.0, dtype), m)
    return m.astype(dtype)


_HOST_TABLES = {2: _dct2_matrix, 3: _dct3_matrix}


def _dct_matrix(n: int, kind: int, dtype) -> jnp.ndarray:
    """Transform matrix as a traced array: float64 host table below the
    device-generation threshold (bit-stable parity path), device-generated
    at large extents (no giant compile-request constants)."""
    if n >= _DEVICE_GEN_MIN:
        return _dct_matrix_dev(n, kind, dtype)
    return jnp.asarray(_HOST_TABLES.get(kind, _dct4_matrix)(n), dtype)


def dct2_fftw(a: jnp.ndarray, precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """2D DCT-II (FFTW REDFT10 x REDFT10) over the trailing two axes."""
    nx, ny = a.shape[-2], a.shape[-1]
    cx = _dct_matrix(nx, 2, a.dtype)
    cy = _dct_matrix(ny, 2, a.dtype)
    return _mm(_mm(cx, a, precision), cy.T, precision)


def idct2_fftw(a: jnp.ndarray, precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """2D DCT-III (FFTW REDFT01 x REDFT01) over the trailing two axes.
    ``idct2_fftw(dct2_fftw(x)) == 4 * nx * ny * x``."""
    nx, ny = a.shape[-2], a.shape[-1]
    cx = _dct_matrix(nx, 3, a.dtype)
    cy = _dct_matrix(ny, 3, a.dtype)
    return _mm(_mm(cx, a, precision), cy.T, precision)


def _dct1d_fft(x: jnp.ndarray, axis: int, inverse: bool = False) -> jnp.ndarray:
    """1D REDFT10/REDFT01 along ``axis`` via the Makhoul FFT factorization —
    O(N log N) replacement for the matmul path at large N. Matches the
    matrix transforms to float rounding."""
    n = x.shape[axis]
    x = jnp.moveaxis(x, axis, -1)
    k = jnp.arange(n)
    if not inverse:
        # Even-odd reorder, complex FFT, half-sample phase twiddle.
        v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]], axis=-1)
        vf = jnp.fft.fft(v)
        out = 2.0 * jnp.real(jnp.exp(-1j * jnp.pi * k / (2 * n)) * vf)
    else:
        xe = jnp.concatenate([x, jnp.zeros_like(x[..., :1])], axis=-1)
        u_spec = (xe[..., :n] - 1j * xe[..., n - k]) * jnp.exp(
            1j * jnp.pi * k / (2 * n)
        )
        u = jnp.fft.ifft(u_spec) * n
        half = (n + 1) // 2
        out = jnp.zeros_like(x)
        out = out.at[..., 0::2].set(jnp.real(u[..., :half]))
        out = out.at[..., 1::2].set(jnp.real(u[..., n - 1 : half - 1 : -1]))
    return jnp.moveaxis(out.astype(x.dtype), -1, axis)


def dct2_fft(a: jnp.ndarray) -> jnp.ndarray:
    """2D DCT-II (FFTW REDFT10 x2) via FFT over the trailing two axes."""
    return _dct1d_fft(_dct1d_fft(a, -1), -2)


def idct2_fft(a: jnp.ndarray) -> jnp.ndarray:
    """2D DCT-III (FFTW REDFT01 x2) via FFT over the trailing two axes."""
    return _dct1d_fft(_dct1d_fft(a, -1, inverse=True), -2, inverse=True)


@functools.lru_cache(maxsize=64)
def _dct4_matrix(n: int) -> np.ndarray:
    """Unnormalized DCT-IV matrix ``2 cos(pi (j+1/2)(k+1/2) / n)``.
    Symmetric; ``M4 @ M4 == 2n * I``."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * (j + 0.5) * (k + 0.5) / n)


_MIN_SPLIT_LEAF = 64


def effective_split_depth(n: int, depth: int | None = None) -> int:
    """Largest usable split depth for length ``n``: limited by the requested
    ``depth`` (None = auto), by divisibility (each level halves the length),
    and by the leaf floor (leaf DCT-II stays >= 64 so the matmuls keep
    useful contraction extents)."""
    if depth is None:
        depth = 3
    d = 0
    m = n
    while d < depth and m % 2 == 0 and m // 2 >= _MIN_SPLIT_LEAF:
        m //= 2
        d += 1
    return d


@functools.lru_cache(maxsize=64)
def split_permutation(n: int, depth: int) -> np.ndarray:
    """Coefficient permutation of the split-radix layout:
    ``Y_split[i] == Y_natural[perm[i]]`` for the 1D transforms below.
    Layout (recursively): [even-coefficient block (recursed), odd
    coefficients ascending]."""
    if depth == 0:
        return np.arange(n)
    h = n // 2
    p = split_permutation(h, depth - 1)
    return np.concatenate([2 * p, 2 * np.arange(h) + 1])


def _mm_last(a, m, precision):
    """Apply matrix ``m`` (already a traced/host array) along the trailing
    axis: ``out[..., k] = sum_j a[..., j] m[k, j]``."""
    return jnp.matmul(a, jnp.asarray(m, a.dtype).T, precision=precision)


def _dct1d_split_last(x, depth: int, precision):
    """1D FFTW REDFT10 along the last axis via the even/odd split recursion
    (exact identity: ``Y[2k] = DCT2_h(x_lo + rev(x_hi))``, ``Y[2k+1] =
    DCT4_h(x_lo - rev(x_hi))``), leaving coefficients in the
    ``split_permutation`` layout. Multiply-adds drop to ~1/3 of the dense
    transform at depth 3 (sum (n/2^k)^2 vs n^2 per row)."""
    iv_blocks = []
    cur = x
    for _ in range(depth):
        h = cur.shape[-1] // 2
        lo = cur[..., :h]
        hi = cur[..., :h - 1:-1]  # cur[..., h:] reversed
        iv_blocks.append(lo - hi)
        cur = lo + hi
    parts = [_mm_last(cur, _dct_matrix(cur.shape[-1], 2, x.dtype), precision)]
    for blk in reversed(iv_blocks):  # small -> large, matching the perm
        parts.append(
            _mm_last(blk, _dct_matrix(blk.shape[-1], 4, x.dtype), precision)
        )
    return jnp.concatenate(parts, axis=-1)


def _idct1d_split_last(y, depth: int, precision):
    """1D FFTW REDFT01 along the last axis from split-layout coefficients.
    Scale-free recursion: with ``G_n = 2n * C2inv_n`` (= FFTW REDFT01),
    ``G_n(y) = concat(S + D, rev(S - D))`` where ``S = G_h(y_even_block)``
    and ``D = y_odd @ DCT4_h`` — no divisions anywhere."""
    def rec(yblk, d):
        n = yblk.shape[-1]
        if d == 0:
            return _mm_last(yblk, _dct_matrix(n, 3, yblk.dtype), precision)
        h = n // 2
        s = rec(yblk[..., :h], d - 1)
        dmat = _mm_last(yblk[..., h:], _dct_matrix(h, 4, yblk.dtype), precision)
        a = s + dmat
        b = (s - dmat)[..., ::-1]
        return jnp.concatenate([a, b], axis=-1)

    return rec(y, depth)


def _split_axis(a, axis, depth, precision, inverse):
    fn = _idct1d_split_last if inverse else _dct1d_split_last
    if axis in (-1, a.ndim - 1):
        return fn(a, depth, precision)
    a = jnp.swapaxes(a, axis, -1)
    return jnp.swapaxes(fn(a, depth, precision), axis, -1)


def dct2_split(a: jnp.ndarray, depth=None,
               precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """2D DCT-II (FFTW REDFT10 x2) over the trailing two axes with the
    split-radix matmul factorization. Coefficients come back PERMUTED to
    the split layout per axis (``split_permutation``); callers that stay in
    the spectral domain (the curvature solver) absorb the permutation into
    their precomputed eigenvalue table instead of reordering data."""
    nx, ny = a.shape[-2], a.shape[-1]
    dx, dy = effective_split_depth(nx, depth), effective_split_depth(ny, depth)
    return _split_axis(_split_axis(a, -1, dy, precision, False),
                       -2, dx, precision, False)


def idct2_split(a: jnp.ndarray, depth=None,
                precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """2D DCT-III (FFTW REDFT01 x2) over the trailing two axes from
    split-layout coefficients. ``idct2_split(dct2_split(x)) == 4*nx*ny*x``
    exactly as with the dense pair."""
    nx, ny = a.shape[-2], a.shape[-1]
    dx, dy = effective_split_depth(nx, depth), effective_split_depth(ny, depth)
    return _split_axis(_split_axis(a, -1, dy, precision, True),
                       -2, dx, precision, True)


def curvature_eigenvalues(
    nx: int, ny: int, alpha: float, tau: float, dtype=jnp.float32,
    perm_x: np.ndarray | None = None, perm_y: np.ndarray | None = None,
) -> jnp.ndarray:
    """Inverse eigenvalues of the semi-implicit biharmonic (curvature) update
    in the DCT basis:
    ``1 / (1 + tau * alpha * (-4 + 2 cos(p pi / nx) + 2 cos(q pi / ny))^2)``
    (reference ``OpticalFlowCurvature.cpp:6-30``; note the reference's PI
    constant is 3.14159265, reproduced here for bit-level parity).

    ``perm_x``/``perm_y`` reindex the table to a permuted coefficient layout
    (the split-radix solvers fold ``split_permutation`` in here). The
    biharmonic symbol is a function of a SEPARABLE sum ``a[p] + b[q]``, so
    the permutation is applied to the tiny 1D cosine tables, never to the
    full grid. Past the ``_DEVICE_GEN_MIN`` extent the [nx, ny] table is
    assembled on device from those 1D host tables (outer sum + elementwise)
    instead of shipping an nx*ny f32 constant through the compile request
    (256 MB at 8192^2)."""
    PI = 3.14159265
    cx = 2.0 * np.cos(np.arange(nx, dtype=np.float64) * PI / nx)
    cy = 2.0 * np.cos(np.arange(ny, dtype=np.float64) * PI / ny)
    if perm_x is not None:
        cx = cx[perm_x]
    if perm_y is not None:
        cy = cy[perm_y]
    if max(nx, ny) >= _DEVICE_GEN_MIN:
        lam = (jnp.asarray(cx - 4.0, dtype)[:, None]
               + jnp.asarray(cy, dtype)[None, :])
        return 1.0 / (1.0 + jnp.asarray(tau * alpha, dtype) * lam * lam)
    # Host path: keep the reference's exact f64 expression order
    # (-4 + 2cos + 2cos) for bit-stable parity at oracle-testable sizes.
    eig = 1.0 / (1.0 + tau * alpha * (-4.0 + cx[:, None] + cy[None, :]) ** 2)
    return jnp.asarray(eig, dtype)
