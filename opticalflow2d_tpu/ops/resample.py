"""Pyramid resampling: box-filter downsample, bilinear upsample, and the
motion-vector rescaling that accompanies them.

- Downsample: mean over ``factor x factor`` patches anchored at
  ``(i*factor_x, j*factor_y)`` with ``factor = dim_in // dim_out``
  (reference ``src/Field.tpp:76-143``; all patches are full for the pyramid
  dims the reference constructs, so this is an exact match).
- Upsample: origin-aligned bilinear interpolation with edge-weight
  renormalization (reference ``src/Field.tpp:146-206``).
- Motion variants scale each displacement component by the dimension ratio
  target/source (reference ``src/Motion.cpp:61-111``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from opticalflow2d_tpu.ops.warp import _bilinear_from_taps


def pyramid_dims(dim0: Tuple[int, int], nscales: int):
    """Per-scale dims ``dim0 / 2^s`` (float division then truncation), exactly
    as the reference constructs them (``src/ImageRegistration.cpp:54-61``)."""
    nx, ny = dim0
    return [(int(nx / (2.0 ** s)), int(ny / (2.0 ** s))) for s in range(nscales + 1)]


def _box_matrix(n_out: int, f: int, dtype) -> jnp.ndarray:
    """``[n_out, n_out*f]`` box-mean matrix: row i holds ``1/f`` over
    columns ``[i*f, (i+1)*f)``. Built from iota comparisons (no embedded
    constant) — for power-of-two ``f`` the products are exact, so the
    matmul mean rounds once per output, like any summed mean."""
    i = jnp.arange(n_out, dtype=jnp.int32)[:, None]
    k = jnp.arange(n_out * f, dtype=jnp.int32)[None, :]
    return jnp.where((k >= i * f) & (k < (i + 1) * f), 1.0 / f, 0.0).astype(
        dtype)


def downsample_image(image: jnp.ndarray, dimout: Tuple[int, int]) -> jnp.ndarray:
    """Box-filter downsample ``[..., nx, ny] -> [..., nx_out, ny_out]``.

    Two equivalent evaluations: the 4D reshape + mean (exact historical
    float behavior, used at parity-relevant sizes), and box-mean matmuls
    at ``Precision.HIGHEST`` for extents past 4096. Values differ from
    reshape+mean only in summation order (~1 ulp), at sizes no parity
    test reaches."""
    nx_in, ny_in = image.shape[-2], image.shape[-1]
    nx_out, ny_out = dimout
    if nx_out > nx_in or ny_out > ny_in:
        raise ValueError("downsample target must not exceed source dims")
    fx = nx_in // nx_out
    fy = ny_in // ny_out
    cropped = image[..., : nx_out * fx, : ny_out * fy]
    if nx_in > 4096 or ny_in > 4096:
        hp = jax.lax.Precision.HIGHEST
        sx = _box_matrix(nx_out, fx, image.dtype)
        syt = _box_matrix(ny_out, fy, image.dtype).T
        tmp = jnp.einsum("ik,...kl->...il", sx, cropped, precision=hp)
        return jnp.einsum("...il,lj->...ij", tmp, syt, precision=hp)
    shaped = cropped.reshape(*cropped.shape[:-2], nx_out, fx, ny_out, fy)
    return shaped.mean(axis=(-3, -1))


def _onehot_rows(idx: jnp.ndarray, n_in: int, dtype) -> jnp.ndarray:
    """``[n_out, n_in]`` selection matrix: row r is one-hot at ``idx[r]``."""
    return (idx[:, None] == jnp.arange(n_in, dtype=idx.dtype)[None, :]).astype(
        dtype
    )


def _taps_matmul_separable(data, dx, dy):
    """The four bilinear taps via one-hot selection matmuls.

    Valid only for separable (axis-aligned) sample grids — ``dx`` constant
    along axis 1 and ``dy`` constant along axis 0 — which is exactly the
    upsample case. Bit-identical to ``_gather_taps_exact``: every output
    element is a dot product of a one-hot row with the data, i.e. one exact
    product (at ``Precision.HIGHEST`` a product with 0 or 1 is exact)
    summed with exact zeros. It stands in for a dynamic gather.
    """
    nx, ny = data.shape[-2], data.shape[-1]
    ix0 = jnp.clip(dx[:, 0], 0, nx - 1)
    ix1 = jnp.clip(dx[:, 0] + 1, 0, nx - 1)
    iy0 = jnp.clip(dy[0, :], 0, ny - 1)
    iy1 = jnp.clip(dy[0, :] + 1, 0, ny - 1)
    hp = jax.lax.Precision.HIGHEST
    sx0 = _onehot_rows(ix0, nx, data.dtype)
    sx1 = _onehot_rows(ix1, nx, data.dtype)
    sy0t = _onehot_rows(iy0, ny, data.dtype).T
    sy1t = _onehot_rows(iy1, ny, data.dtype).T
    a0 = jnp.einsum("ik,...kl->...il", sx0, data, precision=hp)
    a1 = jnp.einsum("ik,...kl->...il", sx1, data, precision=hp)
    g00 = jnp.einsum("...il,lj->...ij", a0, sy0t, precision=hp)
    g10 = jnp.einsum("...il,lj->...ij", a1, sy0t, precision=hp)
    g01 = jnp.einsum("...il,lj->...ij", a0, sy1t, precision=hp)
    g11 = jnp.einsum("...il,lj->...ij", a1, sy1t, precision=hp)
    return g00, g10, g01, g11


def upsample_image(image: jnp.ndarray, dimout: Tuple[int, int]) -> jnp.ndarray:
    """Origin-aligned bilinear upsample ``[C?, nx, ny] -> [C?, nx_out, ny_out]``.

    Sample point for output (i, j) is ``(i * nx_in / nx_out, j * ny_in / ny_out)``
    — note this is corner-anchored, not center-anchored, matching the
    reference (``src/Field.tpp:172-173``). The sample grid is static and
    separable, so the taps are fetched with selection matmuls
    (``_taps_matmul_separable``) instead of a dynamic gather.
    """
    nx_in, ny_in = image.shape[-2], image.shape[-1]
    nx_out, ny_out = dimout
    if nx_out < nx_in or ny_out < ny_in:
        raise ValueError("upsample target must not be below source dims")
    dtype = image.dtype
    i = jnp.arange(nx_out, dtype=dtype)[:, None]
    j = jnp.arange(ny_out, dtype=dtype)[None, :]
    px = jnp.broadcast_to(i * (nx_in / nx_out), (nx_out, ny_out))
    py = jnp.broadcast_to(j * (ny_in / ny_out), (nx_out, ny_out))

    squeeze = image.ndim == 2
    data = image[None] if squeeze else image
    value, weight, _ = _bilinear_from_taps(data, px, py, _taps_matmul_separable)
    out = value / jnp.where(weight != 0, weight, 1.0)
    return out[0] if squeeze else out


def _motion_ratio(u: jnp.ndarray, dimout: Tuple[int, int]) -> jnp.ndarray:
    nx_in, ny_in = u.shape[-2], u.shape[-1]
    nx_out, ny_out = dimout
    ratio = jnp.array(
        [nx_out / nx_in, ny_out / ny_in], dtype=u.dtype
    ).reshape((2,) + (1,) * (u.ndim - 1))
    return ratio


def downsample_motion(u: jnp.ndarray, dimout: Tuple[int, int]) -> jnp.ndarray:
    """Box downsample a motion field and rescale the displacement components
    by the dim ratio (reference ``src/Motion.cpp:87-111``)."""
    ratio = _motion_ratio(u, dimout)
    return downsample_image(u, dimout) * ratio


def upsample_motion(u: jnp.ndarray, dimout: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear upsample a motion field and rescale the displacement
    components by the dim ratio (reference ``src/Motion.cpp:61-85``)."""
    ratio = _motion_ratio(u, dimout)
    return upsample_image(u, dimout) * ratio
