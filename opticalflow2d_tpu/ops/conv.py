"""Boundary-renormalized 2D convolution and Gaussian kernels.

The reference convolves with a dense, normalized k x k kernel and renormalizes
by the sum of in-bounds kernel weights at each pixel (``src/Field.tpp:210-269``,
``src/Kernel.cpp:45-73``). Because the Gaussian factorizes as
``k2d[i,j] = gx[i] * gy[j]`` and the renormalization divides by the summed
included weights, the clipped variant is computed *separably*:

    out = sepconv(field, gx, gy) / (denx (x) deny)

which is exact and turns the O(N k^2) dense loop into two O(N k) passes that
XLA fuses into shift-adds — the data-parallel replacement for the reference's
scalar loops.

``convolve2d_flatwrap`` reproduces the reference's flat-index bounds-check bug
(``src/Field.tpp:245-246``): taps wrap across row boundaries in x instead of
clipping. It exists for oracle parity only (SURVEY.md §2.3.3).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def gaussian_kernel_1d(sigma: float, width: int) -> np.ndarray:
    """Unnormalized 1D Gaussian taps ``exp(-(t-c)^2 / (2 sigma^2))`` with
    center ``c = (width-1)//2`` (reference ``src/Kernel.cpp:52-61``; overall
    normalization cancels in the renormalized convolution)."""
    c = (width - 1) // 2
    t = np.arange(width, dtype=np.float64)
    return np.exp(-((t - c) ** 2) / (2.0 * sigma * sigma))


def gaussian_kernel_2d(sigma: float, width: int) -> np.ndarray:
    """Normalized dense 2D Gaussian, exactly the reference's
    ``Kernel::set_gaussian`` (``src/Kernel.cpp:45-73``)."""
    g = gaussian_kernel_1d(sigma, width)
    k = np.outer(g, g)
    return k / k.sum()


def _sepconv_axis(f: jnp.ndarray, taps: np.ndarray, axis: int) -> jnp.ndarray:
    """Correlate ``f`` with ``taps`` along ``axis`` using zero padding.
    Static shift-and-add: k adds fused by XLA."""
    k = len(taps)
    c = (k - 1) // 2
    pad = [(0, 0)] * f.ndim
    pad[axis] = (c, c)
    fp = jnp.pad(f, pad)
    n = f.shape[axis]
    out = None
    for t in range(k):
        sl = [slice(None)] * f.ndim
        sl[axis] = slice(t, t + n)
        term = fp[tuple(sl)] * float(taps[t])
        out = term if out is None else out + term
    return out


def convolve2d_clip(f: jnp.ndarray, sigma: float, width: int) -> jnp.ndarray:
    """Boundary-renormalized Gaussian convolution with clipped (non-wrapping)
    edges, computed separably. Operates on the trailing two axes."""
    gx = gaussian_kernel_1d(sigma, width)
    gy = gx  # isotropic
    num = _sepconv_axis(_sepconv_axis(f, gx, f.ndim - 2), gy, f.ndim - 1)
    nx, ny = f.shape[-2], f.shape[-1]
    onesx = jnp.ones((nx,), f.dtype)
    onesy = jnp.ones((ny,), f.dtype)
    denx = _sepconv_axis(onesx, gx, 0)
    deny = _sepconv_axis(onesy, gy, 0)
    den = denx[:, None] * deny[None, :]
    return num / den


def convolve2d_flatwrap(f: jnp.ndarray, sigma: float, width: int) -> jnp.ndarray:
    """Bug-compatible renormalized convolution: bounds are checked on the
    *flat* x-fastest index, so x-edge taps wrap into the adjacent row
    (reference ``src/Field.tpp:242-258``). Dense k^2 taps over a flattened
    array — used only by parity tests and compat-mode demons smoothing.

    Operates on the trailing two axes ``[..., nx, ny]``.
    """
    k2d = gaussian_kernel_2d(sigma, width)
    kw = width
    c = (kw - 1) // 2
    nx, ny = f.shape[-2], f.shape[-1]
    size = nx * ny

    # Reference flat layout is x-fastest: flat[i + j*nx] = f[i, j].
    # Our [..., nx, ny] C-order layout is y-fastest, so transpose first.
    ft = jnp.swapaxes(f, -1, -2)  # [..., ny, nx]
    flat = ft.reshape(*ft.shape[:-2], size)

    idx = jnp.arange(size)
    num = jnp.zeros_like(flat)
    den = jnp.zeros((size,), f.dtype)
    for ii in range(-c, c + 1):
        for jj in range(-c, c + 1):
            o = ii + jj * nx
            w = float(k2d[ii + c, jj + c])
            mask = (idx + o >= 0) & (idx + o < size)
            shifted = jnp.roll(flat, -o, axis=-1)
            num = num + jnp.where(mask, shifted * w, 0.0)
            den = den + jnp.where(mask, w, 0.0)
    out_flat = num / den
    out_t = out_flat.reshape(*ft.shape[:-2], ny, nx)
    return jnp.swapaxes(out_t, -1, -2)


def gaussian_smooth(
    f: jnp.ndarray, sigma: float, width: int, flatwrap: bool = False
) -> jnp.ndarray:
    """Renormalized Gaussian smoothing; ``flatwrap`` selects the
    bug-compatible edge behavior."""
    if flatwrap:
        return convolve2d_flatwrap(f, sigma, width)
    return convolve2d_clip(f, sigma, width)


def box_kernel_2d(width: int) -> np.ndarray:
    """Uniform averaging kernel — the reference's ``Kernel::set_average``
    (``src/Kernel.cpp:75-82``; dead code there, provided for API parity)."""
    return np.full((width, width), 1.0 / (width * width))


def convolve2d_kernel(f: jnp.ndarray, k2d: np.ndarray) -> jnp.ndarray:
    """Renormalized clipped convolution with an arbitrary dense 2D kernel
    (odd dims), the general form of the reference's ``Field::convolute``
    (``src/Field.tpp:210-269``, with the flat-wrap defect fixed). Static
    k^2 shift-adds over the trailing two axes; use ``convolve2d_clip`` for
    the separable Gaussian fast path."""
    kx, ky = k2d.shape
    cx, cy = (kx - 1) // 2, (ky - 1) // 2
    nx, ny = f.shape[-2], f.shape[-1]
    pad = [(0, 0)] * (f.ndim - 2) + [(cx, cx), (cy, cy)]
    fp = jnp.pad(f, pad)
    ones = jnp.pad(jnp.ones((nx, ny), f.dtype), [(cx, cx), (cy, cy)])
    num = None
    den = None
    for i in range(kx):
        for j in range(ky):
            w = float(k2d[i, j])
            sl_f = fp[..., i : i + nx, j : j + ny] * w
            sl_o = ones[i : i + nx, j : j + ny] * w
            num = sl_f if num is None else num + sl_f
            den = sl_o if den is None else den + sl_o
    return num / den
