import numpy as np
import jax.numpy as jnp
import pytest

from opticalflow2d_tpu.ops.resample import (
    pyramid_dims,
    downsample_image,
    upsample_image,
    downsample_motion,
    upsample_motion,
)
from opticalflow2d_tpu.ops.conv import (
    convolve2d_clip,
    convolve2d_flatwrap,
    gaussian_kernel_2d,
)
from opticalflow2d_tpu.ops.dct import dct2_fftw, idct2_fftw, curvature_eigenvalues
import reference_impl as ref


def test_pyramid_dims_truncation():
    # 101 / 2 = 50.5 -> 50 (float division then int cast, like the reference)
    assert pyramid_dims((101, 64), 2) == [(101, 64), (50, 32), (25, 16)]


def test_downsample_matches_reference(rng):
    f = rng.standard_normal((20, 16)).astype(np.float32)
    got = np.asarray(downsample_image(jnp.asarray(f), (10, 8)))
    want = ref.downsample(f.astype(np.float64), (10, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_downsample_odd_dims(rng):
    f = rng.standard_normal((21, 17)).astype(np.float32)
    got = np.asarray(downsample_image(jnp.asarray(f), (10, 8)))
    want = ref.downsample(f.astype(np.float64), (10, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_upsample_matches_reference(rng):
    f = rng.standard_normal((10, 8)).astype(np.float32)
    got = np.asarray(upsample_image(jnp.asarray(f), (20, 16)))
    want = ref.upsample(f.astype(np.float64), (20, 16))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_upsample_odd_target(rng):
    f = rng.standard_normal((10, 8)).astype(np.float32)
    got = np.asarray(upsample_image(jnp.asarray(f), (21, 17)))
    want = ref.upsample(f.astype(np.float64), (21, 17))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dims", [((10, 8), (20, 16)), ((10, 8), (21, 17)),
                                  ((13, 13), (26, 27)), ((32, 24), (32, 24))])
def test_upsample_matmul_taps_bit_exact_vs_gather(rng, dims):
    """The selection-matmul tap path must be bit-identical to the
    dynamic exact-gather path it replaced."""
    from opticalflow2d_tpu.ops.warp import _bilinear_from_taps, _gather_taps_exact

    (nx_in, ny_in), (nx_out, ny_out) = dims
    f = rng.standard_normal((2, nx_in, ny_in)).astype(np.float32)
    got = np.asarray(upsample_image(jnp.asarray(f), (nx_out, ny_out)))

    dtype = jnp.float32
    i = jnp.arange(nx_out, dtype=dtype)[:, None]
    j = jnp.arange(ny_out, dtype=dtype)[None, :]
    px = jnp.broadcast_to(i * (nx_in / nx_out), (nx_out, ny_out))
    py = jnp.broadcast_to(j * (ny_in / ny_out), (nx_out, ny_out))
    value, weight, _ = _bilinear_from_taps(jnp.asarray(f), px, py,
                                           _gather_taps_exact)
    want = np.asarray(value / jnp.where(weight != 0, weight, 1.0))
    np.testing.assert_array_equal(got, want)


def test_motion_resample_rescales_components(rng):
    u = rng.standard_normal((2, 16, 12)).astype(np.float32)
    down = np.asarray(downsample_motion(jnp.asarray(u), (8, 6)))
    want_x = ref.downsample(u[0].astype(np.float64), (8, 6)) * (8 / 16)
    want_y = ref.downsample(u[1].astype(np.float64), (8, 6)) * (6 / 12)
    np.testing.assert_allclose(down[0], want_x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(down[1], want_y, rtol=1e-5, atol=1e-6)

    up = np.asarray(upsample_motion(jnp.asarray(u), (32, 24)))
    want_x = ref.upsample(u[0].astype(np.float64), (32, 24)) * 2.0
    np.testing.assert_allclose(up[0], want_x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sigma,width", [(2.0, 5), (1.0, 3), (3.0, 7)])
def test_convolve_clip_matches_dense_loops(rng, sigma, width):
    f = rng.standard_normal((14, 18)).astype(np.float32)
    got = np.asarray(convolve2d_clip(jnp.asarray(f), sigma, width))
    want = ref.convolve_clip(f.astype(np.float64), sigma, width)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_convolve_flatwrap_matches_reference_bug(rng):
    f = rng.standard_normal((12, 10)).astype(np.float32)
    got = np.asarray(convolve2d_flatwrap(jnp.asarray(f), 2.0, 5))
    want = ref.convolve_flatwrap(f.astype(np.float64), 2.0, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_convolve_clip_vs_flatwrap_differ_only_at_x_edges(rng):
    f = rng.standard_normal((16, 12)).astype(np.float32)
    a = np.asarray(convolve2d_clip(jnp.asarray(f), 2.0, 5))
    b = np.asarray(convolve2d_flatwrap(jnp.asarray(f), 2.0, 5))
    c = 2  # kernel half-width
    np.testing.assert_allclose(a[c:-c, :], b[c:-c, :], rtol=1e-4, atol=1e-5)
    assert not np.allclose(a[:c, 1:-1], b[:c, 1:-1], atol=1e-6)


def test_gaussian_kernel_matches_reference():
    got = gaussian_kernel_2d(2.0, 5)
    want = ref.gaussian_kernel_2d(2.0, 5)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_dct_roundtrip_scaling(rng):
    a = rng.standard_normal((16, 24)).astype(np.float32)
    out = np.asarray(idct2_fftw(dct2_fftw(jnp.asarray(a))))
    np.testing.assert_allclose(out, 4 * 16 * 24 * a, rtol=1e-3, atol=1e-3)


def test_dct_matches_reference_matrices(rng):
    a = rng.standard_normal((12, 10)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(dct2_fftw(jnp.asarray(a))),
        ref.dct2_fftw(a.astype(np.float64)),
        rtol=1e-4, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(idct2_fftw(jnp.asarray(a))),
        ref.idct2_fftw(a.astype(np.float64)),
        rtol=1e-4, atol=1e-3,
    )


def test_curvature_eigenvalues_range():
    eig = np.asarray(curvature_eigenvalues(32, 32, alpha=1.0, tau=1.0))
    assert eig.shape == (32, 32)
    assert eig[0, 0] == pytest.approx(1.0)  # zero frequency untouched
    assert np.all(eig > 0) and np.all(eig <= 1.0)


def test_dct_fft_matches_matmul(rng):
    from opticalflow2d_tpu.ops.dct import dct2_fft, idct2_fft

    for shape in [(16, 24), (15, 9), (32, 32)]:
        a = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(dct2_fft(jnp.asarray(a))),
            np.asarray(dct2_fftw(jnp.asarray(a))),
            rtol=1e-4, atol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(idct2_fft(jnp.asarray(a))),
            np.asarray(idct2_fftw(jnp.asarray(a))),
            rtol=1e-4, atol=1e-3,
        )


def test_curvature_fft_impl_matches_matmul(rng):
    from opticalflow2d_tpu.solvers.curvature import make_curvature_step
    from opticalflow2d_tpu.solvers.base import derivatives

    iref = rng.standard_normal((32, 28)).astype(np.float32)
    imov = rng.standard_normal((32, 28)).astype(np.float32)
    d = derivatives(jnp.asarray(iref), jnp.asarray(imov))
    u = jnp.asarray(0.1 * rng.standard_normal((2, 32, 28)).astype(np.float32))
    a = make_curvature_step(32, 28, 0.1, 1.0, dct_impl="matmul")(u, d)
    b = make_curvature_step(32, 28, 0.1, 1.0, dct_impl="fft")(u, d)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_curvature_high_impl_close_to_matmul(rng):
    from opticalflow2d_tpu.solvers.curvature import make_curvature_step
    from opticalflow2d_tpu.solvers.base import derivatives

    iref = rng.standard_normal((32, 28)).astype(np.float32)
    imov = rng.standard_normal((32, 28)).astype(np.float32)
    d = derivatives(jnp.asarray(iref), jnp.asarray(imov))
    u = jnp.asarray(0.1 * rng.standard_normal((2, 32, 28)).astype(np.float32))
    a = make_curvature_step(32, 28, 0.1, 1.0, dct_impl="matmul")(u, d)
    b = make_curvature_step(32, 28, 0.1, 1.0, dct_impl="matmul_high")(u, d)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_dct_split_matches_dense_permuted(rng):
    from opticalflow2d_tpu.ops.dct import (
        dct2_split, idct2_split, split_permutation, effective_split_depth)

    # 512 exercises depth 3, 384 depth 2 (odd factor limits), 28 depth 0
    for shape in [(512, 256), (384, 128), (28, 72)]:
        nx, ny = shape
        a = rng.standard_normal(shape).astype(np.float32)
        dx = effective_split_depth(nx)
        dy = effective_split_depth(ny)
        px = split_permutation(nx, dx)
        py = split_permutation(ny, dy)
        assert sorted(px) == list(range(nx))
        dense = np.asarray(dct2_fftw(jnp.asarray(a)))
        got = np.asarray(dct2_split(jnp.asarray(a)))
        scale = np.abs(dense).max()
        np.testing.assert_allclose(got / scale,
                                   dense[np.ix_(px, py)] / scale, atol=2e-5)
        # idct2_split(dct2_split(x)) == 4 nx ny x (FFTW round-trip scale)
        rt = np.asarray(idct2_split(dct2_split(jnp.asarray(a))))
        np.testing.assert_allclose(rt / (4.0 * nx * ny), a, atol=2e-4)
        # inverse from permuted dense coefficients matches dense inverse
        inv_dense = np.asarray(idct2_fftw(jnp.asarray(dense)))
        inv_got = np.asarray(idct2_split(jnp.asarray(dense[np.ix_(px, py)])))
        s2 = np.abs(inv_dense).max()
        np.testing.assert_allclose(inv_got / s2, inv_dense / s2, atol=2e-5)


def test_curvature_split_impl_matches_matmul(rng):
    from opticalflow2d_tpu.solvers.curvature import make_curvature_step
    from opticalflow2d_tpu.solvers.base import derivatives

    # 256x128 reaches split depth 2 in both axes
    nx, ny = 256, 128
    iref = rng.standard_normal((nx, ny)).astype(np.float32)
    imov = rng.standard_normal((nx, ny)).astype(np.float32)
    d = derivatives(jnp.asarray(iref), jnp.asarray(imov))
    u = jnp.asarray(0.1 * rng.standard_normal((2, nx, ny)).astype(np.float32))
    a = make_curvature_step(nx, ny, 0.1, 1.0, dct_impl="matmul")(u, d)
    for impl in ["split", "split_high", "split_fast"]:
        b = make_curvature_step(nx, ny, 0.1, 1.0, dct_impl=impl)(u, d)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-4)


def test_dct_impl_auto_resolution():
    """Production ``dct_impl="auto"`` resolves to the split-radix 3-pass
    transform (within the session tolerance of the HIGHEST matmul); bug-compat
    configs stay on the bit-closest dense HIGHEST transform."""
    from opticalflow2d_tpu.config import RegConfig, CompatFlags, Method

    base = dict(method=Method.CURVATURE, niter=(5,))
    assert RegConfig(**base).resolved_dct_impl == "split_high"
    assert RegConfig(
        **base, compat=CompatFlags(maxabs_bug=True)
    ).resolved_dct_impl == "matmul"
    assert RegConfig(
        **base, dct_impl="matmul_fast"
    ).resolved_dct_impl == "matmul_fast"
