import numpy as np
import jax.numpy as jnp

from opticalflow2d_tpu.ops.warp import warp2d, compose, expmap
from opticalflow2d_tpu.ops.reduce import motion_maxabs
import reference_impl as ref


def _rand_motion(rng, nx, ny, scale=2.0):
    return (scale * rng.standard_normal((2, nx, ny))).astype(np.float32)


def test_warp_zero_motion_is_identity(rng):
    img = rng.standard_normal((13, 17)).astype(np.float32)
    out = np.asarray(warp2d(jnp.asarray(img), jnp.zeros((2, 13, 17))))
    np.testing.assert_allclose(out, img, rtol=1e-6)


def test_warp_matches_reference_loops(rng):
    img = rng.standard_normal((19, 15)).astype(np.float32)
    u = _rand_motion(rng, 19, 15, scale=3.0)
    got = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u)))
    want = ref.warp2d(img.astype(np.float64), u.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_warp_out_of_bounds_passthrough(rng):
    img = rng.standard_normal((8, 8)).astype(np.float32)
    u = np.full((2, 8, 8), 100.0, np.float32)  # everything lands outside
    out = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u)))
    np.testing.assert_allclose(out, img)


def test_warp_integer_translation(rng):
    img = rng.standard_normal((10, 10)).astype(np.float32)
    u = np.zeros((2, 10, 10), np.float32)
    u[0] = 2.0  # sample at x+2
    out = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u)))
    np.testing.assert_allclose(out[:-2], img[2:], rtol=1e-6)


def test_compose_matches_reference_loops(rng):
    u_total = _rand_motion(rng, 14, 16, scale=2.5)
    u_inc = _rand_motion(rng, 14, 16, scale=1.5)
    got = np.asarray(compose(jnp.asarray(u_total), jnp.asarray(u_inc)))
    want = ref.compose(u_total.astype(np.float64), u_inc.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_compose_with_zero_increment_is_additive_identity(rng):
    u = _rand_motion(rng, 9, 11, scale=1.0)
    got = np.asarray(compose(jnp.asarray(u), jnp.zeros_like(jnp.asarray(u))))
    # zero increment: u_new = 0 + u(x+0) = u
    np.testing.assert_allclose(got, u, rtol=1e-5, atol=1e-6)


def test_maxabs_and_bug_mode(rng):
    u = np.zeros((2, 4, 4), np.float32)
    u[0, 1, 1] = 3.0
    u[1, 2, 2] = 1.0
    assert np.isclose(float(motion_maxabs(jnp.asarray(u))), np.sqrt(9 + 0))
    # bug mode: y-component counted twice, x ignored
    assert np.isclose(float(motion_maxabs(jnp.asarray(u), bug=True)), np.sqrt(2.0))


def test_expmap_zero_is_zero():
    u = jnp.zeros((2, 8, 8))
    np.testing.assert_allclose(np.asarray(expmap(u)), 0.0)


def test_expmap_small_field_nearly_identity(rng):
    # For |v| << 1 the exponential map is v + O(v^2).
    v = (1e-3 * rng.standard_normal((2, 16, 16))).astype(np.float32)
    out = np.asarray(expmap(jnp.asarray(v)))
    np.testing.assert_allclose(out, v, atol=1e-5)


def test_expmap_positive_jacobian(rng):
    # Diffeomorphic property: exp of any (moderate) velocity field has
    # positive Jacobian determinant nearly everywhere.
    from opticalflow2d_tpu.ops.grid import jacobian_det

    v = (2.0 * rng.standard_normal((2, 24, 24))).astype(np.float32)
    out = expmap(jnp.asarray(v))
    jac = np.asarray(jacobian_det(out))
    assert (jac[2:-2, 2:-2] > 0).mean() > 0.97


def test_warp_rolls_fast_path_matches_exact(rng):
    # Bounded displacement: the roll-based path must match the exact gather.
    img = rng.standard_normal((24, 20)).astype(np.float32)
    u = (2.5 * rng.standard_normal((2, 24, 20))).astype(np.float32)
    a = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u), halo=0))
    b = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u), halo=4))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_warp_halo_fallback_when_exceeded(rng):
    # Displacements beyond the halo must take the exact path (identical out).
    img = rng.standard_normal((24, 20)).astype(np.float32)
    u = (6.0 * rng.standard_normal((2, 24, 20))).astype(np.float32)
    a = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u), halo=0))
    b = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u), halo=2))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_compose_rolls_fast_path_matches_exact(rng):
    u_total = (3.0 * rng.standard_normal((2, 18, 22))).astype(np.float32)
    u_inc = (1.5 * rng.standard_normal((2, 18, 22))).astype(np.float32)
    a = np.asarray(compose(jnp.asarray(u_total), jnp.asarray(u_inc), halo=0))
    b = np.asarray(compose(jnp.asarray(u_total), jnp.asarray(u_inc), halo=3))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_roll_path_extent_guard():
    """Past _ROLL_PATH_MAX_EXTENT the halo>0 path must trace as the exact
    gather (no lax.cond roll branch): the (2h+2)^2-copy roll chain's
    compile time grows with the extent. Checked on abstract shapes via the
    jaxpr, so no 8192^2 arrays are allocated."""
    import jax

    def traced_has_cond(n):
        img = jax.ShapeDtypeStruct((n, n), jnp.float32)
        u = jax.ShapeDtypeStruct((2, n, n), jnp.float32)
        jaxpr = jax.make_jaxpr(
            lambda i, v: warp2d(i, v, halo=3)
        )(img, u)
        return "cond" in {e.primitive.name for e in jaxpr.jaxpr.eqns}

    assert traced_has_cond(1024)       # roll fast path + runtime fallback
    assert not traced_has_cond(8192)   # guard collapses to exact gather
