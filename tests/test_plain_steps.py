"""The plain jnp solver steps against loop transcriptions of the reference
(tests/reference_impl.py), at square, ragged-row and wide shapes; the warp
fast path against the exact gather inside and beyond its halo; and the
fluid driver's regrid count and events against a host replay."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

import reference_impl as ref
from conftest import make_pair
from opticalflow2d_tpu import Method, RegConfig
from opticalflow2d_tpu.config import MotionAccumulation
from opticalflow2d_tpu.ops.warp import compose, warp2d
from opticalflow2d_tpu.solvers.base import derivatives, stack_derivs
from opticalflow2d_tpu.solvers.demons import make_demons_step
from opticalflow2d_tpu.solvers.diffusion import diffusion_step
from opticalflow2d_tpu.solvers.elastic import elastic_step
from opticalflow2d_tpu.solvers.fluid import make_fluid_step

# Square, ragged-row (not a multiple of 8) and wide shapes.
SHAPES = [(48, 40), (60, 40), (120, 64), (36, 96)]


def _inputs(shape, seed=0, motion_scale=0.6):
    rng = np.random.default_rng(seed)
    iref, imov = make_pair(*shape, shift=(1.3, -0.7), rng=rng)
    u = (motion_scale * rng.standard_normal((2,) + shape)).astype(np.float32)
    return iref, imov, u


def _np_derivs(iref, imov):
    iref = iref.astype(np.float64)
    imov = imov.astype(np.float64)
    return np.stack([ref.partial_x(imov), ref.partial_y(imov)]), imov - iref


def _np_force(grad, it, u):
    return grad * (it + u[0] * grad[0] + u[1] * grad[1])[None]


def _np_sor_redblack(x, b, mu, lam, omega, reference_stencil):
    """Red-black SOR: each colour's interior pixels are updated from the
    field as it stood before that half-sweep (the same per-pixel update as
    ref.sor_sweep_lexicographic)."""
    nx, ny = x.shape[1:]
    inv = omega / (-6 * mu - 2 * lam)
    for colour in (0, 1):
        old = x.copy()
        for i in range(1, nx - 1):
            for j in range(1, ny - 1):
                if (i + j) % 2 != colour:
                    continue
                for c in range(2):
                    o = 1 - c
                    lap4 = (old[c, i + 1, j] + old[c, i - 1, j]
                            + old[c, i, j + 1] + old[c, i, j - 1])
                    cross = 0.25 * (old[o, i + 1, j + 1] - old[o, i - 1, j + 1]
                                    - old[o, i + 1, j - 1]
                                    + old[o, i - 1, j - 1])
                    if c == 0 or reference_stencil:
                        second = old[c, i + 1, j] + old[c, i - 1, j]
                    else:
                        second = old[c, i, j + 1] + old[c, i, j - 1]
                    num = (b[c, i, j] - mu * lap4
                           - (mu + lam) * (second + cross))
                    x[c, i, j] = (1 - omega) * old[c, i, j] + inv * num
    return x


def _np_diffusion_step(u, grad, it, alpha):
    q = np.stack([ref.qlaplacian(u[0]), ref.qlaplacian(u[1])])
    den = alpha * alpha + grad[0] ** 2 + grad[1] ** 2
    return q - _np_force(grad, it, q) / den[None]


@pytest.mark.parametrize("shape", SHAPES + [(33, 17)])
def test_diffusion_step_matches_reference(shape):
    iref, imov, u = _inputs(shape)
    grad, it = _np_derivs(iref, imov)
    got = diffusion_step(jnp.asarray(u), derivatives(iref, imov), 0.5)
    want = _np_diffusion_step(u.astype(np.float64), grad, it, 0.5)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(48, 40), (60, 40)])
def test_diffusion_iterated_matches_reference(shape):
    iref, imov, _ = _inputs(shape)
    grad, it = _np_derivs(iref, imov)
    d = derivatives(iref, imov)
    u = jnp.zeros((2,) + shape, jnp.float32)
    want = np.zeros((2,) + shape)
    for _ in range(8):
        u = diffusion_step(u, d, 0.5)
        want = _np_diffusion_step(want, grad, it, 0.5)
    np.testing.assert_allclose(np.asarray(u), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reference_stencil", [True, False],
                         ids=["reference_stencil", "symmetric_stencil"])
@pytest.mark.parametrize("shape", SHAPES)
def test_elastic_redblack_step_matches_reference(shape, reference_stencil):
    iref, imov, u = _inputs(shape)
    grad, it = _np_derivs(iref, imov)
    got = elastic_step(jnp.asarray(u), derivatives(iref, imov), 0.5, 0.2,
                       0.66, reference_stencil, "redblack")
    u64 = u.astype(np.float64)
    want = _np_sor_redblack(u64.copy(), _np_force(grad, it, u64), 0.5, 0.2,
                            0.66, reference_stencil)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference_stencil", [True, False],
                         ids=["reference_stencil", "symmetric_stencil"])
def test_elastic_lexicographic_step_matches_reference(reference_stencil):
    iref, imov, u = _inputs((24, 20))
    grad, it = _np_derivs(iref, imov)
    got = elastic_step(jnp.asarray(u), derivatives(iref, imov), 0.5, 0.2,
                       0.66, reference_stencil, "lexicographic")
    u64 = u.astype(np.float64)
    want = ref.sor_sweep_lexicographic(u64, _np_force(grad, it, u64), 0.5,
                                       0.2, 0.66, reference_stencil)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def _np_fluid_step(u, vel, grad, it, mu, lam, omega, maxabs_bug,
                   reference_stencil, dumax=0.65, timestep_skip=65.0):
    vel = _np_sor_redblack(vel.copy(), _np_force(grad, it, u), mu, lam, omega,
                           reference_stencil)
    dudx = np.stack([ref.partial_x(u[0]), ref.partial_x(u[1])])
    dudy = np.stack([ref.partial_y(u[0]), ref.partial_y(u[1])])
    r = vel - dudx * vel[0][None] - dudy * vel[1][None]
    sq = (r[1] ** 2 + r[1] ** 2) if maxabs_bug else (r[0] ** 2 + r[1] ** 2)
    dt = dumax / math.sqrt(sq.max())
    if dt < timestep_skip:
        u = u + r * dt
    return u, vel


@pytest.mark.parametrize("shape,maxabs_bug,reference_stencil", [
    ((48, 40), False, True),
    ((48, 40), True, True),
    ((60, 40), False, True),
    ((60, 40), True, False),
    ((120, 64), False, True),
    ((36, 96), False, False),
])
def test_fluid_step_matches_reference(shape, maxabs_bug, reference_stencil):
    iref, imov, u = _inputs(shape)
    rng = np.random.default_rng(1)
    vel = (0.3 * rng.standard_normal((2,) + shape)).astype(np.float32)
    grad, it = _np_derivs(iref, imov)
    step = make_fluid_step(0.25, 0.0, 0.66, maxabs_bug=maxabs_bug,
                           reference_stencil=reference_stencil)
    got_u, got_v, _ = step(jnp.asarray(u), jnp.asarray(vel),
                           derivatives(iref, imov))
    want_u, want_v = _np_fluid_step(u.astype(np.float64),
                                    vel.astype(np.float64), grad, it, 0.25,
                                    0.0, 0.66, maxabs_bug, reference_stencil)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_u), want_u, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("maxabs_bug", [False, True])
def test_fluid_trajectory_matches_reference(maxabs_bug):
    """Six warm-started iterations: the adaptive timestep, the velocity
    carried across iterations and the skip rule all follow the loops."""
    iref, imov, _ = _inputs((48, 40))
    grad, it = _np_derivs(iref, imov)
    step = make_fluid_step(0.25, 0.0, 0.66, maxabs_bug=maxabs_bug)
    d = derivatives(iref, imov)
    u = vel = jnp.zeros((2, 48, 40), jnp.float32)
    want_u = want_v = np.zeros((2, 48, 40))
    for _ in range(6):
        u, vel, _ = step(u, vel, d)
        want_u, want_v = _np_fluid_step(want_u, want_v, grad, it, 0.25, 0.0,
                                        0.66, maxabs_bug, True)
    np.testing.assert_allclose(np.asarray(u), want_u, rtol=1e-4, atol=1e-5)


def _np_smooth(f, sigma, width):
    return np.stack([ref.convolve_clip(c, sigma, width) for c in f])


def _np_demons_step(u, iref, imov, kernelwidth, diffeomorphic, addition,
                    sigma_i=1.0, sigma_x=0.25, sigma_d=2.0, sigma_f=2.0):
    iwar = ref.warp2d(imov, u)
    grad = np.stack([ref.partial_x(iwar), ref.partial_y(iwar)])
    it = iwar - iref
    den = grad[0] ** 2 + grad[1] ** 2 + it ** 2 * sigma_i ** 2 / sigma_x ** 2
    c = np.where(den > 0, -grad * it / np.where(den > 0, den, 1.0), 0.0)
    c = _np_smooth(c, sigma_f, kernelwidth)
    if diffeomorphic:
        m = math.sqrt((c[0] ** 2 + c[1] ** 2).max())
        nsq = max(0, math.ceil(1 + math.log2(m))) if m > 0 else 0
        c = c * 2.0 ** -nsq
        for _ in range(nsq):
            c = ref.compose(c, c)
    u = u + c if addition else ref.compose(u, c)
    return _np_smooth(u, sigma_d, kernelwidth)


@pytest.mark.parametrize("shape", [(48, 40), (60, 40)])
@pytest.mark.parametrize("method,accumulation,kernelwidth", [
    (Method.THIRIONS_DEMONS, MotionAccumulation.COMPOSITION, 5),
    (Method.THIRIONS_DEMONS, MotionAccumulation.COMPOSITION, 7),
    (Method.THIRIONS_DEMONS, MotionAccumulation.ADDITION, 5),
    (Method.THIRIONS_DEMONS, MotionAccumulation.ADDITION, 7),
    (Method.DIFFEOMORPHIC_DEMONS, MotionAccumulation.COMPOSITION, 5),
    (Method.DIFFEOMORPHIC_DEMONS, MotionAccumulation.COMPOSITION, 7),
], ids=["thirion-compose-5", "thirion-compose-7", "thirion-add-5",
        "thirion-add-7", "diffeo-5", "diffeo-7"])
def test_demons_step_matches_reference(method, accumulation, kernelwidth,
                                       shape):
    iref, imov, u = _inputs(shape, motion_scale=0.8)
    diffeo = method == Method.DIFFEOMORPHIC_DEMONS
    step = make_demons_step(1.0, 0.25, 2.0, 2.0, kernelwidth,
                            diffeomorphic=diffeo, accumulation=accumulation,
                            warp_halo=2, with_errors=True)
    got, sums = step(jnp.asarray(u), jnp.asarray(iref), jnp.asarray(imov))
    want = _np_demons_step(u.astype(np.float64), iref.astype(np.float64),
                           imov.astype(np.float64), kernelwidth, diffeo,
                           accumulation == MotionAccumulation.ADDITION)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)
    # The Logger sums are [sum |u_new - u|, sum |u|] over pixels.
    d = want - u
    np.testing.assert_allclose(
        np.asarray(sums),
        [np.sqrt(d[0] ** 2 + d[1] ** 2).sum(),
         np.sqrt(u[0] ** 2 + u[1] ** 2).sum()], rtol=1e-4)


def _field_with_offset(shape, max_offset, seed=3):
    """Motion whose largest floor offset is exactly ``max_offset``."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.9, 0.9, (2,) + shape).astype(np.float32)
    u[0, shape[0] // 2, shape[1] // 2] = max_offset + 0.25
    return u


@pytest.mark.parametrize("halo,offset", [
    (0, 1), (2, 1), (2, 2), (2, 4), (4, 3), (4, 4), (4, 7),
], ids=["h0", "h2-inside", "h2-edge", "h2-beyond", "h4-inside", "h4-edge",
        "h4-beyond"])
def test_warp_and_compose_halo_match_exact(halo, offset):
    """Inside the halo the roll chain runs, beyond it the runtime check
    falls back to the exact gather; both equal the loop reference."""
    shape = (30, 26)
    rng = np.random.default_rng(0)
    img = rng.standard_normal(shape).astype(np.float32)
    u_tot = rng.standard_normal((2,) + shape).astype(np.float32)
    u = _field_with_offset(shape, offset)
    got_w = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u), halo))
    got_c = np.asarray(compose(jnp.asarray(u_tot), jnp.asarray(u), halo))
    np.testing.assert_allclose(got_w, ref.warp2d(img.astype(np.float64), u),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got_c, ref.compose(u_tot.astype(np.float64), u.astype(np.float64)),
        rtol=1e-5, atol=1e-5)
    exact_w = np.asarray(warp2d(jnp.asarray(img), jnp.asarray(u), 0))
    np.testing.assert_allclose(got_w, exact_w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("halo,expect_fallbacks", [(1, True), (4, False)])
def test_demons_level_counts_halo_fallbacks(halo, expect_fallbacks):
    """LevelTrace.fallbacks counts the iterations whose motion left the
    warp halo; the field is the same as the exact-gather run's."""
    iref, imov = make_pair(48, 40, shift=(2.5, -1.5))
    kw = dict(method=Method.THIRIONS_DEMONS, niter=(25,), nscales=0,
              warp_halo_outer=0)
    from opticalflow2d_tpu import register

    res = register(iref, imov, RegConfig(warp_halo=halo, **kw))
    exact = register(iref, imov, RegConfig(warp_halo=0, **kw))
    nfb = int(res.traces[0].fallbacks)
    assert (nfb > 0) == expect_fallbacks, nfb
    assert nfb <= int(res.traces[0].iterations)
    assert int(exact.traces[0].fallbacks) == 0
    np.testing.assert_allclose(np.asarray(res.motion),
                               np.asarray(exact.motion), rtol=1e-6, atol=1e-6)


def test_stack_derivs_layout():
    iref, imov, _ = _inputs((20, 18))
    d = derivatives(iref, imov)
    g = np.asarray(stack_derivs(d.grad_i, d.it))
    assert g.shape == (3, 20, 18)
    np.testing.assert_array_equal(g[:2], np.asarray(d.grad_i))
    np.testing.assert_array_equal(g[2], np.asarray(d.it))


def _replay_fluid_level(iref, imov, cfg, niter):
    """The fluid level loop (ImageRegistrationFluid.cpp:67-142) replayed
    on the host, one jnp call at a time: Logger prev kept across regrids,
    regrid only when the stop did not fire."""
    from opticalflow2d_tpu.ops.grid import jacobian_det
    from opticalflow2d_tpu.ops.reduce import motion_norm

    step = make_fluid_step(cfg.mu, cfg.lam, cfg.omega, dumax=cfg.dumax,
                           timestep_skip=cfg.timestep_skip)
    u_tot = jnp.zeros((2,) + iref.shape, jnp.float32)
    u_est = prev = vel = u_tot
    d = derivatives(iref, imov)
    events = []
    for it in range(niter):
        u_new, vel, _ = step(u_est, vel, d)
        pn = float(motion_norm(prev))
        err = 0.0 if pn == 0 else float(motion_norm(u_new - prev)) / pn
        prev = u_new
        conv = err < cfg.convergence_tol and it > 1
        jac_min = float(jnp.min(jacobian_det(u_new)))
        if not conv and jac_min < cfg.regrid_threshold:
            u_tot = compose(u_tot, u_new)
            d = derivatives(iref, warp2d(imov, u_tot))
            u_new = jnp.zeros_like(u_new)
            events.append(it)
        u_est = u_new
        if conv:
            break
    return compose(u_tot, u_est), it + 1, events


@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.999])
def test_fluid_regrid_count_matches_host_replay(threshold):
    from opticalflow2d_tpu.engine.registration import _solve_level

    iref, imov = make_pair(48, 40, shift=(2.5, -1.6))
    iref = jnp.asarray(iref, jnp.float32)
    imov = jnp.asarray(imov, jnp.float32)
    cfg = RegConfig(method=Method.FLUID, mu=0.25, lam=0.0, niter=(10,),
                    nscales=0, warp_halo=0, warp_halo_outer=0,
                    regrid_threshold=threshold)
    u, traces = _solve_level(jnp.zeros((2, 48, 40)), iref, imov, cfg, 10, 0)
    want_u, want_it, events = _replay_fluid_level(iref, imov, cfg, 10)
    assert int(traces[0].regrids) == len(events)
    assert int(traces[0].iterations) == want_it
    if threshold > 0.9:
        assert events, "setup failed to trigger a regrid"
    np.testing.assert_allclose(np.asarray(u), np.asarray(want_u),
                               rtol=1e-4, atol=1e-5)
