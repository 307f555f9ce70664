"""Engine-level behavior tests: convergence semantics, property tests,
session API — the test strategy SURVEY.md §4/§7 prescribes (the reference
itself has none)."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import make_pair
from opticalflow2d_tpu import (
    register,
    RegConfig,
    Method,
    OpticalFlow2d,
    CompatFlags,
)
from opticalflow2d_tpu.ops.warp import warp2d
from opticalflow2d_tpu.ops.grid import jacobian_det


# warp_halo=0, warp_halo_outer=0 keeps CI compile time down (the roll fast path is covered by
# dedicated equivalence tests in test_warp.py and one default-config test
# below).
ALL_METHODS = [
    (Method.DIFFUSION, dict(alpha=0.5, warp_halo=0, warp_halo_outer=0)),
    (Method.CURVATURE, dict(alpha=0.1, tau=1.0, warp_halo=0, warp_halo_outer=0)),
    (Method.ELASTIC, dict(mu=0.5, lam=0.0, warp_halo=0, warp_halo_outer=0)),
    (Method.THIRIONS_DEMONS, dict(warp_halo=0, warp_halo_outer=0)),
    (Method.DIFFEOMORPHIC_DEMONS, dict(warp_halo=0, warp_halo_outer=0)),
    (Method.FLUID, dict(mu=0.25, lam=0.0, warp_halo=0, warp_halo_outer=0)),
]


@pytest.mark.parametrize("method,kw", ALL_METHODS, ids=[m.name for m, _ in ALL_METHODS])
def test_identical_images_give_zero_motion(method, kw):
    iref, _ = make_pair(32, 28)
    cfg = RegConfig(method=method, niter=(10, 5), nscales=1, **kw)
    res = register(iref, iref, cfg)
    np.testing.assert_allclose(np.asarray(res.motion), 0.0, atol=1e-5)


@pytest.mark.parametrize("method,kw", ALL_METHODS, ids=[m.name for m, _ in ALL_METHODS])
def test_ssd_reduction_on_translated_pair(method, kw):
    iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
    cfg = RegConfig(method=method, niter=(60, 30), nscales=1, **kw)
    res = register(iref, imov, cfg)
    war = np.asarray(warp2d(jnp.asarray(imov), res.motion))
    ssd0 = ((iref - imov) ** 2).sum()
    ssd1 = ((iref - war) ** 2).sum()
    assert np.isfinite(np.asarray(res.motion)).all()
    assert ssd1 < 0.7 * ssd0, f"{method.name}: ssd {ssd0} -> {ssd1}"


def test_translation_recovery_demons():
    # Runs with the DEFAULT config (warp_halo fast path included) so the
    # production path gets end-to-end coverage.
    iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(80, 40), nscales=1)
    res = register(iref, imov, cfg)
    u = np.asarray(res.motion)
    # interior mean displacement should approximate the true shift
    interior = u[:, 12:-12, 12:-12]
    assert abs(interior[0].mean() - 1.5) < 0.4
    assert abs(interior[1].mean() - (-0.8)) < 0.4


def test_diffeomorphic_demons_positive_jacobian():
    iref, imov = make_pair(48, 40, shift=(2.5, -1.5))
    cfg = RegConfig(
        method=Method.DIFFEOMORPHIC_DEMONS, niter=(60, 30), nscales=1, warp_halo=0, warp_halo_outer=0
    )
    res = register(iref, imov, cfg)
    jac = np.asarray(jacobian_det(res.motion))
    # Away from the boundary bands (where renormalized warping/smoothing can
    # fold), the composed field stays orientation-preserving.
    assert (jac[5:-5, 5:-5] > 0).mean() > 0.99


def test_early_stop_semantics():
    # Identical images: update is 0 from iteration 0, so err stays 0 and the
    # reference gate (err < tol AND iter > 1) stops at exactly 3 iterations.
    iref, _ = make_pair(32, 28)
    cfg = RegConfig(method=Method.DIFFUSION, niter=(50,), nscales=0, alpha=0.5)
    res = register(iref, iref, cfg)
    assert int(res.traces[0].iterations) == 3


def test_niter_cap_respected():
    iref, imov = make_pair(32, 28, shift=(1.0, 0.5))
    cfg = RegConfig(method=Method.DIFFUSION, niter=(7,), nscales=0, alpha=0.5)
    res = register(iref, imov, cfg)
    assert int(res.traces[0].iterations) <= 7


def test_traces_shape_and_order():
    iref, imov = make_pair(32, 28, shift=(1.0, 0.5))
    cfg = RegConfig(
        method=Method.DIFFUSION, niter=(5, 4, 3), nscales=2, nrefine=2, alpha=0.5
    )
    res = register(iref, imov, cfg)
    assert len(res.traces) == 3 * 2  # (nscales+1) levels x nrefine
    scales = [int(t.scale) for t in res.traces]
    assert scales == [2, 2, 1, 1, 0, 0]  # coarse -> fine, refine-major


def test_nonsquare_and_odd_dims():
    iref, imov = make_pair(37, 51, shift=(1.0, -0.5))
    cfg = RegConfig(method=Method.FLUID, niter=(10, 5), nscales=1, mu=0.25, warp_halo=0, warp_halo_outer=0)
    res = register(iref, imov, cfg)
    assert res.motion.shape == (2, 37, 51)
    assert np.isfinite(np.asarray(res.motion)).all()


def test_dtype_bfloat16_runs():
    iref, imov = make_pair(32, 28, shift=(1.0, 0.5))
    cfg = RegConfig(
        method=Method.DIFFUSION, niter=(10,), nscales=0, alpha=0.5, dtype="bfloat16"
    )
    res = register(iref, imov, cfg)
    assert res.motion.dtype == jnp.bfloat16
    assert np.isfinite(np.asarray(res.motion, dtype=np.float32)).all()


class TestSession:
    def test_full_mex_surface(self):
        iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
        sess = OpticalFlow2d(
            (48, 40), niter=[25, 25], nscales=1, regularisation=5,
            regparams=[0.25, 0.0], nrefine=1,
        )
        sess.register(iref, imov)
        u = sess.get_motion()
        assert u.shape == (48, 40, 2)
        ireg = sess.warp(imov)
        assert ireg.shape == (48, 40)
        assert ((iref - ireg) ** 2).sum() < ((iref - imov) ** 2).sum()
        sess.close()
        with pytest.raises(RuntimeError):
            sess.get_motion()

    def test_matches_functional_api(self):
        iref, imov = make_pair(32, 28, shift=(1.0, 0.5))
        sess = OpticalFlow2d(
            (32, 28), niter=[10, 5], nscales=1, regularisation=Method.DIFFUSION,
            regparams=[0.5],
        )
        sess.register(iref, imov)
        cfg = RegConfig.from_regparams(Method.DIFFUSION, [10, 5], 1, [0.5])
        res = register(iref, imov, cfg)
        np.testing.assert_allclose(
            sess.get_motion(), np.moveaxis(np.asarray(res.motion), 0, -1)
        )

    def test_demons_param_packing(self):
        sess = OpticalFlow2d(
            (32, 28), [5, 5], 1, Method.THIRIONS_DEMONS,
            [1.0, 0.25, 2.0, 2.0, 5.7, 1.0],
        )
        # kernelwidth truncated from float (reference behavior), accumulation
        # cast from float
        assert sess.config.kernelwidth == 5
        assert sess.config.accumulation == 1


def test_compat_flags_change_results():
    iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
    base = RegConfig(method=Method.FLUID, niter=(15, 10), nscales=1, mu=0.25, warp_halo=0, warp_halo_outer=0)
    bug = RegConfig(
        method=Method.FLUID, niter=(15, 10), nscales=1, mu=0.25, warp_halo=0, warp_halo_outer=0,
        compat=CompatFlags(maxabs_bug=True),
    )
    u_a = np.asarray(register(iref, imov, base).motion)
    u_b = np.asarray(register(iref, imov, bug).motion)
    # The maxabs bug changes the adaptive timestep sequence.
    assert not np.allclose(u_a, u_b)


def test_too_deep_pyramid_raises():
    iref, imov = make_pair(32, 28)
    cfg = RegConfig(method=Method.DIFFUSION, niter=(5,) * 5, nscales=4, alpha=0.5)
    with pytest.raises(ValueError, match="coarsest level"):
        register(iref, imov, cfg)


def test_warm_start_resume_matches_continued_session():
    # A warm-started registration from a checkpointed field should improve
    # on the checkpoint (and the warm start must be accepted by the jit).
    iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
    cfg = RegConfig(method=Method.DIFFUSION, niter=(15, 10), nscales=1,
                    alpha=0.5, warp_halo=0, warp_halo_outer=0)
    first = register(iref, imov, cfg)
    resumed = register(iref, imov, cfg, initial_motion=first.motion)
    from opticalflow2d_tpu.metrics import warped_ssd

    s_first = float(warped_ssd(jnp.asarray(iref), jnp.asarray(imov), first.motion))
    s_resumed = float(warped_ssd(jnp.asarray(iref), jnp.asarray(imov), resumed.motion))
    assert s_resumed <= s_first * 1.01


def test_metrics_module():
    from opticalflow2d_tpu.metrics import endpoint_error, ssd_reduction

    iref, imov = make_pair(48, 40, shift=(1.5, -0.8))
    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(40, 20), nscales=1,
                    warp_halo=0, warp_halo_outer=0)
    res = register(iref, imov, cfg)
    assert float(ssd_reduction(jnp.asarray(iref), jnp.asarray(imov), res.motion)) > 0.8
    assert float(endpoint_error(res.motion, res.motion)) == 0.0


@pytest.mark.parametrize("shape", [(4, 4), (5, 7), (8, 5)])
def test_tiny_images_do_not_crash(shape):
    rng = np.random.default_rng(1)
    iref = rng.standard_normal(shape).astype(np.float32)
    imov = rng.standard_normal(shape).astype(np.float32)
    for method, kw in [(Method.DIFFUSION, dict(alpha=0.5)),
                       (Method.FLUID, dict(mu=0.25))]:
        cfg = RegConfig(method=method, niter=(5,), nscales=0, warp_halo=0, warp_halo_outer=0, **kw)
        res = register(iref, imov, cfg)
        assert np.isfinite(np.asarray(res.motion)).all()


def test_session_verbose_output(capsys):
    iref, imov = make_pair(32, 28, shift=(1.0, 0.5))
    sess = OpticalFlow2d(
        (32, 28), niter=[5, 5], nscales=1, regularisation=Method.DIFFUSION,
        regparams=[0.5], verbose=True,
    )
    sess.register(iref, imov)
    out = capsys.readouterr().out
    # The parameter banner and per-scale convergence summaries
    # (the Logger/display_registration_parameters analogues).
    assert "regularisation:  DIFFUSION" in out
    # Regularisation parameters in the banner
    # (ImageRegistration.cpp:6-47 analogue).
    assert "alpha:           0.5" in out
    assert "scale 1:" in out and "scale 0:" in out
    # Live per-iteration stream (Logger.cpp:62-79 analogue): verbose turns
    # on jax.debug.callback streaming inside the while_loop.
    assert "[scale 1] iteration 1:" in out
    assert "[scale 0] iteration 1:" in out


def test_session_verbose_stream_opt_out(capsys):
    iref, imov = make_pair(32, 28, shift=(1.0, 0.5))
    sess = OpticalFlow2d(
        (32, 28), niter=[5], nscales=0, regularisation=Method.DIFFUSION,
        regparams=[0.5], verbose=True, verbose_stream=False,
    )
    assert sess.config.verbose_stream is False
    sess.register(iref, imov)
    out = capsys.readouterr().out
    assert "iteration 1:" not in out  # summary only, no live stream
    assert "scale 0:" in out


def test_demons_banner_params(capsys):
    OpticalFlow2d(
        (32, 28), [5], 0, Method.THIRIONS_DEMONS,
        [1.0, 0.25, 2.0, 2.0, 5.0, 0.0], verbose=True,
    )
    out = capsys.readouterr().out
    assert "sigma_i:         1.0" in out
    assert "kernelwidth:     5" in out
    assert "accumulation:    COMPOSITION" in out


# --- Halo automation + fallback visibility ---------------------------------

def test_demons_trace_counts_halo_fallbacks():
    """An undersized warp_halo must be visible in LevelTrace.fallbacks
    instead of silently hitting the exact-gather path every iteration."""
    from conftest import make_pair

    # The per-level estimate starts at zero and accumulates ~sigma_x/(2
    # sigma_i) per iteration, so it needs enough iterations to outgrow the
    # undersized halo.
    iref, imov = make_pair(48, 40, shift=(3.5, -2.8))  # |u| ~> 3 pixels
    small = RegConfig(method=Method.THIRIONS_DEMONS, niter=(60,), nscales=0,
                      warp_halo=1, warp_halo_outer=4, convergence_tol=0.0)
    big = RegConfig(method=Method.THIRIONS_DEMONS, niter=(60,), nscales=0,
                    warp_halo=4, warp_halo_outer=4, convergence_tol=0.0)
    res_small = register(iref, imov, small)
    res_big = register(iref, imov, big)
    assert int(res_small.traces[-1].fallbacks) > 0
    assert int(res_big.traces[-1].fallbacks) == 0
    # Fallbacks change the code path, never the values.
    np.testing.assert_allclose(np.asarray(res_small.motion),
                               np.asarray(res_big.motion),
                               rtol=1e-6, atol=1e-7)


def test_register_warp_halo_auto_matches_fixed():
    """warp_halo_auto: two-phase split with a fitted fine-level halo must
    reproduce the monolithic run (level-boundary splits are ~1 ulp) and
    leave no fine-level fallbacks."""
    from conftest import make_pair

    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))
    auto = RegConfig(method=Method.THIRIONS_DEMONS, niter=(10, 6), nscales=1,
                     warp_halo_auto=True)
    res_auto = register(iref, imov, auto)

    fixed = RegConfig(method=Method.THIRIONS_DEMONS, niter=(10, 6), nscales=1)
    res_fixed = register(iref, imov, fixed)

    np.testing.assert_allclose(np.asarray(res_auto.motion),
                               np.asarray(res_fixed.motion),
                               rtol=1e-4, atol=1e-6)
    # Same level structure, and the fitted fine level never fell back.
    assert len(res_auto.traces) == len(res_fixed.traces)
    assert int(res_auto.traces[-1].fallbacks) == 0


@pytest.mark.parametrize("method,kw", ALL_METHODS)
def test_register_phased_matches_register(method, kw):
    """register_phased (host-phased programs for huge grids) must match
    the monolithic driver: same level flow split at resample/level
    boundaries — the checkpoint-resume property, ~1 ulp."""
    from opticalflow2d_tpu.engine.registration import register_phased

    iref, imov = make_pair(48, 40, shift=(1.2, -0.7))
    cfg = RegConfig(method=method, niter=(8, 6), nscales=1, **kw)
    a = register(iref, imov, cfg)
    b = register_phased(iref, imov, cfg)
    np.testing.assert_allclose(
        np.asarray(b.motion), np.asarray(a.motion), rtol=1e-5, atol=1e-6
    )
    assert [int(t.iterations) for t in a.traces] == [
        int(t.iterations) for t in b.traces
    ]
    np.testing.assert_allclose(
        np.asarray(b.coarse_motion), np.asarray(a.coarse_motion),
        rtol=1e-5, atol=1e-6,
    )


def test_register_phased_auto_halo_and_warm_start():
    from opticalflow2d_tpu.engine.registration import register_phased

    iref, imov = make_pair(64, 48, shift=(2.0, -1.0))
    cfg = RegConfig(method=Method.DIFFUSION, alpha=0.5, niter=(10, 8),
                    nscales=1, warp_halo_auto=True)
    a = register(iref, imov, cfg)
    b = register_phased(iref, imov, cfg)
    np.testing.assert_allclose(
        np.asarray(b.motion), np.asarray(a.motion), rtol=1e-5, atol=1e-6
    )
    # Warm start seeds the pyramid identically.
    a2 = register(iref, imov, cfg, initial_motion=a.motion)
    b2 = register_phased(iref, imov, cfg, initial_motion=a.motion)
    np.testing.assert_allclose(
        np.asarray(b2.motion), np.asarray(a2.motion), rtol=1e-5, atol=1e-6
    )


# --------------------------------------------------------------------------
# Host-stepped level driver, exp map, warm phased continuation
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method,kw", ALL_METHODS,
                         ids=[m.name for m, _ in ALL_METHODS])
def test_stepped_level_matches_monolithic(method, kw):
    """_solve_level_stepped (the huge-grid host-stepped driver: one
    program per iteration, Logger/regrid control on the host) must
    reproduce the monolithic level solve for every family — same fields,
    iteration counts, error traces, regrid events."""
    from opticalflow2d_tpu.engine.registration import (
        _solve_level,
        _solve_level_stepped,
    )

    iref, imov = make_pair(48, 40, shift=(2.2, -1.4))
    iref = jnp.asarray(iref, jnp.float32)
    imov = jnp.asarray(imov, jnp.float32)
    cfg = RegConfig(method=method, niter=(8,), nscales=0, nrefine=2, **kw)
    u0 = jnp.zeros((2, 48, 40), jnp.float32)
    ua, ta = _solve_level(u0, iref, imov, cfg, 8, 0)
    ub, tb = _solve_level_stepped(u0, iref, imov, cfg, 8, 0)
    # rtol 2e-4: the stepped fluid/curvature iterations are split into
    # multiple programs (device memory at 16384^2), and the program
    # boundary changes FMA contraction vs the monolithic fusion — a few
    # elements drift at the 1e-5..1e-4 relative level (association only;
    # iteration counts and regrid events must still match exactly).
    np.testing.assert_allclose(np.asarray(ub), np.asarray(ua),
                               rtol=2e-4, atol=1e-6)
    assert len(ta) == len(tb) == cfg.nrefine
    for x, y in zip(ta, tb):
        assert int(x.iterations) == int(y.iterations)
        assert int(x.regrids) == int(y.regrids)
        np.testing.assert_allclose(np.asarray(y.errors), np.asarray(x.errors),
                                   rtol=1e-4, atol=1e-6)


def test_stepped_fluid_regrid_events_match():
    """Force regridding (threshold above 1 fires the predicate on any
    contracting estimate) and pin that the host-boundary regrid of the
    stepped driver reproduces the in-loop lax.cond regrid exactly."""
    from opticalflow2d_tpu.engine.registration import (
        _solve_level,
        _solve_level_stepped,
    )

    iref, imov = make_pair(48, 40, shift=(2.5, -1.6))
    iref = jnp.asarray(iref, jnp.float32)
    imov = jnp.asarray(imov, jnp.float32)
    cfg = RegConfig(method=Method.FLUID, mu=0.25, lam=0.0, niter=(8,),
                    nscales=0, warp_halo=0, warp_halo_outer=0,
                    regrid_threshold=0.999)
    u0 = jnp.zeros((2, 48, 40), jnp.float32)
    ua, ta = _solve_level(u0, iref, imov, cfg, 8, 0)
    ub, tb = _solve_level_stepped(u0, iref, imov, cfg, 8, 0)
    assert int(ta[0].regrids) > 0, "setup failed to trigger a regrid"
    assert int(tb[0].regrids) == int(ta[0].regrids)
    assert int(tb[0].iterations) == int(ta[0].iterations)
    np.testing.assert_allclose(np.asarray(ub), np.asarray(ua),
                               rtol=1e-5, atol=1e-6)


def test_expmap_static_nsq():
    """The exp map's squaring count (ops.warp.expmap): a field whose max
    magnitude is <= 0.5 takes no squaring and comes back bit-identical
    (the reference's nsquares == 0 early return, Motion.cpp:257-260);
    one in (0.5, 1] takes exactly one, i.e. equals compose(u/2, u/2)."""
    from opticalflow2d_tpu.ops.warp import compose, expmap

    # maxabs is the max per-pixel MAGNITUDE (ops.reduce.motion_maxabs),
    # so the bounds below are magnitude bounds.
    rng = np.random.default_rng(7)

    def bounded_field(lo, hi):
        ang = rng.uniform(0, 2 * np.pi, (24, 20))
        mag = rng.uniform(lo, hi, (24, 20))
        return jnp.asarray(
            np.stack([mag * np.cos(ang), mag * np.sin(ang)]), jnp.float32)

    small = bounded_field(0.0, 0.45)
    np.testing.assert_array_equal(
        np.asarray(expmap(small)), np.asarray(small))

    big = bounded_field(0.55, 0.95)
    assert 0.5 < float(jnp.max(jnp.sqrt(big[0] ** 2 + big[1] ** 2))) <= 1.0
    half = big * 0.5
    np.testing.assert_allclose(
        np.asarray(expmap(big)), np.asarray(compose(half, half)),
        rtol=1e-6, atol=1e-7)


def test_register_phased_warm_coarse_matches_register():
    """register_phased(initial_coarse_motion=...) — the reference's
    repeated-register continuation on the phased driver (
    WrapperOpticalFlow2d.cpp:86-102) — must match the monolithic warm
    path and discriminate from a cold run."""
    from opticalflow2d_tpu.engine.registration import register_phased

    iref, imov = make_pair(64, 48, shift=(1.5, -0.9))
    cfg = RegConfig(method=Method.DIFFUSION, alpha=0.5, niter=(6, 4),
                    nscales=1, warp_halo=0, warp_halo_outer=0,
                    warp_halo_auto=False)
    first = register(iref, imov, cfg)
    warm_m = register(iref, imov, cfg,
                      initial_coarse_motion=first.coarse_motion)
    warm_p = register_phased(iref, imov, cfg,
                             initial_coarse_motion=first.coarse_motion)
    np.testing.assert_allclose(np.asarray(warm_p.motion),
                               np.asarray(warm_m.motion),
                               rtol=1e-5, atol=1e-6)
    cold = register_phased(iref, imov, cfg)
    assert not np.allclose(np.asarray(warm_p.motion),
                           np.asarray(cold.motion), atol=1e-4), \
        "warm continuation must differ from a cold run"
    with pytest.raises(ValueError, match="mutually exclusive"):
        register_phased(iref, imov, cfg, initial_motion=first.motion,
                        initial_coarse_motion=first.coarse_motion)
    with pytest.raises(ValueError, match="coarsest level"):
        register_phased(iref, imov, cfg,
                        initial_coarse_motion=first.motion)


def test_session_persistent_motion_huge_grid():
    """A persistent_motion session on a >8192 grid must route BOTH the
    cold and the warm register() through the phased driver and reproduce
    the reference's warm-continuation semantics."""
    nx, ny = 8256, 24  # extent > 8192 trips the phased dispatch; thin keeps CPU cost trivial
    iref, imov = make_pair(nx, ny, shift=(1.0, 0.5))
    sess = OpticalFlow2d(
        (nx, ny), (2, 2), 1, Method.DIFFUSION, [0.5],
        compat=CompatFlags(persistent_motion=True),
        warp_halo=0, warp_halo_outer=0, warp_halo_auto=False,
    )
    sess.register(iref, imov)
    m1 = sess.get_motion()
    sess.register(iref, imov)
    m2 = sess.get_motion()
    assert not np.allclose(m1, m2, atol=1e-6), \
        "second call must continue, not repeat"

    cfg = sess.config
    mono1 = register(iref, imov, cfg)
    mono2 = register(iref, imov, cfg,
                     initial_coarse_motion=mono1.coarse_motion)
    np.testing.assert_allclose(
        m2, np.moveaxis(np.asarray(mono2.motion), 0, -1),
        rtol=1e-5, atol=1e-6)


def test_phased_huge_extent_stepped_families_cpu():
    """Thin >8192-extent grids drive the stepped-dispatch families
    (fluid / diffeomorphic demons) end-to-end on CPU."""
    from opticalflow2d_tpu.engine.registration import register_phased

    nx, ny = 8224, 16
    iref, imov = make_pair(nx, ny, shift=(1.0, 0.4))
    for method, kw in [
        (Method.FLUID, dict(mu=0.25, lam=0.0)),
        (Method.DIFFEOMORPHIC_DEMONS, {}),
    ]:
        cfg = RegConfig(method=method, niter=(2, 2), nscales=1,
                        warp_halo=0, warp_halo_outer=0,
                        warp_halo_auto=False, **kw)
        res = register_phased(iref, imov, cfg)
        assert np.isfinite(np.asarray(res.motion)).all(), method
        assert res.motion.shape == (2, nx, ny)


def test_diffeo_identity_regime_equals_thirion_composition():
    """With |smoothed force| <= sigma_x/(2 sigma_i) <= 0.5 the exp map is
    the identity for every field (the reference's nsquares == 0 early
    return, Motion.cpp:257-260), so diffeomorphic demons IS Thirion with
    COMPOSITION accumulation. Pinned bitwise."""
    from opticalflow2d_tpu.config import MotionAccumulation
    from opticalflow2d_tpu.solvers.demons import make_demons_step

    iref, imov = make_pair(48, 40, shift=(1.8, -1.1))
    iref = jnp.asarray(iref, jnp.float32)
    imov = jnp.asarray(imov, jnp.float32)
    kw = dict(sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0,
              sigma_fluid=2.0, kernelwidth=5, warp_halo=0)
    step_d = make_demons_step(diffeomorphic=True,
                              accumulation=MotionAccumulation.ADDITION, **kw)
    step_t = make_demons_step(diffeomorphic=False,
                              accumulation=MotionAccumulation.COMPOSITION,
                              **kw)
    u = jnp.zeros((2, 48, 40), jnp.float32)
    for _ in range(5):
        ud = step_d(u, iref, imov)
        ut = step_t(u, iref, imov)
        np.testing.assert_array_equal(np.asarray(ud), np.asarray(ut))
        u = ud
