"""End-to-end parity against the C++ reference (compiled in place as the
oracle, see oracle/). Covers the five BASELINE.json workloads.

Bit-parity configs run with the compat flags on (maxabs bug, flat-wrap
convolution) and — for elastic/fluid — the exact lexicographic wavefront SOR.
The data-parallel red-black mode is validated separately at the
converged-quality level (same fixed point, different iterate path)."""

import numpy as np
import pytest

from conftest import make_pair
from oracle_utils import run_oracle, endpoint_error, ensure_oracle
from opticalflow2d_tpu import register, RegConfig, Method, CompatFlags

try:
    ensure_oracle()
    HAVE_ORACLE = True
except Exception:  # pragma: no cover
    HAVE_ORACLE = False

pytestmark = pytest.mark.skipif(not HAVE_ORACLE, reason="oracle build failed")

COMPAT = CompatFlags(maxabs_bug=True, conv_flatwrap=True)


@pytest.fixture(scope="module")
def pair():
    return make_pair(48, 40, shift=(1.5, -0.8))


def _run_both(pair, method, params, niter, nscales, nrefine=1, **cfg_kw):
    iref, imov = pair
    u_ref, war_ref = run_oracle(iref, imov, nscales, nrefine, int(method), params, niter)
    # warp_halo=0, warp_halo_outer=0: the roll fast path is numerically identical (covered by
    # test_warp.py equivalence tests); compiling both warp branches for every
    # parity config would dominate CI time.
    cfg_kw.setdefault("warp_halo", 0)
    cfg_kw.setdefault("warp_halo_outer", 0)
    # Bit-parity needs the monolithic single-program pyramid: the auto-halo
    # two-phase split changes float associativity by ~1 ulp.
    cfg_kw.setdefault("warp_halo_auto", False)
    cfg = RegConfig.from_regparams(method, niter, nscales, params, nrefine, **cfg_kw)
    res = register(iref, imov, cfg)
    u = np.asarray(res.motion, np.float64)
    return u, u_ref, res


# --- BASELINE config 1: Horn-Schunck, single resolution -------------------

def test_diffusion_single_resolution_bit_parity(pair):
    u, u_ref, res = _run_both(pair, Method.DIFFUSION, [0.5], [60], 0, compat=COMPAT)
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


def test_diffusion_pyramid_refine_bit_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.DIFFUSION, [0.5], [40, 20], 1, nrefine=2, compat=COMPAT
    )
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


# --- BASELINE config 2: curvature + elastic, multi-resolution pyramid -----

def test_curvature_pyramid_bit_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.CURVATURE, [0.1, 1.0], [40, 20], 1, nrefine=2, compat=COMPAT
    )
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 2e-4


def test_elastic_pyramid_lexicographic_bit_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.ELASTIC, [0.5, 0.0], [40, 20], 1,
        compat=COMPAT, sor_ordering="lexicographic",
    )
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


def test_elastic_redblack_converged_parity(pair):
    # Red-black SOR: same fixed point, different path — converged-quality
    # tolerance (SURVEY.md §7 hard parts #1).
    u, u_ref, res = _run_both(pair, Method.ELASTIC, [0.5, 0.0], [50, 25], 1, compat=COMPAT)
    assert endpoint_error(u, u_ref) < 0.02


# --- BASELINE config 3: Thirion demons ------------------------------------

@pytest.mark.parametrize("accum", [0, 1], ids=["composition", "addition"])
def test_thirions_demons_bit_parity(pair, accum):
    u, u_ref, res = _run_both(
        pair, Method.THIRIONS_DEMONS, [1.0, 0.25, 2.0, 2.0, 5, accum],
        [20, 10], 1, compat=COMPAT,
    )
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


# --- BASELINE config 4: diffeomorphic demons ------------------------------

def test_diffeomorphic_demons_bit_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.DIFFEOMORPHIC_DEMONS, [1.0, 0.25, 2.0, 2.0, 5],
        [20, 10], 1, compat=COMPAT,
    )
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


# --- BASELINE config 5: viscous fluid -------------------------------------

def test_fluid_lexicographic_bit_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.FLUID, [0.25, 0.0], [25, 25], 1,
        compat=COMPAT, sor_ordering="lexicographic",
    )
    # Trajectory is fully reproduced: same iteration counts, same regrids,
    # same timestep sequence (verified bit-level vs the oracle's prints).
    assert endpoint_error(u, u_ref) < 1e-4
    assert np.abs(u - u_ref).max() < 1e-3


def test_fluid_redblack_converged_quality(pair):
    # Red-black fluid follows a different (but valid) trajectory; assert
    # registration quality rather than trajectory parity.
    iref, imov = pair
    u_ref, war_ref = run_oracle(iref, imov, 1, 1, 5, [0.25, 0.0], [25, 25])
    cfg = RegConfig.from_regparams(
        Method.FLUID, [25, 25], 1, [0.25, 0.0], 1, compat=COMPAT, warp_halo=0, warp_halo_outer=0
    )
    res = register(iref, imov, cfg)
    from opticalflow2d_tpu.ops.warp import warp2d
    import jax.numpy as jnp

    war = np.asarray(warp2d(jnp.asarray(imov), res.motion))
    ssd0 = ((iref - imov) ** 2).sum()
    ssd_ours = ((iref - war) ** 2).sum()
    ssd_oracle = ((iref - war_ref) ** 2).sum()
    # At least as good a registration (within 25%) as the reference run.
    assert ssd_ours < ssd0 * 0.2
    assert ssd_ours < ssd_oracle * 1.25 + 1e-3


def test_fluid_multirefine_bit_parity(pair):
    # Exercises velocity persistence across refinement loops (the reference
    # solver's member state, OpticalFlowFluid velocity warm start).
    u, u_ref, res = _run_both(
        pair, Method.FLUID, [0.25, 0.0], [15, 15], 1, nrefine=2,
        compat=COMPAT, sor_ordering="lexicographic",
    )
    assert endpoint_error(u, u_ref) < 1e-4
    assert np.abs(u - u_ref).max() < 1e-3


def test_demons_multiscale_refine_bit_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.THIRIONS_DEMONS, [1.0, 0.25, 2.0, 2.0, 5, 0],
        [10, 8, 6], 2, nrefine=2, compat=COMPAT,
    )
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 2e-4


def test_odd_dims_pyramid_parity():
    # Odd, non-square dims through a truncating pyramid (dims 45/2 -> 22).
    iref, imov = make_pair(45, 37, shift=(1.2, -0.6))
    u_ref, _ = run_oracle(iref, imov, 1, 1, 0, [0.5], [30, 15])
    cfg = RegConfig.from_regparams(
        Method.DIFFUSION, [30, 15], 1, [0.5], 1, compat=COMPAT,
        warp_halo=0, warp_halo_outer=0,
    )
    res = register(iref, imov, cfg)
    assert endpoint_error(np.asarray(res.motion, np.float64), u_ref) < 1e-5


def test_elastic_three_param_omega_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.ELASTIC, [0.5, 0.1, 0.9], [30, 15], 1,
        compat=COMPAT, sor_ordering="lexicographic",
    )
    assert endpoint_error(u, u_ref) < 1e-5


def test_curvature_default_tau_parity(pair):
    # Single regparam: tau falls back to the constructor default 1.0
    # (OpticalFlowCurvature.h:10).
    u, u_ref, res = _run_both(pair, Method.CURVATURE, [0.1], [30, 15], 1, compat=COMPAT)
    assert endpoint_error(u, u_ref) < 1e-5


def test_demons_kernelwidth7_parity(pair):
    u, u_ref, res = _run_both(
        pair, Method.THIRIONS_DEMONS, [1.0, 0.25, 3.0, 1.5, 7, 0],
        [12, 8], 1, compat=COMPAT,
    )
    assert endpoint_error(u, u_ref) < 1e-5


def test_logger_error_trace_parity(pair):
    """Per-iteration Logger error values: parse the oracle's verbose
    'Iteration: k\tError:e' prints and compare against our carried trace."""
    import os
    import re
    import subprocess
    import tempfile

    import oracle_utils as ou

    iref, imov = pair
    nx, ny = iref.shape
    with tempfile.TemporaryDirectory() as td:
        paths = [os.path.join(td, n) for n in ("r", "m", "mo", "w")]
        ou._write_raw(paths[0], iref)
        ou._write_raw(paths[1], imov)
        env = dict(os.environ, OF2D_ORACLE_VERBOSE="1")
        proc = subprocess.run(
            [ou.ORACLE_BIN, *paths, str(nx), str(ny), "0", "1", "0", "1",
             "0.5", "25"],
            capture_output=True, env=env, timeout=300, check=True,
        )
    errs_ref = [
        float(m.group(1))
        for m in re.finditer(rb"Iteration: \d+\s+Error:([0-9.]+)", proc.stderr)
    ]
    assert len(errs_ref) > 3

    cfg = RegConfig.from_regparams(
        Method.DIFFUSION, [25], 0, [0.5], 1, compat=COMPAT,
        warp_halo=0, warp_halo_outer=0,
    )
    res = register(iref, imov, cfg)
    n = int(res.traces[0].iterations)
    ours = np.asarray(res.traces[0].errors)[:n]
    assert n == len(errs_ref)
    # The oracle prints %.4f — compare at print precision.
    np.testing.assert_allclose(ours, errs_ref, atol=6e-5)


def test_demons_flat_region_fixed_vs_oracle_crash():
    """On perfectly flat matched regions the reference's demons force
    divides by a zero denominator and vector2d::operator/ THROWS
    ("Divide by zero exception", coord2d.h:95) — in MATLAB the whole MEX
    call aborts. Our force defines the 0/0 limit as 0 (Demons force
    docstring); the registration returns a clean zero field instead of
    crashing. Document the intended divergence."""
    iref = np.full((24, 24), 0.5, np.float32)
    imov = np.full((24, 24), 0.5, np.float32)
    with pytest.raises(RuntimeError, match="Divide by zero"):
        run_oracle(iref, imov, 0, 1, 3, [1.0, 0.25, 2.0, 2.0, 5, 0], [5])
    cfg = RegConfig.from_regparams(
        Method.THIRIONS_DEMONS, [5], 0, [1.0, 0.25, 2.0, 2.0, 5, 0], 1,
        compat=COMPAT, warp_halo=0, warp_halo_outer=0,
    )
    res = register(iref, imov, cfg)
    assert np.isfinite(np.asarray(res.motion)).all()
    np.testing.assert_allclose(np.asarray(res.motion), 0.0, atol=1e-7)


# --- Demo-scale parity: the canonical test_opticalflow2d.m workload -------

@pytest.mark.slow
def test_demo_scale_fluid_parity():
    """The exact demo pipeline (/root/reference/test_opticalflow2d.m:14-38)
    at realistic size: min-max normalize a 256x256 image, replicate-pad 11
    rows on each x edge (-> 278x256), fluid with niter=[25 25], nscales=1,
    nrefine=1, regparams [0.25, 0.0]. DIR-Lab frames aren't shipped in the
    reference repo either, so the image content is the synthetic deformable
    pair; the pipeline (normalize/pad/config) is the demo's."""
    rng = np.random.default_rng(5)
    base_ref, base_mov = make_pair(256, 256, shift=(2.5, -1.5))
    # Add texture so min-max normalization and the fluid forces see
    # realistic dynamic range (pure Gaussians are too smooth at 256^2).
    noise = rng.standard_normal((256, 256)).astype(np.float32) * 0.02
    base_ref = base_ref + noise
    base_mov = base_mov + noise

    def normalize(a):
        return (a - a.min()) / (a.max() - a.min())

    def pad11(a):
        return np.pad(a, ((11, 11), (0, 0)), mode="edge")

    iref = pad11(normalize(base_ref)).astype(np.float32)
    imov = pad11(normalize(base_mov)).astype(np.float32)
    assert iref.shape == (278, 256)

    u_ref, war_ref = run_oracle(
        iref, imov, 1, 1, int(Method.FLUID), [0.25, 0.0], [25, 25],
        timeout=1800.0,
    )
    cfg = RegConfig.from_regparams(
        Method.FLUID, [25, 25], 1, [0.25, 0.0], 1,
        compat=COMPAT, sor_ordering="lexicographic",
        warp_halo=0, warp_halo_outer=0,
    )
    res = register(iref, imov, cfg)
    u = np.asarray(res.motion, np.float64)
    assert endpoint_error(u, u_ref) < 1e-4
    assert np.abs(u - u_ref).max() < 1e-2


# --- Repeated-register warm continuation (persistent MEX state) ------------

def test_repeated_register_bit_parity(pair):
    """A second register call on a persistent session continues from the
    stale coarsest-level field, exactly as the reference MEX object does
    (ImageRegistration.cpp:137-139 skips the coarsest downsample;
    WrapperOpticalFlow2d.cpp:86-102 keeps the object alive)."""
    from opticalflow2d_tpu import OpticalFlow2d

    iref, imov = pair
    iref2, imov2 = make_pair(48, 40, shift=(-0.9, 1.1))
    u_ref, _ = run_oracle(iref, imov, 1, 2, int(Method.DIFFUSION), [0.5],
                          [40, 20], pair2=(iref2, imov2))

    sess = OpticalFlow2d(
        (48, 40), [40, 20], 1, Method.DIFFUSION, [0.5], nrefine=2,
        compat=CompatFlags(maxabs_bug=True, conv_flatwrap=True,
                           persistent_motion=True),
        warp_halo=0, warp_halo_outer=0,
    )
    sess.register(iref, imov)
    res2 = sess.register(iref2, imov2)
    u = np.asarray(res2.motion, np.float64)
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


def test_repeated_register_single_scale_bit_parity(pair):
    """nscales=0: the full-resolution field itself carries across register
    calls (the coarsest level IS motion[0])."""
    from opticalflow2d_tpu import OpticalFlow2d

    iref, imov = pair
    iref2, imov2 = make_pair(48, 40, shift=(-0.9, 1.1))
    u_ref, _ = run_oracle(iref, imov, 0, 1, int(Method.THIRIONS_DEMONS),
                          [1.0, 0.25, 2.0, 2.0, 5, 0], [15],
                          pair2=(iref2, imov2))

    sess = OpticalFlow2d(
        (48, 40), [15], 0, Method.THIRIONS_DEMONS,
        [1.0, 0.25, 2.0, 2.0, 5, 0],
        compat=CompatFlags(maxabs_bug=True, conv_flatwrap=True,
                           persistent_motion=True),
        warp_halo=0, warp_halo_outer=0,
    )
    sess.register(iref, imov)
    res2 = sess.register(iref2, imov2)
    u = np.asarray(res2.motion, np.float64)
    assert endpoint_error(u, u_ref) < 1e-5
    assert np.abs(u - u_ref).max() < 1e-4


def test_repeated_register_off_by_default(pair):
    """Without persistent_motion a second register is independent: it must
    equal a fresh session's result on the same pair."""
    from opticalflow2d_tpu import OpticalFlow2d

    iref, imov = pair
    iref2, imov2 = make_pair(48, 40, shift=(-0.9, 1.1))
    kw = dict(warp_halo=0, warp_halo_outer=0)
    sess = OpticalFlow2d((48, 40), [20, 10], 1, Method.DIFFUSION, [0.5], **kw)
    sess.register(iref, imov)
    res2 = sess.register(iref2, imov2)
    fresh = OpticalFlow2d((48, 40), [20, 10], 1, Method.DIFFUSION, [0.5], **kw)
    resf = fresh.register(iref2, imov2)
    np.testing.assert_array_equal(np.asarray(res2.motion),
                                  np.asarray(resf.motion))
