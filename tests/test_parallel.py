"""Parallel-layer tests on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import make_pair
from opticalflow2d_tpu import register, RegConfig, Method
from opticalflow2d_tpu.parallel.mesh import make_mesh
from opticalflow2d_tpu.parallel.batch import register_batch
from opticalflow2d_tpu.parallel.spatial import (
    register_sharded,
    make_diffusion_sweeps_sharded,
)
from opticalflow2d_tpu.solvers.base import derivatives
from opticalflow2d_tpu.solvers.diffusion import diffusion_step


requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _batch_pairs(b=4, nx=32, ny=32):
    irefs, imovs = [], []
    for k in range(b):
        r, m = make_pair(nx, ny, shift=(1.0 + 0.2 * k, -0.5 + 0.1 * k))
        irefs.append(r)
        imovs.append(m)
    return np.stack(irefs), np.stack(imovs)


CFG = RegConfig(method=Method.DIFFUSION, niter=(20, 10), nscales=1, alpha=0.5, warp_halo=0, warp_halo_outer=0)


def test_register_batch_matches_serial():
    irefs, imovs = _batch_pairs(3)
    res = register_batch(irefs, imovs, CFG)
    assert res.motion.shape == (3, 2, 32, 32)
    for k in range(3):
        serial = register(irefs[k], imovs[k], CFG)
        np.testing.assert_allclose(
            np.asarray(res.motion[k]), np.asarray(serial.motion), rtol=2e-4, atol=1e-5
        )


def test_register_batch_vmap_forces_jnp_kernels():
    """The vmapped path runs the plain jnp kernels (the only kernels there
    are) and matches the serial driver; an explicit impl wins over the
    auto rule, which keys on cond-heavy methods alone."""
    from opticalflow2d_tpu.parallel.batch import _resolve_impl

    assert _resolve_impl(CFG, "auto") == "vmap"
    cfg_fl = dataclasses.replace(CFG, method=Method.FLUID, mu=0.25,
                                 lam=0.0, warp_halo=2)
    assert _resolve_impl(cfg_fl, "auto") == "map"
    assert _resolve_impl(cfg_fl, "vmap") == "vmap"  # explicit wins

    irefs, imovs = _batch_pairs(2)
    res = register_batch(irefs, imovs, CFG, impl="vmap")
    serial = register(irefs[0], imovs[0], CFG)
    np.testing.assert_allclose(
        np.asarray(res.motion[0]), np.asarray(serial.motion),
        rtol=2e-4, atol=1e-5,
    )


@requires_8
def test_register_batch_sharded_on_mesh():
    mesh = make_mesh(data=4, x=2)
    irefs, imovs = _batch_pairs(8)
    res = register_batch(irefs, imovs, CFG, mesh=mesh)
    serial = register(irefs[0], imovs[0], CFG)
    np.testing.assert_allclose(
        np.asarray(res.motion[0]), np.asarray(serial.motion), rtol=2e-4, atol=1e-5
    )


@requires_8
def test_register_sharded_matches_serial():
    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))
    cfg = RegConfig(method=Method.FLUID, niter=(10, 5), nscales=1, mu=0.25, lam=0.0, warp_halo=0, warp_halo_outer=0)
    res_sharded = register_sharded(iref, imov, cfg, mesh)
    res_serial = register(iref, imov, cfg)
    np.testing.assert_allclose(
        np.asarray(res_sharded.motion), np.asarray(res_serial.motion),
        rtol=1e-4, atol=1e-5,
    )


@requires_8
def test_diffusion_sweeps_sharded_matches_serial():
    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 40, shift=(1.5, -0.8))
    d = derivatives(jnp.asarray(iref), jnp.asarray(imov))

    sweeps = make_diffusion_sweeps_sharded(mesh, alpha=0.5, niter=15)
    u_sharded = sweeps(jnp.zeros((2, 64, 40)), d.grad_i, d.it)

    u = jnp.zeros((2, 64, 40))
    for _ in range(15):
        u = diffusion_step(u, d, 0.5)

    np.testing.assert_allclose(
        np.asarray(u_sharded), np.asarray(u), rtol=1e-5, atol=1e-6
    )


@requires_8
def test_distributed_dct_matches_serial():
    from opticalflow2d_tpu.parallel.dct_dist import make_dct2_sharded
    from opticalflow2d_tpu.ops.dct import dct2_fftw, idct2_fftw

    mesh = make_mesh(data=1, x=8)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((64, 48)).astype(np.float32)

    fwd = jax.jit(make_dct2_sharded(mesh, 64, 48))
    inv = jax.jit(make_dct2_sharded(mesh, 64, 48, inverse=True))
    np.testing.assert_allclose(
        np.asarray(fwd(jnp.asarray(a))), np.asarray(dct2_fftw(jnp.asarray(a))),
        rtol=1e-4, atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(inv(jnp.asarray(a))), np.asarray(idct2_fftw(jnp.asarray(a))),
        rtol=1e-4, atol=1e-3,
    )


@requires_8
def test_curvature_step_sharded_matches_serial():
    from opticalflow2d_tpu.parallel.dct_dist import make_curvature_step_sharded
    from opticalflow2d_tpu.solvers.curvature import make_curvature_step

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))
    d = derivatives(jnp.asarray(iref), jnp.asarray(imov))
    u = jnp.zeros((2, 64, 48))

    sharded = jax.jit(make_curvature_step_sharded(mesh, 64, 48, 0.1, 1.0))
    serial = make_curvature_step(64, 48, 0.1, 1.0)

    u_a, u_b = u, u
    for _ in range(5):
        u_a = sharded(u_a, d.grad_i, d.it)
        u_b = serial(u_b, d)
    np.testing.assert_allclose(
        np.asarray(u_a), np.asarray(u_b), rtol=1e-4, atol=1e-5
    )


def test_register_batch_map_impl_matches_vmap():
    irefs, imovs = _batch_pairs(3)
    cfg_fluid = RegConfig(
        method=Method.FLUID, niter=(10, 5), nscales=1, mu=0.25, lam=0.0
    )
    res_map = register_batch(irefs, imovs, cfg_fluid, impl="map")
    res_vmap = register_batch(irefs, imovs, cfg_fluid, impl="vmap")
    np.testing.assert_allclose(
        np.asarray(res_map.motion), np.asarray(res_vmap.motion),
        rtol=1e-4, atol=1e-5,
    )


@requires_8
def test_register_batch_map_impl_on_mesh():
    mesh = make_mesh(data=4, x=1)
    irefs, imovs = _batch_pairs(4)
    cfg_fluid = RegConfig(
        method=Method.FLUID, niter=(10, 5), nscales=1, mu=0.25, lam=0.0
    )
    res = register_batch(irefs, imovs, cfg_fluid, mesh=mesh, impl="map")
    serial = register(irefs[0], imovs[0], cfg_fluid)
    np.testing.assert_allclose(
        np.asarray(res.motion[0]), np.asarray(serial.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_sor_sweeps_sharded_matches_serial():
    from opticalflow2d_tpu.parallel.spatial import make_sor_sweeps_sharded
    from opticalflow2d_tpu.solvers.elastic import sor_sweep

    mesh = make_mesh(data=1, x=8)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 64, 40)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((2, 64, 40)).astype(np.float32))

    sweeps = make_sor_sweeps_sharded(mesh, 0.5, 0.1, 0.66, niter=5)
    got = sweeps(x, b)

    want = x
    for _ in range(5):
        want = sor_sweep(want, b, 0.5, 0.1, 0.66)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@requires_8
def test_gaussian_smooth_sharded_matches_serial():
    from opticalflow2d_tpu.parallel.spatial import make_gaussian_smooth_sharded
    from opticalflow2d_tpu.ops.conv import convolve2d_clip

    mesh = make_mesh(data=1, x=8)
    rng = np.random.default_rng(4)
    f = jnp.asarray(rng.standard_normal((2, 64, 40)).astype(np.float32))

    smooth = make_gaussian_smooth_sharded(mesh, 2.0, 5)
    got = smooth(f)
    want = convolve2d_clip(f, 2.0, 5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)


@requires_8
def test_register_sharded_demons_matches_serial():
    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))
    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(8, 4), nscales=1,
                    warp_halo=2)
    res_sharded = register_sharded(iref, imov, cfg, mesh)
    res_serial = register(iref, imov, cfg)
    np.testing.assert_allclose(
        np.asarray(res_sharded.motion), np.asarray(res_serial.motion),
        rtol=1e-4, atol=1e-5,
    )


@requires_8
def test_warp2d_sharded_matches_serial():
    from opticalflow2d_tpu.parallel.spatial import make_warp2d_sharded
    from opticalflow2d_tpu.ops.warp import warp2d

    mesh = make_mesh(data=1, x=8)
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.standard_normal((64, 40)).astype(np.float32))
    # bounded displacement within the halo=3 contract (border pixels still
    # exercise the out-of-bounds passthrough path)
    u = jnp.asarray(
        np.clip(2.5 * rng.standard_normal((2, 64, 40)), -2.9, 2.9).astype(np.float32)
    )

    warp = make_warp2d_sharded(mesh, halo=3)
    got = warp(img, u)
    want = warp2d(img, u)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@requires_8
def test_demons_step_sharded_matches_serial():
    from opticalflow2d_tpu.parallel.spatial import make_demons_step_sharded
    from opticalflow2d_tpu.solvers.demons import make_demons_step

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))
    u0 = jnp.zeros((2, 64, 48))

    sharded = make_demons_step_sharded(mesh, 1.0, 0.25, 2.0, 2.0, 5, halo=2)
    serial = make_demons_step(1.0, 0.25, 2.0, 2.0, 5, diffeomorphic=False)

    u_a, u_b = u0, u0
    for _ in range(4):
        u_a = sharded(u_a, jnp.asarray(iref), jnp.asarray(imov))
        u_b = serial(u_b, jnp.asarray(iref), jnp.asarray(imov))
    np.testing.assert_allclose(np.asarray(u_a), np.asarray(u_b), rtol=1e-4, atol=1e-5)


@requires_8
def test_diffeo_demons_step_sharded_matches_serial():
    from opticalflow2d_tpu.parallel.spatial import make_demons_step_sharded
    from opticalflow2d_tpu.solvers.demons import make_demons_step

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))
    u0 = jnp.zeros((2, 64, 48))

    sharded = make_demons_step_sharded(mesh, 1.0, 0.25, 2.0, 2.0, 5, halo=2,
                                       diffeomorphic=True)
    serial = make_demons_step(1.0, 0.25, 2.0, 2.0, 5, diffeomorphic=True)

    u_a, u_b = u0, u0
    for _ in range(3):
        u_a = sharded(u_a, jnp.asarray(iref), jnp.asarray(imov))
        u_b = serial(u_b, jnp.asarray(iref), jnp.asarray(imov))
    np.testing.assert_allclose(np.asarray(u_a), np.asarray(u_b), rtol=1e-4, atol=1e-5)


@requires_8
def test_demons_level_sharded_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_demons_level_sharded

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))

    solve = make_demons_level_sharded(mesh, 1.0, 0.25, 2.0, 2.0, 5,
                                      niter=12, halo=2)
    u, iters = solve(jnp.zeros((2, 64, 48)), jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(12,), nscales=0,
                    warp_halo=2, warp_halo_outer=2)
    res = register(iref, imov, cfg)
    assert int(iters) == int(res.traces[0].iterations)
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_fluid_level_sharded_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_fluid_level_sharded

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))

    # halo=5 comfortably covers the accumulated displacement over this
    # trajectory (the sharded path has no exact-gather fallback — the halo
    # IS the contract).
    solve = make_fluid_level_sharded(mesh, 0.25, 0.0, 0.66, niter=15, halo=5)
    u, iters, regrids = solve(
        jnp.zeros((2, 64, 48)), jnp.asarray(iref), jnp.asarray(imov)
    )

    cfg = RegConfig(method=Method.FLUID, niter=(15,), nscales=0, mu=0.25,
                    lam=0.0, warp_halo=0, warp_halo_outer=0)
    res = register(iref, imov, cfg)
    assert int(iters) == int(res.traces[0].iterations)
    assert int(regrids) == int(res.traces[0].regrids)
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
@pytest.mark.parametrize("method,kw,serial_kw", [
    ("diffusion", dict(alpha=0.5), dict(method=Method.DIFFUSION, alpha=0.5)),
    ("elastic", dict(mu=0.5, lam=0.0), dict(method=Method.ELASTIC, mu=0.5, lam=0.0)),
])
def test_variational_level_sharded_matches_register(method, kw, serial_kw):
    from opticalflow2d_tpu.parallel.spatial import make_variational_level_sharded

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))

    solve = make_variational_level_sharded(mesh, method, niter=20, halo=4, **kw)
    u, iters = solve(jnp.zeros((2, 64, 48)), jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(niter=(20,), nscales=0, warp_halo=0, warp_halo_outer=0,
                    **serial_kw)
    res = register(iref, imov, cfg)
    assert int(iters) == int(res.traces[0].iterations)
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_curvature_level_sharded_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_variational_level_sharded

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))

    solve = make_variational_level_sharded(
        mesh, "curvature", niter=20, halo=4, alpha=0.1, tau=1.0,
        grid_shape=(64, 48),
    )
    u, iters = solve(jnp.zeros((2, 64, 48)), jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.CURVATURE, niter=(20,), nscales=0,
                    alpha=0.1, tau=1.0, warp_halo=0, warp_halo_outer=0)
    res = register(iref, imov, cfg)
    assert int(iters) == int(res.traces[0].iterations)
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("impl", ["vmap", "map"])
def test_register_batch_warm_start(impl):
    irefs, imovs = _batch_pairs(3)
    first = register_batch(irefs, imovs, CFG, impl=impl)
    warm = register_batch(irefs, imovs, CFG, impl=impl,
                          initial_motions=first.motion)
    # warm start from each pair's own solution must match the serial
    # warm-started register
    serial = register(irefs[1], imovs[1], CFG,
                      initial_motion=first.motion[1])
    np.testing.assert_allclose(
        np.asarray(warm.motion[1]), np.asarray(serial.motion),
        rtol=2e-4, atol=1e-5,
    )


@requires_8
def test_register_demons_sp_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_register_demons_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))

    solve = make_register_demons_sp(
        mesh, 1.0, 0.25, 2.0, 2.0, 5, niter=[10, 8], nscales=1, halo=2
    )
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(10, 8), nscales=1,
                    warp_halo=2, warp_halo_outer=2)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
@pytest.mark.parametrize("family,kw,serial_kw", [
    ("diffusion", dict(alpha=0.5), dict(method=Method.DIFFUSION, alpha=0.5)),
    ("elastic", dict(mu=0.5, lam=0.0), dict(method=Method.ELASTIC, mu=0.5, lam=0.0)),
    ("diffeo", dict(sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0,
                    sigma_fluid=2.0, kernelwidth=5),
     dict(method=Method.DIFFEOMORPHIC_DEMONS)),
])
def test_register_sp_families_match_register(family, kw, serial_kw):
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))

    solve = make_register_sp(mesh, family, niter=[8, 6], nscales=1, halo=4, **kw)
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(niter=(8, 6), nscales=1, warp_halo=4, warp_halo_outer=4,
                    **serial_kw)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
@pytest.mark.parametrize("family,kw,serial_kw", [
    ("diffusion", dict(alpha=0.5), dict(method=Method.DIFFUSION, alpha=0.5)),
    ("thirions", dict(sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0,
                      sigma_fluid=2.0, kernelwidth=5),
     dict(method=Method.THIRIONS_DEMONS)),
])
def test_register_sp_nrefine_matches_register(family, kw, serial_kw):
    """SP nrefine=2: the outer refinement loop (warp at refinement start,
    compose at end — reference ImageRegistrationOpticalFlow.cpp:97-151)
    must match the serial driver, including the per-(level, refinement)
    iteration counts (refine-major trace order)."""
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))

    solve = make_register_sp(mesh, family, niter=[6, 5], nscales=1,
                             nrefine=2, halo=4, **kw)
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))
    assert np.asarray(iters).shape == (4,)  # 2 levels x 2 refinements

    cfg = RegConfig(niter=(6, 5), nscales=1, nrefine=2, warp_halo=4,
                    warp_halo_outer=4, warp_halo_auto=False,
                    **serial_kw)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_register_sp_fluid_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.5, -0.8))

    solve = make_register_sp(mesh, "fluid", niter=[10, 8], nscales=1, halo=5,
                             mu=0.25, lam=0.0)
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.FLUID, niter=(10, 8), nscales=1, mu=0.25,
                    lam=0.0, warp_halo=0, warp_halo_outer=0)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_register_sp_curvature_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))

    solve = make_register_sp(mesh, "curvature", niter=[8, 6], nscales=1,
                             halo=4, alpha=0.1, tau=1.0)
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.CURVATURE, niter=(8, 6), nscales=1,
                    alpha=0.1, tau=1.0, warp_halo=4, warp_halo_outer=4)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-4
    )


@requires_8
@pytest.mark.parametrize("seed", range(4))
def test_register_sp_fuzz_vs_serial(seed):
    """Seeded fuzz of the explicit-SP registration vs the serial driver."""
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    rng = np.random.default_rng(100 + seed)
    fam, method = [
        ("thirions", Method.THIRIONS_DEMONS),
        ("diffusion", Method.DIFFUSION),
        ("elastic", Method.ELASTIC),
        ("fluid", Method.FLUID),
    ][seed % 4]
    niter = [int(rng.integers(4, 10)), int(rng.integers(4, 10))]
    shift = (float(rng.uniform(-1.5, 1.5)), float(rng.uniform(-1.5, 1.5)))
    iref, imov = make_pair(64, 48, shift=shift)

    kw = {}
    serial_kw = dict(method=method)
    if fam == "thirions":
        kw = dict(sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0,
                  sigma_fluid=2.0, kernelwidth=5)
    elif fam == "diffusion":
        a = float(rng.uniform(0.3, 1.0))
        kw = dict(alpha=a); serial_kw["alpha"] = a
    elif fam == "elastic":
        m = float(rng.uniform(0.3, 0.8))
        kw = dict(mu=m, lam=0.0); serial_kw.update(mu=m, lam=0.0)
    else:
        kw = dict(mu=0.25, lam=0.0); serial_kw.update(mu=0.25, lam=0.0)

    mesh = make_mesh(data=1, x=8)
    solve = make_register_sp(mesh, fam, niter=niter, nscales=1, halo=5, **kw)
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(niter=tuple(niter), nscales=1, warp_halo=0,
                    warp_halo_outer=0, **serial_kw)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_register_sp_deep_pyramid_matches_register():
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.2, -0.7))

    solve = make_register_sp(mesh, "diffusion", niter=[5, 4, 6], nscales=2,
                             halo=4, alpha=0.5)
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.DIFFUSION, niter=(5, 4, 6), nscales=2,
                    alpha=0.5, warp_halo=4, warp_halo_outer=4)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )


@requires_8
def test_register_sp_diffeo_deep_pyramid():
    from opticalflow2d_tpu.parallel.spatial import make_register_sp

    mesh = make_mesh(data=1, x=8)
    iref, imov = make_pair(64, 48, shift=(1.0, -0.6))

    solve = make_register_sp(
        mesh, "diffeo", niter=[4, 4, 5], nscales=2, halo=4,
        sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0, sigma_fluid=2.0,
        kernelwidth=5,
    )
    u, iters = solve(jnp.asarray(iref), jnp.asarray(imov))

    cfg = RegConfig(method=Method.DIFFEOMORPHIC_DEMONS, niter=(4, 4, 5),
                    nscales=2, warp_halo=4, warp_halo_outer=4)
    res = register(iref, imov, cfg)
    assert [int(x) for x in np.asarray(iters)] == [
        int(t.iterations) for t in res.traces
    ]
    np.testing.assert_allclose(
        np.asarray(u), np.asarray(res.motion), rtol=1e-4, atol=1e-5
    )
