"""Tests for aux utilities and completeness ops (boundary conditions,
general kernels, checkpointing, health checks)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from opticalflow2d_tpu.ops.boundary import dirichlet_boundary, neumann_boundary
from opticalflow2d_tpu.ops.conv import box_kernel_2d, convolve2d_kernel, gaussian_kernel_2d, convolve2d_clip
from opticalflow2d_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
from opticalflow2d_tpu.utils.health import assert_finite, divergence_guard
from opticalflow2d_tpu.config import RegConfig, Method


def test_dirichlet_boundary(rng):
    u = jnp.asarray(rng.standard_normal((2, 8, 9)).astype(np.float32))
    out = np.asarray(dirichlet_boundary(u))
    assert (out[:, 0, :] == 0).all() and (out[:, -1, :] == 0).all()
    assert (out[:, :, 0] == 0).all() and (out[:, :, -1] == 0).all()
    np.testing.assert_array_equal(out[:, 1:-1, 1:-1], np.asarray(u)[:, 1:-1, 1:-1])


def test_neumann_boundary(rng):
    u = jnp.asarray(rng.standard_normal((2, 8, 9)).astype(np.float32))
    out = np.asarray(neumann_boundary(u))
    np.testing.assert_array_equal(out[:, 0, 1:-1], out[:, 1, 1:-1])
    np.testing.assert_array_equal(out[:, -1, 1:-1], out[:, -2, 1:-1])
    np.testing.assert_array_equal(out[:, :, 0], out[:, :, 1])
    np.testing.assert_array_equal(out[:, :, -1], out[:, :, -2])


def test_convolve2d_kernel_gaussian_matches_separable(rng):
    f = rng.standard_normal((14, 18)).astype(np.float32)
    k = gaussian_kernel_2d(2.0, 5)
    a = np.asarray(convolve2d_kernel(jnp.asarray(f), k))
    b = np.asarray(convolve2d_clip(jnp.asarray(f), 2.0, 5))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_convolve2d_kernel_box(rng):
    f = rng.standard_normal((12, 12)).astype(np.float32)
    k = box_kernel_2d(3)
    out = np.asarray(convolve2d_kernel(jnp.asarray(f), k))
    # interior = plain 3x3 mean
    want = np.zeros_like(f)
    for i in range(1, 11):
        for j in range(1, 11):
            want[i, j] = f[i - 1 : i + 2, j - 1 : j + 2].mean()
    np.testing.assert_allclose(out[1:-1, 1:-1], want[1:-1, 1:-1], rtol=1e-5, atol=1e-6)


def test_checkpoint_roundtrip(tmp_path, rng):
    u = rng.standard_normal((2, 16, 16)).astype(np.float32)
    cfg = RegConfig(method=Method.FLUID, niter=(10, 5), nscales=1)
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, u, cfg, level=1)
    u2, level = load_checkpoint(path, cfg)
    np.testing.assert_array_equal(u, u2)
    assert level == 1

    other = RegConfig(method=Method.FLUID, niter=(10, 5), nscales=1, mu=9.0)
    with pytest.raises(ValueError):
        load_checkpoint(path, other)


def test_register_resumable_crash_resume_bitwise(tmp_path, rng):
    """Kill-after-level-N resume must equal the uninterrupted run (to float
    associativity: XLA fuses the upsample->downsample pair across a
    monolithic level boundary with different rounding, ~1 ulp)."""
    from opticalflow2d_tpu.engine.registration import register
    from opticalflow2d_tpu.utils.checkpoint import register_resumable

    iref = rng.random((32, 28)).astype(np.float32)
    imov = rng.random((32, 28)).astype(np.float32)
    cfg = RegConfig(method=Method.DIFFUSION, niter=(6, 5, 4), nscales=2,
                    alpha=0.5, warp_halo=0, warp_halo_outer=0)
    path = os.path.join(tmp_path, "resume.npz")

    # Simulated crash right after the middle scale (scale 1) checkpointed.
    assert register_resumable(iref, imov, cfg, path, _crash_after_scale=1) is None
    _, level = load_checkpoint(path, cfg)
    assert level == 1

    resumed = register_resumable(iref, imov, cfg, path)
    # Completed levels' traces were persisted in the checkpoint, so the
    # resumed result covers the FULL pyramid (scales 2, 1, 0).
    assert [int(t.scale) for t in resumed.traces] == [2, 1, 0]

    straight = register(iref, imov, cfg)
    np.testing.assert_allclose(
        np.asarray(resumed.motion), np.asarray(straight.motion),
        rtol=1e-5, atol=1e-6,
    )
    # The persisted traces equal the uninterrupted run's, value for value.
    for tr, ts in zip(resumed.traces, straight.traces):
        assert int(tr.iterations) == int(ts.iterations)
        np.testing.assert_allclose(np.asarray(tr.errors),
                                   np.asarray(ts.errors),
                                   rtol=1e-5, atol=1e-7)

    # A third call is a no-op returning the stored field exactly, with the
    # full trace history.
    again = register_resumable(iref, imov, cfg, path)
    assert [int(t.scale) for t in again.traces] == [2, 1, 0]
    np.testing.assert_array_equal(
        np.asarray(again.motion), np.asarray(resumed.motion)
    )


def test_register_resumable_rejects_different_pair(tmp_path, rng):
    """A checkpoint is only a resume point for the SAME image pair."""
    from opticalflow2d_tpu.utils.checkpoint import register_resumable

    a_ref = rng.random((24, 20)).astype(np.float32)
    a_mov = rng.random((24, 20)).astype(np.float32)
    b_ref = rng.random((24, 20)).astype(np.float32)
    b_mov = rng.random((24, 20)).astype(np.float32)
    cfg = RegConfig(method=Method.DIFFUSION, niter=(3, 2), nscales=1,
                    alpha=0.5, warp_halo=0, warp_halo_outer=0)
    path = os.path.join(tmp_path, "pair.npz")
    register_resumable(a_ref, a_mov, cfg, path)
    with pytest.raises(ValueError, match="different image pair"):
        register_resumable(b_ref, b_mov, cfg, path)


def test_checkpoint_fingerprint_ignores_verbose_stream(tmp_path, rng):
    """Logging-only knobs must not invalidate checkpoints."""
    u = rng.standard_normal((2, 8, 8)).astype(np.float32)
    quiet = RegConfig(method=Method.DIFFUSION, niter=(3,), alpha=0.5)
    loud = RegConfig(method=Method.DIFFUSION, niter=(3,), alpha=0.5,
                     verbose_stream=True)
    path = os.path.join(tmp_path, "v.npz")
    save_checkpoint(path, u, quiet, level=0)
    u2, _ = load_checkpoint(path, loud)  # must not raise
    np.testing.assert_array_equal(u, u2)


def test_register_start_stop_scale_splits_bitwise(rng):
    """register(start_scale=s, stop_scale=s) chained over levels equals the
    monolithic pyramid."""
    from opticalflow2d_tpu.engine.registration import register

    iref = rng.random((24, 24)).astype(np.float32)
    imov = rng.random((24, 24)).astype(np.float32)
    # warp_halo_auto pinned off: the auto-halo default is itself a two-phase
    # level split with a fitted (>=1) outer halo, which would make the
    # "monolithic" run a different split than the explicit chain here.
    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(4, 3), nscales=1,
                    warp_halo=0, warp_halo_outer=0, warp_halo_auto=False)
    r1 = register(iref, imov, cfg, start_scale=1, stop_scale=1)
    r0 = register(iref, imov, cfg, initial_motion=r1.motion,
                  start_scale=0, stop_scale=0)
    full = register(iref, imov, cfg)
    np.testing.assert_array_equal(np.asarray(r0.motion), np.asarray(full.motion))


def test_assert_finite_raises():
    with pytest.raises(FloatingPointError):
        assert_finite(jnp.array([1.0, np.nan]), "x")
    assert_finite(jnp.array([1.0, 2.0]), "x")  # no raise


def test_divergence_guard():
    errs = np.concatenate([np.full(5, 0.01), np.full(5, 0.5)])
    assert divergence_guard(errs, window=5, factor=10.0)
    assert not divergence_guard(np.full(10, 0.01), window=5)


def test_kernel_timer_smoke():
    from opticalflow2d_tpu.utils.profiling import kernel_timer

    state = jnp.ones((2, 16, 16))
    sec = kernel_timer(lambda x: x * 0.999, state, warmup=1, reps=3)
    assert sec > 0


def test_shard_batch_for_host_single_process():
    from opticalflow2d_tpu.parallel.multihost import shard_batch_for_host

    # Single process: every host slice is the whole batch.
    assert shard_batch_for_host(8) == slice(0, 8)
    assert shard_batch_for_host(7) == slice(0, 7)


def test_trace_context_smoke(tmp_path):
    from opticalflow2d_tpu.utils.profiling import trace

    with trace(str(tmp_path / "tr")) as logdir:
        jnp.sum(jnp.ones((8, 8))).block_until_ready()
    assert logdir


def test_debug_nans_scope():
    from opticalflow2d_tpu.utils.health import debug_nans
    import jax

    with debug_nans(True):
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.float32(-1.0)).block_until_ready()
    assert not jax.config.jax_debug_nans
