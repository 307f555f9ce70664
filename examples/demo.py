"""End-to-end demo — the analog of the reference's ``test_opticalflow2d.m``.

The reference's demo loads a DIR-Lab lung-CT slice pair (not shipped in its
repo — ``img/`` is gitignored there), min-max normalizes, replicate-pads 11
rows, runs the fluid model with ``niter=[25 25]``, ``nscales=1``,
``mu=0.25``, ``lambda=0``, then reports motion statistics and difference
images (``test_opticalflow2d.m:8-94``). This demo reproduces that pipeline;
given no DIR-Lab data it synthesizes a deformable "lung-like" pair (use
``--iref/--imov`` to point at your own .npy slices).

Usage: python examples/demo.py [--method fluid] [--size 256] [--save out/]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opticalflow2d_tpu import Method  # noqa: E402
from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


# Regularisation parameters per family; fluid's are the reference demo's
# (test_opticalflow2d.m:23-38).
REGPARAMS = {
    Method.DIFFUSION: [0.5],
    Method.CURVATURE: [0.1, 1.0],
    Method.ELASTIC: [0.5, 0.0],
    Method.THIRIONS_DEMONS: [1.0, 0.25, 2.0, 2.0, 5, 0],
    Method.DIFFEOMORPHIC_DEMONS: [1.0, 0.25, 2.0, 2.0, 5],
    Method.FLUID: [0.25, 0.0],
}


def synthesize_pair(n=256, seed=3):
    """Smooth multi-scale structure warped by a known smooth deformation."""
    rng = np.random.default_rng(seed)
    # band-limited random texture: sum of random Gaussian blobs
    xs = np.arange(n)[:, None]
    ys = np.arange(n)[None, :]
    img = np.zeros((n, n))
    for _ in range(60):
        cx, cy = rng.uniform(0, n, 2)
        s = rng.uniform(n * 0.02, n * 0.12)
        img += rng.uniform(-1, 1) * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
    # smooth deformation field (the "truth")
    ux = 3.0 * np.sin(2 * np.pi * ys / n) * np.sin(np.pi * xs / n)
    uy = -2.5 * np.sin(2 * np.pi * xs / n) * np.sin(np.pi * ys / n)
    # moving image: sample img at x + u (backward warp with truth field)
    gx = np.clip(xs + ux, 0, n - 1)
    gy = np.clip(ys + uy, 0, n - 1)
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    x1 = np.minimum(x0 + 1, n - 1)
    y1 = np.minimum(y0 + 1, n - 1)
    fx = gx - x0
    fy = gy - y0
    imov = (
        img[x0, y0] * (1 - fx) * (1 - fy)
        + img[x1, y0] * fx * (1 - fy)
        + img[x0, y1] * (1 - fx) * fy
        + img[x1, y1] * fx * fy
    )
    return img.astype(np.float32), imov.astype(np.float32)


def synthesize_pair_jax(n, seed=3, feature_px=4.0):
    """A textured pair generated on the default device, for sizes where
    ``synthesize_pair``'s numpy loop is slow: Gaussian-filtered white noise
    (features ``feature_px`` wide at any ``n``, as in a large scan), min-max
    normalised, warped by ``synthesize_pair``'s smooth deformation."""
    import jax
    import jax.numpy as jnp

    from opticalflow2d_tpu.ops.reduce import normalize_minmax
    from opticalflow2d_tpu.ops.warp import warp2d

    def make(key):
        noise = jax.random.normal(key, (n, n), jnp.float32)
        f = jnp.fft.fftfreq(n).astype(jnp.float32)
        k2 = f[:, None] ** 2 + f[None, :] ** 2
        lowpass = jnp.exp(-2.0 * (jnp.pi * feature_px) ** 2 * k2)
        img = normalize_minmax(jnp.fft.irfft2(
            jnp.fft.rfft2(noise) * lowpass[:, : n // 2 + 1], s=(n, n)))
        xs = jnp.arange(n, dtype=jnp.float32)[:, None]
        ys = jnp.arange(n, dtype=jnp.float32)[None, :]
        ux = 3.0 * jnp.sin(2 * jnp.pi * ys / n) * jnp.sin(jnp.pi * xs / n)
        uy = -2.5 * jnp.sin(2 * jnp.pi * xs / n) * jnp.sin(jnp.pi * ys / n)
        return img, warp2d(img, jnp.stack([ux, uy]))

    return jax.jit(make)(jax.random.PRNGKey(seed))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--method", default="fluid",
                   choices=["diffusion", "curvature", "elastic",
                            "thirions_demons", "diffeomorphic_demons", "fluid"])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iref", help=".npy file for the reference image")
    p.add_argument("--imov", help=".npy file for the moving image")
    p.add_argument("--save", help="directory to save outputs (.npy)")
    args = p.parse_args()
    enable_compile_cache()

    from opticalflow2d_tpu import OpticalFlow2d
    from opticalflow2d_tpu.ops.reduce import normalize_minmax
    import jax.numpy as jnp

    if args.iref and args.imov:
        iref = np.load(args.iref).astype(np.float32)
        imov = np.load(args.imov).astype(np.float32)
    else:
        iref, imov = synthesize_pair(args.size)

    # Preprocessing, as the reference demo does (test_opticalflow2d.m:14-18):
    # min-max normalize + replicate-pad 11 rows top/bottom.
    iref = np.asarray(normalize_minmax(jnp.asarray(iref)))
    imov = np.asarray(normalize_minmax(jnp.asarray(imov)))
    pad = 11
    iref = np.pad(iref, ((pad, pad), (0, 0)), mode="edge")
    imov = np.pad(imov, ((pad, pad), (0, 0)), mode="edge")

    method = Method[args.method.upper()]
    regparams = REGPARAMS[method]

    sess = OpticalFlow2d(
        iref.shape, niter=[25, 25], nscales=1,
        regularisation=method, regparams=regparams, nrefine=1, verbose=True,
    )

    t0 = time.time()
    sess.register(iref, imov)
    elapsed = time.time() - t0

    motion = sess.get_motion()
    ireg = sess.warp(imov)

    # Unpad (test_opticalflow2d.m:62-65).
    iref_u = iref[pad:-pad]
    imov_u = imov[pad:-pad]
    ireg_u = ireg[pad:-pad]
    motion_u = motion[pad:-pad]

    ssd_before = float(((iref_u - imov_u) ** 2).sum())
    ssd_after = float(((iref_u - ireg_u) ** 2).sum())
    print(f"\nRegistration wall-clock: {elapsed:.3f} s")
    print(f"Motion distribution: {motion_u.mean():.3f} +/- {motion_u.std():.3f}")
    print(f"Maxabs: {np.abs(motion_u).max():.3f}")
    print(f"SSD: {ssd_before:.3f} -> {ssd_after:.3f} "
          f"({(1 - ssd_after / max(ssd_before, 1e-12)) * 100:.1f}% reduction)")

    if args.save:
        os.makedirs(args.save, exist_ok=True)
        np.save(os.path.join(args.save, "motion.npy"), motion_u)
        np.save(os.path.join(args.save, "registered.npy"), ireg_u)
        print(f"outputs saved to {args.save}/")


if __name__ == "__main__":
    main()
