"""Sequential-frame tracking with warm starts — the workflow the reference's
stateful singleton enables (repeated register calls reuse the motion state,
``WrapperOpticalFlow2d.cpp:86-102``), expressed with the functional API's
``initial_motion``.

Registers a synthetic "breathing" sequence frame-by-frame against frame 0;
each frame's solve is warm-started from the previous frame's field, cutting
iterations and improving temporal coherence.

Usage: python examples/sequence_tracking.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def make_sequence(n=128, frames=6, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.arange(n)[:, None]
    ys = np.arange(n)[None, :]
    base = np.zeros((n, n))
    for _ in range(40):
        cx, cy = rng.uniform(0, n, 2)
        s = rng.uniform(3, n * 0.08)
        base += rng.uniform(-1, 1) * np.exp(
            -((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s)
        )

    def warp_by(phase):
        amp = 2.5 * np.sin(phase)
        ux = amp * np.sin(2 * np.pi * ys / n)
        uy = -0.8 * amp * np.sin(2 * np.pi * xs / n)
        gx = np.clip(xs + ux, 0, n - 1)
        gy = np.clip(ys + uy, 0, n - 1)
        x0 = np.floor(gx).astype(int); y0 = np.floor(gy).astype(int)
        x1 = np.minimum(x0 + 1, n - 1); y1 = np.minimum(y0 + 1, n - 1)
        fx = gx - x0; fy = gy - y0
        return (base[x0, y0] * (1 - fx) * (1 - fy) + base[x1, y0] * fx * (1 - fy)
                + base[x0, y1] * (1 - fx) * fy + base[x1, y1] * fx * fy)

    return [warp_by(k * np.pi / frames).astype(np.float32) for k in range(frames)]


def main():
    import jax.numpy as jnp

    enable_compile_cache()

    from opticalflow2d_tpu import register, RegConfig, Method
    from opticalflow2d_tpu.metrics import ssd_reduction

    frames = make_sequence()
    ref = frames[0]
    # small per-frame budget: warm starts let a tight budget keep up
    cfg = RegConfig(method=Method.THIRIONS_DEMONS, niter=(8, 4), nscales=1)

    print("frame | ssd-red (cold start) | ssd-red (warm start)")
    u_prev = None
    for k, frame in enumerate(frames[1:], start=1):
        cold = register(ref, frame, cfg)
        warm = (register(ref, frame, cfg, initial_motion=u_prev)
                if u_prev is not None else cold)
        ir = jnp.asarray(ref)
        fr = jnp.asarray(frame)
        red_cold = float(ssd_reduction(ir, fr, cold.motion))
        red_warm = float(ssd_reduction(ir, fr, warm.motion))
        print(f"  {k:3d} | {red_cold:20.4f} | {red_warm:20.4f}")
        u_prev = warm.motion


if __name__ == "__main__":
    main()
