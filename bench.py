"""Per-iteration time of each solver family's plain step on the GPU.

Times the step that one iteration of each family's level loop runs — the
solver update plus the Logger relative error that gates convergence — at
the demo's CT-slice shape (534x512) and at 4096x4096, and reports it
beside the least time the card's memory bandwidth allows for the bytes
the step must move (its inputs read once, its outputs written once).

Usage: python bench.py [--sizes 534x512 4096x4096] [--reps 10]

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per (step, shape). Exits non-zero when JAX finds no GPU.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Float32 planes each step must read and write at least once.
_PLANES = {
    "diffusion": 7,   # u(2) grad(2) It(1) in, u(2) out
    "curvature": 7,   # the same planes; the DCT matmuls come on top
    "elastic": 7,     # u(2) grad(2) It(1) in, u(2) out
    "fluid": 11,      # u(2) vel(2) grad(2) It(1) in, u(2) vel(2) out
    "thirions": 6,    # u(2) Iref(1) Iaux(1) in, u(2) out
    "diffeo": 6,      # as Thirion; the exp map's squarings come on top
}


def _parse_size(text):
    nx, ny = (int(v) for v in text.lower().split("x"))
    return nx, ny


def _level_steps(iref, imov, cfg_for):
    """One Logger-gated iteration per family, as ``state -> state``
    functions over the same arrays the level loops carry."""
    import jax.numpy as jnp

    from opticalflow2d_tpu.config import Method
    from opticalflow2d_tpu.engine.registration import _rel_step_error
    from opticalflow2d_tpu.ops.grid import jacobian_det
    from opticalflow2d_tpu.solvers.base import derivatives
    from opticalflow2d_tpu.solvers.curvature import make_curvature_step
    from opticalflow2d_tpu.solvers.demons import make_demons_step
    from opticalflow2d_tpu.solvers.diffusion import diffusion_step
    from opticalflow2d_tpu.solvers.elastic import elastic_step
    from opticalflow2d_tpu.solvers.fluid import make_fluid_step

    d = derivatives(iref, imov)
    nx, ny = iref.shape
    steps = {}

    def variational(step):
        def body(u):
            u_new = step(u, d)
            return u_new + 0.0 * _rel_step_error(u_new, u)
        return body

    c = cfg_for(Method.DIFFUSION)
    steps["diffusion"] = variational(
        lambda u, d: diffusion_step(u, d, c.alpha))
    cc = cfg_for(Method.CURVATURE)
    steps["curvature"] = variational(make_curvature_step(
        nx, ny, cc.alpha, cc.tau, cc.jnp_dtype, cc.resolved_dct_impl))
    ce = cfg_for(Method.ELASTIC)
    steps["elastic"] = variational(lambda u, d: elastic_step(
        u, d, ce.mu, ce.lam, ce.omega, ce.compat.elastic_stencil_reference,
        ce.sor_ordering))

    cf = cfg_for(Method.FLUID)
    fluid = make_fluid_step(cf.mu, cf.lam, cf.omega, dumax=cf.dumax,
                            timestep_skip=cf.timestep_skip)

    def fluid_body(state):
        u, vel = state
        u_new, vel, _ = fluid(u, vel, d)
        # The regrid predicate; the regrid itself is rare and not timed.
        jac_min = jnp.min(jacobian_det(u_new))
        return u_new + 0.0 * (_rel_step_error(u_new, u) + jac_min), vel

    steps["fluid"] = fluid_body

    for name, method in (("thirions", Method.THIRIONS_DEMONS),
                         ("diffeo", Method.DIFFEOMORPHIC_DEMONS)):
        cd = cfg_for(method)
        demons = make_demons_step(
            cd.sigma_i, cd.sigma_x, cd.sigma_diffusion, cd.sigma_fluid,
            cd.kernelwidth, diffeomorphic=method == Method.DIFFEOMORPHIC_DEMONS,
            accumulation=cd.accumulation, warp_halo=cd.warp_halo,
            with_errors=True)

        def demons_body(u, demons=demons):
            u_new, sums = demons(u, iref, imov)
            return u_new + 0.0 * sums[0]

        steps[name] = demons_body
    return steps


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", nargs="+", default=["534x512", "4096x4096"])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()

    import jax.numpy as jnp
    from jax import lax

    from opticalflow2d_tpu.config import RegConfig
    from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache
    from opticalflow2d_tpu.utils.device import (
        hbm_peak, nvidia_smi_lines, require_gpu)
    from opticalflow2d_tpu.utils.profiling import kernel_timer
    from examples.demo import REGPARAMS, synthesize_pair_jax

    devices = require_gpu()
    enable_compile_cache()
    for line in nvidia_smi_lines():
        print(f"card: {line}")
    kind = devices[0].device_kind
    peak = hbm_peak(kind)

    def cfg_for(method):
        return RegConfig.from_regparams(method, [25, 25], 1, REGPARAMS[method])

    for size in args.sizes:
        nx, ny = _parse_size(size)
        iref, imov = synthesize_pair_jax(max(nx, ny), seed=3)
        iref, imov = iref[:nx, :ny], imov[:nx, :ny]
        # Enough iterations per timed call that launch overhead is noise.
        iters = max(10, int(2e8 // (nx * ny)))
        for name, body in _level_steps(iref, imov, cfg_for).items():
            u0 = jnp.zeros((2, nx, ny), jnp.float32)
            state = (u0, u0) if name == "fluid" else u0

            def run(s, body=body):
                return lax.fori_loop(0, iters, lambda _, x: body(x), s)

            sec = kernel_timer(run, state, reps=args.reps) / iters
            nbytes = _PLANES[name] * 4 * nx * ny
            print(json.dumps({
                "step": name, "shape": [nx, ny], "iters_per_call": iters,
                "us_per_iter": sec * 1e6,
                "min_bytes": nbytes,
                "hbm_roofline_share": nbytes / peak / sec,
                "device_kind": kind,
            }), flush=True)


if __name__ == "__main__":
    main()
