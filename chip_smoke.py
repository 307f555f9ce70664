"""Smoke test of the registration path on one GPU (or four, with an option).

Drives the main path once through the entry points a user calls and checks
what comes out:

1. device — the card (``nvidia-smi`` name and power limit), its JAX
   ``device_kind``, the jax/jaxlib versions and the compile-cache directory;
2. session — ``OpticalFlow2d`` register/get_motion/warp/close for all six
   families on the reference demo's CT-slice pair (534x512, niter [25 25],
   nscales 1), each compared with the same config run on the CPU under
   ``jax.default_matmul_precision("highest")``: equal iteration counts, the
   same SSD reduction, and motion within ``TOL_PX``;
3. batch — ``register_batch`` of 32 pairs at 256^2 (fluid, Thirion demons)
   against single-pair ``register`` on the card;
4. large pairs — diffeomorphic demons at 4096^2 through ``register`` and
   Thirion demons at 16384^2 through the session; finite motion, falling
   SSD, wall time and peak device memory.

Every phase runs even after another failed, and every check of a phase is
reported, so one run shows all that is wrong.

``--four-cards`` runs only the multi-card path instead: ``register_batch``
over a 4-way data mesh, ``make_register_sp`` for all six families at
2048^2 over a 4-way x mesh, and the distributed-DCT curvature step, each
against its single-card result.

Usage: python chip_smoke.py [--four-cards]

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed check or phase makes the exit code non-zero, and then no result
line is printed. Without a GPU the script exits non-zero before any phase.
"""

import argparse
import json
import math
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# The CPU reference runs beside the GPU in the same process.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

# Max |u_gpu - u_ref| in pixels. The card sums float32 in another order
# than the CPU, and that difference is carried through 50 iterations; a
# matmul left at Precision.HIGH/DEFAULT may also run in TF32 on the card.
# Either moves a well-determined converged field far less than 1e-3 px,
# the largest deviation that leaves a registration visibly unchanged.
TOL_PX = 1e-3
# Some pixels of a converged demons field are not determined to 1e-3 px
# by the data: where the image gradient and the residual are both near
# zero, a 1e-7 relative change of the moving image (about one float32 ulp)
# moves the CPU's own field there by up to 6e-2 px (on the demo pair: 284
# of 273,408 pixels past 1e-3 px, all in the top replicate-padded rows).
# TOL_PX is checked where the reference is determined to TOL_PX / 10 under
# that perturbation; the rest must stay under ILL_MAX_FRAC of the pixels
# and within twice the CPU's own largest change, and the mean endpoint
# difference over all pixels under TOL_PX / 10.
PERTURB_REL = 1e-7
ILL_MAX_FRAC = 0.01
# |SSD reduction on the card - SSD reduction on the CPU|.
TOL_SSD = 1e-3


def _ssd_reduction(iref, imov, warped):
    before = float(((iref - imov) ** 2).sum())
    after = float(((iref - warped) ** 2).sum())
    return 1.0 - after / before


def _check(fails, cond, msg):
    """Record a failed check; the phase goes on, so one run reports every
    family, and main() exits non-zero at the end."""
    if not cond:
        print(f"  FAILED: {msg}", flush=True)
        fails.append(msg)


def demo_pair():
    """The reference demo's preprocessing (test_opticalflow2d.m:14-18) on
    the synthetic slice pair: min-max normalise, replicate-pad 11 rows."""
    from examples.demo import synthesize_pair

    pad = 11
    out = []
    for img in synthesize_pair(512, seed=3):
        img = (img - img.min()) / (img.max() - img.min())
        out.append(np.pad(img, ((pad, pad), (0, 0)), mode="edge"))
    return out[0].astype(np.float32), out[1].astype(np.float32)


def perturbed(imov, seed=0):
    """``imov`` with a 1e-7 relative perturbation (about one ulp)."""
    rng = np.random.default_rng(seed)
    noise = 1.0 + PERTURB_REL * rng.standard_normal(imov.shape)
    return (imov * noise).astype(np.float32)


def compare_fields(fails, label, u, u_ref, u_ref_pert):
    """Check ``u`` [..., 2] against the reference field ``u_ref``, where
    ``u_ref_pert`` is the reference run on ``perturbed(imov)``; returns
    (max diff, max diff where well determined, ill fraction)."""
    diff = np.abs(u - u_ref).max(axis=-1)
    sens = np.abs(u_ref_pert - u_ref).max(axis=-1)
    well = sens <= TOL_PX / 10
    worst_well = float(diff[well].max()) if well.any() else 0.0
    ill = float(1.0 - well.mean())
    _check(fails, worst_well <= TOL_PX,
           f"{label}: max|du| {worst_well} > {TOL_PX} where determined")
    _check(fails, ill <= ILL_MAX_FRAC,
           f"{label}: {ill:.4%} of pixels not determined to {TOL_PX / 10}")
    _check(fails, float(diff.max()) <= max(TOL_PX, 2 * float(sens.max())),
           f"{label}: max|du| {diff.max()} past twice the reference's own "
           f"change {sens.max()}")
    _check(fails, float(diff.mean()) <= TOL_PX / 10,
           f"{label}: mean |du| {diff.mean()}")
    return float(diff.max()), worst_well, ill, float(sens.max())


def _run_session(method, regparams, iref, imov, niter, nscales):
    """register / get_motion / warp / close through the session; returns
    (motion [nx, ny, 2], warped, per-level iteration counts, seconds)."""
    from opticalflow2d_tpu import OpticalFlow2d

    t0 = time.perf_counter()
    sess = OpticalFlow2d(iref.shape, niter=niter, nscales=nscales,
                         regularisation=method, regparams=regparams)
    sess.register(iref, imov)
    motion = sess.get_motion()
    warped = sess.warp(imov)
    iters = [int(t.iterations) for t in sess.result.traces]
    sess.close()
    return motion, warped, iters, time.perf_counter() - t0


def textured_pair(nx, ny, seed=11):
    """A 1-4 px textured pair (``examples.demo.synthesize_pair_jax``) as
    numpy, for the fluid row: on the smooth demo pair the reference's
    timestep rule skips every fluid step (dt >= timestep_skip), so fluid
    never moves there."""
    from examples.demo import synthesize_pair_jax

    iref, imov = synthesize_pair_jax(max(nx, ny), seed=seed)
    return (np.asarray(iref)[:nx, :ny].copy(),
            np.asarray(imov)[:nx, :ny].copy())


def phase_session(iref, imov, card, fails, niter=(25, 25), nscales=1):
    """All six families through the session on the default device, each
    against the CPU run of the same config at HIGHEST precision; fluid
    once more on a textured pair of the same shape."""
    import jax

    from opticalflow2d_tpu import Method
    from examples.demo import REGPARAMS

    cpu = jax.devices("cpu")[0]
    niter = list(niter)
    tex = textured_pair(*iref.shape)
    cases = [(m.name, m, iref, imov) for m in Method]
    cases.append(("FLUID (textured)", Method.FLUID) + tex)
    rows = {}
    for label, method, a, b in cases:
        params = REGPARAMS[method]
        u, warped, iters, cold = _run_session(method, params, a, b,
                                              niter, nscales)
        u2, _, _, warm = _run_session(method, params, a, b, niter, nscales)
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            u_ref, warped_ref, iters_ref, _ = _run_session(
                method, params, a, b, niter, nscales)
            u_ref_p, _, _, _ = _run_session(method, params, a, perturbed(b),
                                            niter, nscales)
        red = _ssd_reduction(a, b, warped)
        red_ref = _ssd_reduction(a, b, warped_ref)
        diff, diff_well, ill, sens = compare_fields(fails, label, u, u_ref,
                                                    u_ref_p)
        rows[label] = dict(
            iters=iters, iters_ref=iters_ref, max_diff_px=diff,
            max_diff_determined_px=diff_well, ill_frac=ill,
            cpu_sensitivity_px=sens, ssd_red=red, ssd_red_ref=red_ref,
            cold_s=cold, warm_s=warm)
        print(f"  {label:21s} iters {iters} (cpu {iters_ref})  max|du| "
              f"{diff:.3e} px, {diff_well:.3e} where determined "
              f"({ill:.4%} not; cpu self-sensitivity {sens:.3e})  ssd-red "
              f"{red:.6f} (cpu {red_ref:.6f})  cold {cold:.3f} s  warm "
              f"{warm:.3f} s  [{card}]", flush=True)
        _check(fails, np.isfinite(u).all(), f"{label}: non-finite motion")
        _check(fails, np.array_equal(u, u2), f"{label}: warm run differs")
        if red == red_ref == 0.0 and not u.any():
            print(f"  {label}: no step taken, as on the CPU (every "
                  f"timestep skipped)", flush=True)
        else:
            _check(fails, red > 0, f"{label}: SSD did not fall ({red})")
        _check(fails, abs(red - red_ref) <= TOL_SSD,
               f"{label}: SSD reduction {red} vs CPU {red_ref}")
        _check(fails, iters == iters_ref,
               f"{label}: iterations {iters} vs CPU {iters_ref}")
    return rows


def batch_pairs(n, count, seed0=100):
    from examples.demo import synthesize_pair

    refs, movs = [], []
    for k in range(count):
        r, m = synthesize_pair(n, seed=seed0 + k)
        lo, hi = r.min(), r.max()
        refs.append((r - lo) / (hi - lo))
        movs.append((m - lo) / (hi - lo))
    return (np.stack(refs).astype(np.float32),
            np.stack(movs).astype(np.float32))


def _compile_together(jobs):
    """Compile ``(jitted_fn, args)`` jobs side by side in threads and
    return the seconds taken. XLA's compiler releases the GIL, and a later
    call of the same function on arguments of the same shapes and
    shardings finds its program in JAX's in-memory caches. Nothing runs
    on the device here."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as pool:
        futures = [pool.submit(lambda f, a: f.lower(*a).compile(), fn, args)
                   for fn, args in jobs]
        for fut in futures:
            fut.result()
    return time.perf_counter() - t0


def phase_batch(irefs, imovs, card, fails, niter=(25, 25), nscales=1):
    """register_batch (auto and vmap) against single-pair register."""
    import jax.numpy as jnp

    from opticalflow2d_tpu import Method, RegConfig, register
    from opticalflow2d_tpu.engine.registration import _jitted_register
    from opticalflow2d_tpu.parallel.batch import (
        _jitted_batch, _resolve_impl, register_batch)
    from examples.demo import REGPARAMS

    # The batch drivers run the pyramid as one program, so the single-pair
    # reference does too (no two-phase halo fit).
    cfgs = {m: RegConfig.from_regparams(m, list(niter), nscales, REGPARAMS[m],
                                        warp_halo_auto=False)
            for m in (Method.FLUID, Method.THIRIONS_DEMONS)}
    stacks = (jnp.asarray(irefs), jnp.asarray(imovs))
    single = (jnp.asarray(irefs[0]), jnp.asarray(imovs[0]))
    jobs = []
    for cfg in cfgs.values():
        jobs.append((_jitted_register(cfg, False, None, 0), single))
        for impl in ("auto", "vmap"):
            jobs.append((_jitted_batch(cfg, None, _resolve_impl(cfg, impl),
                                       False), stacks))
    print(f"  compiled {len(jobs)} programs side by side in "
          f"{_compile_together(jobs):.3f} s", flush=True)

    for method, cfg in cfgs.items():
        singles = np.stack([np.asarray(register(r, m, cfg).motion)
                            for r, m in zip(irefs, imovs)])
        for impl in ("auto", "vmap"):
            resolved = _resolve_impl(cfg, impl)
            t0 = time.perf_counter()
            res = register_batch(*stacks, cfg, impl=impl)
            u = np.asarray(res.motion)
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            np.asarray(register_batch(*stacks, cfg, impl=impl).motion)
            warm = time.perf_counter() - t0
            diff = float(np.abs(u - singles).max())
            print(f"  {method.name:21s} batch {len(irefs)} impl={impl}"
                  f"->{resolved}  max|du| vs single {diff:.3e} px  "
                  f"first {first:.3f} s  warm {warm:.3f} s "
                  f"({len(irefs) / warm:.1f} reg/s)  [{card}]", flush=True)
            _check(fails, np.isfinite(u).all(),
                   f"{method.name}: non-finite batch")
            if resolved == "map":
                _check(fails, diff == 0.0,
                       f"{method.name}: map batch not bit-equal ({diff})")
            else:
                _check(fails, diff <= TOL_PX,
                       f"{method.name}: vmap batch max|du| {diff}")


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", -1)


def phase_large(card, fails, n_diffeo=4096, n_thirion=16384,
                niter=(25, 25, 25), nscales=2):
    """Diffeomorphic demons through register() (the two-phase halo path)
    and Thirion demons through the session (routed to register_phased past
    8192), with no CPU comparison: a CPU run at these sizes takes too
    long."""
    import jax
    import jax.numpy as jnp

    from opticalflow2d_tpu import Method, OpticalFlow2d, RegConfig, register
    from opticalflow2d_tpu.metrics import ssd_reduction
    from examples.demo import REGPARAMS, synthesize_pair_jax

    dev = jax.devices()[0]
    print("  (no CPU comparison at these sizes: a CPU run would take too "
          "long; checks are finite motion and falling SSD)")

    iref, imov = synthesize_pair_jax(n_diffeo, seed=5)
    method = Method.DIFFEOMORPHIC_DEMONS
    cfg = RegConfig.from_regparams(method, list(niter), nscales,
                                   REGPARAMS[method])
    t0 = time.perf_counter()
    res = register(iref, imov, cfg)
    u = jax.block_until_ready(res.motion)
    wall = time.perf_counter() - t0
    red = float(ssd_reduction(iref, imov, u))
    print(f"  {method.name} {n_diffeo}^2 nscales={nscales} via register(): "
          f"iters {[int(t.iterations) for t in res.traces]}  ssd-red "
          f"{red:.6f}  wall {wall:.3f} s  peak {_peak_bytes(dev)} bytes  "
          f"[{card}]", flush=True)
    _check(fails, bool(jnp.isfinite(u).all()), "diffeo: non-finite motion")
    _check(fails, red > 0, f"diffeo: SSD did not fall ({red})")
    del iref, imov, res, u

    iref, imov = synthesize_pair_jax(n_thirion, seed=6)
    method = Method.THIRIONS_DEMONS
    t0 = time.perf_counter()
    sess = OpticalFlow2d((n_thirion, n_thirion), niter=list(niter),
                         nscales=nscales, regularisation=method,
                         regparams=REGPARAMS[method])
    sess.register(iref, imov)
    u = jax.block_until_ready(sess.result.motion)
    wall = time.perf_counter() - t0
    red = float(ssd_reduction(iref, imov, u))
    iters = [int(t.iterations) for t in sess.result.traces]
    print(f"  {method.name} {n_thirion}^2 nscales={nscales} via session: "
          f"iters {iters}  ssd-red {red:.6f}  wall {wall:.3f} s  peak "
          f"{_peak_bytes(dev)} bytes  [{card}]", flush=True)
    _check(fails, bool(jnp.isfinite(u).all()), "thirion: non-finite motion")
    _check(fails, red > 0, f"thirion: SSD did not fall ({red})")
    sess.close()


def phase_four_cards(card, fails, n_batch=256, n_sp=2048, niter=(25, 25),
                     nscales=1):
    """The multi-card path against single-card results. The programs of
    each wave compile side by side first (``_compile_together``), then
    run one after another."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from opticalflow2d_tpu import Method, RegConfig, register
    from opticalflow2d_tpu.engine.registration import _jitted_register
    from opticalflow2d_tpu.parallel.batch import (
        _jitted_batch, _resolve_impl, register_batch)
    from opticalflow2d_tpu.parallel.dct_dist import make_curvature_step_sharded
    from opticalflow2d_tpu.parallel.mesh import make_mesh
    from opticalflow2d_tpu.parallel.spatial import make_register_sp
    from opticalflow2d_tpu.solvers.base import derivatives
    from opticalflow2d_tpu.solvers.curvature import make_curvature_step
    from examples.demo import REGPARAMS, synthesize_pair_jax

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have {devices}")
    devices = devices[:4]
    mesh_dp = make_mesh(data=4, devices=devices)
    mesh_x = make_mesh(x=4, devices=devices)

    irefs, imovs = batch_pairs(n_batch, 32)
    stacks = (jnp.asarray(irefs), jnp.asarray(imovs))
    dp_cfgs = {m: RegConfig.from_regparams(m, list(niter), nscales,
                                           REGPARAMS[m], warp_halo_auto=False)
               for m in (Method.FLUID, Method.THIRIONS_DEMONS)}

    iref, imov = (np.asarray(a) for a in synthesize_pair_jax(n_sp, seed=7))
    pair = (jnp.asarray(iref), jnp.asarray(imov))
    families = {
        "diffusion": (Method.DIFFUSION, dict(alpha=0.5)),
        "curvature": (Method.CURVATURE, dict(alpha=0.1, tau=1.0)),
        "elastic": (Method.ELASTIC, dict(mu=0.5, lam=0.0)),
        "thirions": (Method.THIRIONS_DEMONS, dict(
            sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0, sigma_fluid=2.0,
            kernelwidth=5)),
        "diffeo": (Method.DIFFEOMORPHIC_DEMONS, dict(
            sigma_i=1.0, sigma_x=0.25, sigma_diffusion=2.0, sigma_fluid=2.0,
            kernelwidth=5)),
        "fluid": (Method.FLUID, dict(mu=0.25, lam=0.0)),
    }
    serial_cfgs, sp_kws = {}, {}
    for fam, (method, kw) in families.items():
        sp_kw, serial_kw = dict(kw), dict(kw)
        if fam == "curvature":
            # Both sides at float32 precision, so the comparison measures
            # the sharding and not the transform's matmul precision.
            sp_kw["dct_precision"] = lax.Precision.HIGHEST
            serial_kw["dct_impl"] = "matmul"
        # The serial run takes the exact gather; the strip warps need a
        # halo that covers every displacement (their contract), fitted
        # below from the serial field as warp_halo_auto fits the outer
        # halo.
        serial_cfgs[fam] = RegConfig(
            method=method, niter=tuple(niter), nscales=nscales, warp_halo=0,
            warp_halo_outer=0, warp_halo_auto=False, **serial_kw)
        sp_kws[fam] = sp_kw

    # The distributed-DCT curvature step (two all_to_alls) and its serial
    # counterpart.
    d = derivatives(*pair)
    u0 = jnp.zeros((2, n_sp, n_sp), jnp.float32)
    step_sp = jax.jit(make_curvature_step_sharded(
        mesh_x, n_sp, n_sp, 0.1, 1.0, precision=lax.Precision.HIGHEST))
    step_ser = jax.jit(make_curvature_step(n_sp, n_sp, 0.1, 1.0,
                                           dct_impl="matmul"))

    jobs = [(step_sp, (u0, d.grad_i, d.it)), (step_ser, (u0, d))]
    for cfg in dp_cfgs.values():
        impl = _resolve_impl(cfg, "auto")
        jobs.append((_jitted_batch(cfg, None, impl, False), stacks))
        jobs.append((_jitted_batch(cfg, mesh_dp, impl, False), stacks))
    jobs += [(_jitted_register(cfg, False, None, 0), pair)
             for cfg in serial_cfgs.values()]
    print(f"  wave 1: compiled {len(jobs)} programs side by side in "
          f"{_compile_together(jobs):.3f} s", flush=True)

    # Data parallel: one batch over a 4-way data mesh vs one card.
    for method, cfg in dp_cfgs.items():
        one = np.asarray(register_batch(*stacks, cfg).motion)
        t0 = time.perf_counter()
        res = register_batch(*stacks, cfg, mesh=mesh_dp)
        u = jax.block_until_ready(res.motion)
        wall = time.perf_counter() - t0
        diff = float(np.abs(np.asarray(u) - one).max())
        print(f"  DP {method.name:21s} batch 32 on {u.sharding.device_set}: "
              f"max|du| vs one card {diff:.3e} px  wall {wall:.3f} s  "
              f"[{card}]", flush=True)
        _check(fails, len(u.sharding.device_set) == 4,
               "DP batch not on 4 cards")
        _check(fails, diff <= TOL_PX, f"DP {method.name}: max|du| {diff}")

    # Spatial sharding: the explicit-SP pyramid for every family, against
    # the serial register() on one card.
    serial, solvers = {}, {}
    for fam, cfg in serial_cfgs.items():
        res = register(*pair, cfg)
        u_ser_p = register(iref, perturbed(imov), cfg).motion
        halo = max(2, math.ceil(float(jnp.max(jnp.abs(res.motion)))) + 1)
        serial[fam] = (res, u_ser_p, halo)
        solvers[fam] = make_register_sp(mesh_x, fam, niter=list(niter),
                                        nscales=nscales, halo=halo,
                                        **sp_kws[fam])
    jobs = [(solve, pair) for solve in solvers.values()]
    print(f"  wave 2: compiled {len(jobs)} programs side by side in "
          f"{_compile_together(jobs):.3f} s", flush=True)
    for fam, solve in solvers.items():
        res, u_ser_p, halo = serial[fam]
        t0 = time.perf_counter()
        u_sp, iters = solve(*pair)
        u_sp = jax.block_until_ready(u_sp)
        wall = time.perf_counter() - t0
        diff, diff_well, ill, sens = compare_fields(
            fails, f"SP {fam}", np.moveaxis(np.asarray(u_sp), 0, -1),
            np.moveaxis(np.asarray(res.motion), 0, -1),
            np.moveaxis(np.asarray(u_ser_p), 0, -1))
        it_sp = [int(v) for v in np.asarray(iters)]
        it_ser = [int(t.iterations) for t in res.traces]
        peaks = [_peak_bytes(dv) for dv in devices]
        print(f"  SP {fam:10s} {n_sp}^2 halo {halo} on "
              f"{u_sp.sharding.device_set}: "
              f"iters {it_sp} (serial {it_ser})  max|du| {diff:.3e} px, "
              f"{diff_well:.3e} where determined ({ill:.4%} not; serial "
              f"self-sensitivity {sens:.3e})  "
              f"wall {wall:.3f} s  per-card peak bytes {peaks}  [{card}]",
              flush=True)
        _check(fails, len(u_sp.sharding.device_set) == 4,
               f"SP {fam} not on 4 cards")
        _check(fails, it_sp == it_ser,
               f"SP {fam}: iterations {it_sp} vs {it_ser}")

    u_dct = jax.block_until_ready(step_sp(u0, d.grad_i, d.it))
    u_ser = step_ser(u0, d)
    scale = float(jnp.max(jnp.abs(u_ser)))
    diff = float(jnp.max(jnp.abs(jnp.asarray(u_dct) - u_ser)))
    print(f"  dct_dist {n_sp}^2 on {u_dct.sharding.device_set}: max|du| "
          f"{diff:.3e} (max|u| {scale:.3e})  [{card}]", flush=True)
    _check(fails, len(u_dct.sharding.device_set) == 4,
           "dct_dist not on 4 cards")
    _check(fails, diff <= 1e-5 * max(scale, 1.0), f"dct_dist max|du| {diff}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card data/spatial sharding path")
    args = p.parse_args(argv)

    import jax
    import jaxlib

    from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache
    from opticalflow2d_tpu.utils.device import (
        nvidia_smi_lines, parse_nvidia_smi, require_gpu)

    devices = require_gpu()
    cache = enable_compile_cache()
    smi = nvidia_smi_lines()
    card = "; ".join(smi)
    dev = devices[0]
    for line in smi:
        parse_nvidia_smi(line)  # raises unless a name and a limit in watts
        print(line)
    print(f"device_kind: {dev.device_kind}  devices: {len(devices)}")
    print(f"jax {jax.__version__}  jaxlib {jaxlib.__version__}")
    print(f"compile cache: {cache}", flush=True)

    t_all = time.perf_counter()
    if args.four_cards:
        phases = [("four cards", lambda f: phase_four_cards(card, f))]
    else:
        phases = [
            ("session, six families at 534x512",
             lambda f: phase_session(*demo_pair(), card, f)),
            ("batch, 32 pairs at 256^2",
             lambda f: phase_batch(*batch_pairs(256, 32), card, f)),
            ("large single pairs", lambda f: phase_large(card, f)),
        ]
    fails = []
    for name, run in phases:
        print(f"phase: {name}", flush=True)
        try:
            run(fails)
        except Exception:  # record it, run the next phase, exit non-zero
            traceback.print_exc()
            fails.append(f"phase {name!r} raised")
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    if fails:
        print(f"{len(fails)} check(s) failed:", *fails, sep="\n  ",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
