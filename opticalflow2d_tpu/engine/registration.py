"""The registration driver: multi-resolution pyramid, refinement loops,
convergence-gated iteration, and fluid regridding.

Control flow mirrors the reference exactly (SURVEY.md §3.2):

    for s = nscales .. 0:                  # coarse -> fine (Python loop;
        motion init per the reference's      each level is a distinct static
        down/upsample quirk                  shape under one jit)
        for refine in range(nrefine):      # static unroll
            warp, derive (variational/fluid: once; demons: every iteration)
            lax.while_loop:                # iterate until niter or rel-step
                solver step                  norm < tol after iter > 1
                (fluid: + regrid cond)       (reference ImageRegistration-
            compose u <- u o u_est           OpticalFlow.cpp:97-151)
        upsample to full res

The convergence monitor reproduces the reference ``Logger`` semantics
(``src/Logger.cpp:32-58``): ``err_k = |u_k - u_{k-1}| / |u_{k-1}|`` with
``|.|`` the mean per-pixel magnitude, ``err = 0`` when the previous norm is
zero, early stop when ``err < 0.001`` and ``iter > 1``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from opticalflow2d_tpu.config import Method, MotionAccumulation, RegConfig
from opticalflow2d_tpu.ops.grid import jacobian_det
from opticalflow2d_tpu.ops.reduce import motion_norm
from opticalflow2d_tpu.ops.resample import (
    pyramid_dims,
    downsample_image,
    downsample_motion,
    upsample_motion,
)
from opticalflow2d_tpu.ops.warp import (
    warp2d,
    compose,
    _displacement_bounded,
    _sample_coords,
)
from opticalflow2d_tpu.solvers.base import (
    Derivatives,
    derivatives,
    stack_derivs,
)
from opticalflow2d_tpu.solvers.diffusion import diffusion_step
from opticalflow2d_tpu.solvers.curvature import make_curvature_step
from opticalflow2d_tpu.solvers.elastic import elastic_step
from opticalflow2d_tpu.solvers.fluid import make_fluid_step
from opticalflow2d_tpu.solvers.demons import make_demons_step


# Past this extent, fence the per-refinement derivatives from the
# iteration loop (see _loop_invariant_derivs).
_DERIV_BARRIER_MIN_EXTENT = 8192

# Output-row chunks for the host-chunked exact-gather outer warp of the
# stepped fluid driver (see _jitted_stepped.warp_outer_chunk).
_WARP_CHUNKS = 8


def _loop_invariant_derivs(d: Derivatives) -> Derivatives:
    """Fence the per-refinement derivatives from the iteration loop past
    ``_DERIV_BARRIER_MIN_EXTENT`` lanes with ``lax.optimization_barrier``.
    The barrier is semantically a no-op: the derivatives are
    loop-invariant, so the only fusion it prevents is a recompute into the
    loop. It belongs to the huge-grid residency machinery that ROADMAP
    design item 2 reviews."""
    if max(d.it.shape) <= _DERIV_BARRIER_MIN_EXTENT:
        return d
    gi, it_img = lax.optimization_barrier((d.grad_i, d.it))
    return Derivatives(gi, it_img)


class LevelTrace(NamedTuple):
    """Convergence trace of one (level, refinement) solve — the functional
    equivalent of the reference's ``Logger`` error array."""

    scale: jnp.ndarray       # static int wrapped as array for pytree-ness
    errors: jnp.ndarray      # [niter] relative step norms (0 past early stop)
    iterations: jnp.ndarray  # iterations actually executed
    regrids: jnp.ndarray     # fluid regrid count (0 for other methods)
    # Iterations whose motion exceeded warp_halo, forcing the runtime
    # exact-gather fallback (demons only; the slowdown is invisible
    # without this). 0 when halo fits or the method never re-warps
    # mid-level.
    fallbacks: jnp.ndarray | int = 0


class RegistrationResult(NamedTuple):
    motion: jnp.ndarray           # [2, nx, ny]
    traces: Tuple[LevelTrace, ...]  # ordered coarse -> fine, refine-major
    # Final coarsest-level field (the reference's motion[nscales]) — the
    # state a repeated register call continues from when
    # CompatFlags.persistent_motion is on (None for partial-pyramid runs
    # that skip the coarsest level).
    coarse_motion: jnp.ndarray | None = None


def _rel_step_error(u_new: jnp.ndarray, u_prev: jnp.ndarray) -> jnp.ndarray:
    prev_norm = motion_norm(u_prev)
    diff_norm = motion_norm(u_new - u_prev)
    return jnp.where(prev_norm == 0, 0.0, diff_norm / jnp.where(prev_norm == 0, 1.0, prev_norm))


def _print_iter(scale, it, err):
    print(f"  [scale {int(scale)}] iteration {int(it) + 1}: "
          f"relative error {float(err):.6f}", flush=True)


def _stream_iter(cfg: RegConfig, scale: int, it, err):
    """Live per-iteration trace, the reference Logger's verbose print
    (``src/Logger.cpp:62-79``). Emitted from inside the while_loop via
    ``jax.debug.callback`` (ordered is unnecessary: the loop is sequential)."""
    if cfg.verbose_stream:
        jax.debug.callback(_print_iter, jnp.int32(scale), it, err)


def _make_navier_lame_spectral(cfg: RegConfig, nx: int, ny: int):
    """Resolve the spectral Navier-Lame solver for elastic/fluid:
    "spectral" = periodic rfft2 solve; "spectral_dirichlet" = DST-I solve
    of the reference's interior-point Dirichlet system (its SOR fixed
    point, including the asymmetric-stencil compat flag)."""
    if cfg.navier_lame_solver == "spectral_dirichlet":
        from opticalflow2d_tpu.solvers.navier_lame import (
            make_dirichlet_navier_lame_solver,
        )

        return make_dirichlet_navier_lame_solver(
            nx, ny, cfg.mu, cfg.lam, cfg.jnp_dtype,
            reference_stencil=cfg.compat.elastic_stencil_reference,
        )
    from opticalflow2d_tpu.solvers.navier_lame import (
        make_spectral_navier_lame_solver,
    )

    return make_spectral_navier_lame_solver(nx, ny, cfg.mu, cfg.lam, cfg.jnp_dtype)


def _solve_level_variational(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Diffusion / Curvature / Elastic: derivatives once per refinement,
    update-only iterations (reference ImageRegistrationOpticalFlow.cpp:97-151)."""
    nx, ny = iref.shape
    if cfg.method == Method.DIFFUSION:
        step = lambda u_est, d: diffusion_step(u_est, d, cfg.alpha)
    elif cfg.method == Method.CURVATURE:
        step = (lambda s: (lambda u_est, d: s(u_est, d)))(
            make_curvature_step(
                nx, ny, cfg.alpha, cfg.tau, cfg.jnp_dtype, cfg.resolved_dct_impl
            )
        )
    elif cfg.method == Method.ELASTIC:
        if cfg.navier_lame_solver in ("spectral", "spectral_dirichlet"):
            from opticalflow2d_tpu.solvers.base import lssd_force

            solve = _make_navier_lame_spectral(cfg, nx, ny)
            step = lambda u_est, d: solve(lssd_force(d, u_est))
        else:
            step = lambda u_est, d: elastic_step(
                u_est, d, cfg.mu, cfg.lam, cfg.omega,
                cfg.compat.elastic_stencil_reference,
                cfg.sor_ordering,
            )
    else:  # pragma: no cover
        raise ValueError(cfg.method)

    traces = []
    for _refine in range(cfg.nrefine):
        iaux = warp2d(imov, u, cfg.warp_halo_outer)
        d = _loop_invariant_derivs(derivatives(iref, iaux))

        def cond(carry):
            _, _, it, conv, _ = carry
            return (it < niter) & ~conv

        def body(carry):
            u_est, prev, it, conv, errs = carry
            u_new = step(u_est, d)
            err = _rel_step_error(u_new, prev)
            _stream_iter(cfg, scale, it, err)
            errs = errs.at[it].set(err)
            conv = (err < cfg.convergence_tol) & (it > 1)
            return (u_new, u_new, it + 1, conv, errs)

        u0 = jnp.zeros_like(u)
        errs0 = jnp.zeros((niter,), u.dtype)
        carry = (u0, u0, jnp.int32(0), jnp.bool_(False), errs0)
        u_est, _, it, _, errs = lax.while_loop(cond, body, carry)
        u = compose(u, u_est, cfg.warp_halo_outer)
        traces.append(LevelTrace(jnp.int32(scale), errs, it, jnp.int32(0)))
    return u, traces


def _solve_level_fluid(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Fluid: persistent velocity (per level, across refinements), adaptive
    timestep, Jacobian-triggered regridding
    (reference ImageRegistrationFluid.cpp:67-142)."""
    spectral_solve = None
    if cfg.navier_lame_solver in ("spectral", "spectral_dirichlet"):
        nx, ny = iref.shape
        spectral_solve = _make_navier_lame_spectral(cfg, nx, ny)
    step = make_fluid_step(
        cfg.mu, cfg.lam, cfg.omega,
        dumax=cfg.dumax,
        timestep_skip=cfg.timestep_skip,
        maxabs_bug=cfg.compat.maxabs_bug,
        reference_stencil=cfg.compat.elastic_stencil_reference,
        sor_ordering=cfg.sor_ordering,
        spectral_solve=spectral_solve,
    )

    velocity = jnp.zeros_like(u)
    traces = []
    for _refine in range(cfg.nrefine):
        iaux = warp2d(imov, u, cfg.warp_halo_outer)
        d = _loop_invariant_derivs(derivatives(iref, iaux))

        def cond(carry):
            it, conv = carry[-4], carry[-3]
            return (it < niter) & ~conv

        def body(carry):
            u_tot, u_est, prev, vel, grad_i, it_img, it, conv, errs, nregrid = carry
            u_new, vel, _dt = step(u_est, vel, Derivatives(grad_i, it_img))
            # `prev` is the Logger's state: the last *logged* estimate. It is
            # NOT reset by regridding (the reference's Logger lives outside
            # the regrid block, ImageRegistrationFluid.cpp:99-124), so it is
            # carried separately from u_est.
            err = _rel_step_error(u_new, prev)
            _stream_iter(cfg, scale, it, err)
            prev = u_new
            errs = errs.at[it].set(err)
            conv = (err < cfg.convergence_tol) & (it > 1)

            # Regridding runs only when the convergence break did not fire
            # (it sits after the break in the reference loop,
            # ImageRegistrationFluid.cpp:101-124).
            jac_min = jnp.min(jacobian_det(u_new))
            do_regrid = ~conv & (jac_min < cfg.regrid_threshold)

            def regrid(args):
                u_tot, u_new, grad_i, it_img = args
                u_tot2 = compose(u_tot, u_new, cfg.warp_halo_outer)
                iaux2 = warp2d(imov, u_tot2, cfg.warp_halo_outer)
                d2 = derivatives(iref, iaux2)
                return u_tot2, jnp.zeros_like(u_new), d2.grad_i, d2.it

            def no_regrid(args):
                return args

            u_tot, u_new, grad_i, it_img = lax.cond(
                do_regrid, regrid, no_regrid, (u_tot, u_new, grad_i, it_img)
            )
            nregrid = nregrid + do_regrid.astype(jnp.int32)
            return (u_tot, u_new, prev, vel, grad_i, it_img, it + 1, conv, errs, nregrid)

        u0 = jnp.zeros_like(u)
        errs0 = jnp.zeros((niter,), u.dtype)
        carry = (
            u, u0, u0, velocity, d.grad_i, d.it,
            jnp.int32(0), jnp.bool_(False), errs0, jnp.int32(0),
        )
        u, u_est, _, velocity, _, _, it, _, errs, nregrid = lax.while_loop(cond, body, carry)
        u = compose(u, u_est, cfg.warp_halo_outer)
        traces.append(LevelTrace(jnp.int32(scale), errs, it, nregrid))
    return u, traces


def _solve_level_demons(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    """Thirion / diffeomorphic demons: the solver re-warps and re-derives
    every iteration (reference ImageRegistrationDemons.cpp:86-137)."""
    # The Logger's "prev" is always the step's input (the last iterate),
    # so the relative error comes from the step's own Logger sums (one
    # fused elementwise pass). sums/N equals motion_norm bitwise.
    step = make_demons_step(
        cfg.sigma_i, cfg.sigma_x, cfg.sigma_diffusion, cfg.sigma_fluid,
        cfg.kernelwidth,
        diffeomorphic=(cfg.method == Method.DIFFEOMORPHIC_DEMONS),
        accumulation=cfg.accumulation,
        conv_flatwrap=cfg.compat.conv_flatwrap,
        maxabs_bug=cfg.compat.maxabs_bug,
        warp_halo=cfg.warp_halo,
        with_errors=True,
    )

    count_fallbacks = cfg.warp_halo > 0
    n_pix = u.shape[1] * u.shape[2]

    traces = []
    for _refine in range(cfg.nrefine):
        # Outer-warp fallback visibility: the refinement warp sees the
        # TOTAL motion — when it exceeds warp_halo_outer the warp silently
        # takes the exact gather.
        nfb0 = jnp.int32(0)
        if cfg.warp_halo_outer > 0:
            pxo, pyo = _sample_coords(u)
            nfb0 = (~_displacement_bounded(
                imov[None], pxo, pyo, cfg.warp_halo_outer)).astype(jnp.int32)
        iaux = warp2d(imov, u, cfg.warp_halo_outer)

        def cond(carry):
            _, it, conv, _, _ = carry
            return (it < niter) & ~conv

        def body(carry):
            u_est, it, conv, errs, nfb = carry
            if count_fallbacks:
                # The same predicate the step's lax.cond evaluates: count
                # the iterations that take the exact-gather fallback so an
                # undersized warp_halo is visible in the trace instead of
                # a silent slowdown (ops.warp._bilinear_gather).
                px, py = _sample_coords(u_est)
                bounded = _displacement_bounded(
                    iaux[None], px, py, cfg.warp_halo)
                nfb = nfb + (~bounded).astype(jnp.int32)
            u_new, sums = step(u_est, iref, iaux)
            dn = sums[0] / n_pix
            pn = sums[1] / n_pix
            err = jnp.where(pn == 0, 0.0, dn / jnp.where(pn == 0, 1.0, pn))
            _stream_iter(cfg, scale, it, err)
            errs = errs.at[it].set(err)
            conv = (err < cfg.convergence_tol) & (it > 1)
            return (u_new, it + 1, conv, errs, nfb)

        u0 = jnp.zeros_like(u)
        errs0 = jnp.zeros((niter,), u.dtype)
        carry = (u0, jnp.int32(0), jnp.bool_(False), errs0, nfb0)
        u_est, it, _, errs, nfb = lax.while_loop(cond, body, carry)
        u = compose(u, u_est, cfg.warp_halo_outer)
        traces.append(LevelTrace(jnp.int32(scale), errs, it, jnp.int32(0),
                                 fallbacks=nfb))
    return u, traces


def _solve_level(u, iref, imov, cfg: RegConfig, niter: int, scale: int):
    if cfg.method in (Method.DIFFUSION, Method.CURVATURE, Method.ELASTIC):
        return _solve_level_variational(u, iref, imov, cfg, niter, scale)
    if cfg.method == Method.FLUID:
        return _solve_level_fluid(u, iref, imov, cfg, niter, scale)
    return _solve_level_demons(u, iref, imov, cfg, niter, scale)


# ---------------------------------------------------------------------------
# Host-stepped level driver (huge grids)
# ---------------------------------------------------------------------------
#
# One XLA program per iteration, with the Logger stop check and the fluid
# regrid decision made on the HOST between programs — structurally the
# reference's own C++ level loop (ImageRegistrationOpticalFlow.cpp:97-151,
# ImageRegistrationFluid.cpp:67-142, ImageRegistrationDemons.cpp:86-137),
# where every iteration is a sequence of host calls too. The programs are
# split so that no two large sets of temporaries coexist, which bounds the
# device memory a 16384^2 level needs. register_phased routes curvature,
# fluid and diffeomorphic demons here past 8192 lanes. Whether this
# residency machinery is still needed on a large-memory card is ROADMAP
# design item 2.

def _make_var_single_step(cfg: RegConfig, nx: int, ny: int):
    """Single variational update step (u_est, d) -> u_new for the stepped
    driver: the step selection of _solve_level_variational."""
    if cfg.method == Method.DIFFUSION:
        return lambda u_est, d: diffusion_step(u_est, d, cfg.alpha)
    if cfg.method == Method.CURVATURE:
        step = make_curvature_step(
            nx, ny, cfg.alpha, cfg.tau, cfg.jnp_dtype, cfg.resolved_dct_impl
        )
        return lambda u_est, d: step(u_est, d)
    if cfg.method == Method.ELASTIC:
        if cfg.navier_lame_solver in ("spectral", "spectral_dirichlet"):
            from opticalflow2d_tpu.solvers.base import lssd_force

            solve = _make_navier_lame_spectral(cfg, nx, ny)
            return lambda u_est, d: solve(lssd_force(d, u_est))
        return lambda u_est, d: elastic_step(
            u_est, d, cfg.mu, cfg.lam, cfg.omega,
            cfg.compat.elastic_stencil_reference, cfg.sor_ordering,
        )
    raise ValueError(cfg.method)  # pragma: no cover


@functools.lru_cache(maxsize=32)
def _jitted_stepped(cfg: RegConfig):
    """The per-iteration programs of the host-stepped driver, one jitted
    callable each (shape-specialized on first call per shape)."""
    ho = cfg.warp_halo_outer

    def prederive(imov, u, iref):
        iaux = warp2d(imov, u, ho)
        d = derivatives(iref, iaux)
        return iaux, d.grad_i, d.it

    def prederive_stacked(imov, u, iref):
        # Fluid variant: emit the derivatives prestacked as [3, nx, ny], so
        # no per-iteration 3-plane concat (3 GB at 16384^2).
        iaux = warp2d(imov, u, ho)
        d = derivatives(iref, iaux)
        return stack_derivs(d.grad_i, d.it)

    def warp_outer_chunk(acc, imov, u, r0):
        # One output-row chunk of the exact-gather outer warp, ``r0``
        # traced (one compilation serves every chunk). Huge grids would
        # otherwise run the whole-plane exact gather inside one program —
        # ~8 GB of index/tap temporaries at 16384^2. Same expressions as
        # warp2d's exact path.
        chunk = acc.shape[0] // _WARP_CHUNKS
        nxg, nyg = imov.shape
        u_rows = lax.dynamic_slice(u, (0, r0, 0), (2, chunk, u.shape[2]))
        gi = (lax.broadcasted_iota(jnp.float32, (chunk, nyg), 0)
              + r0.astype(jnp.float32))
        gj = lax.broadcasted_iota(jnp.float32, (chunk, nyg), 1)
        px = gi + u_rows[0]
        py = gj + u_rows[1]
        from opticalflow2d_tpu.ops.warp import (
            _bilinear_from_taps, _gather_taps_exact)

        value, weight, in_b = _bilinear_from_taps(
            imov[None], px, py, _gather_taps_exact)
        ok = in_b & (weight != 0)
        safe_w = jnp.where(weight != 0, weight, 1.0)
        imov_rows = lax.dynamic_slice(imov, (r0, 0), (chunk, nyg))
        rows = jnp.where(ok, value[0] / safe_w, imov_rows)
        return lax.dynamic_update_slice(acc, rows, (r0, 0))

    def derive_stack(iref, iaux):
        d = derivatives(iref, iaux)
        return stack_derivs(d.grad_i, d.it)

    def warp_outer(imov, u):
        return warp2d(imov, u, ho)

    def var_step(u_est, grad_i, it_img):
        # The monolithic variational carry keeps prev == the step input
        # (body returns (u_new, u_new, ...)), so the error is vs u_est —
        # no separate prev plane. u_est is donated: at 16384^2 each
        # motion plane is 1 GB.
        d = Derivatives(grad_i, it_img)
        step = _make_var_single_step(cfg, *u_est.shape[1:])
        u_new = step(u_est, d)
        return u_new, _rel_step_error(u_new, u_est)

    def _curv_rhs_c(u_est, grad_i, it_img, c: int):
        # Curvature iteration, programs 1/3 of 5: force + rhs for ONE
        # component. The iteration is split so the spectral intermediates
        # never coexist with each other or with the force temporaries:
        # both the L-SSD force and the
        # DCT are per-plane separable, so each component flows through
        # rhs -> solve alone at half the residency. Expressions match
        # lssd_force per component (OpticalFlow.cpp:15-39). u_est is NOT
        # donated (the convergence error needs it in the finish program).
        inner = it_img + u_est[0] * grad_i[0] + u_est[1] * grad_i[1]
        # emitted as [1, nx, ny] so the phase programs consume it without
        # a host-side reshape copy
        return (u_est[c] - cfg.tau * (grad_i[c] * inner))[None]

    def curv_rhs_x(u_est, grad_i, it_img):
        return _curv_rhs_c(u_est, grad_i, it_img, 0)

    def curv_rhs_y(u_est, grad_i, it_img):
        return _curv_rhs_c(u_est, grad_i, it_img, 1)

    from opticalflow2d_tpu.solvers.curvature import (
        make_curvature_solve_phases,
    )

    # The spectral solve of one component as per-axis phase programs
    # (fwd-y | fwd-x | eig | inv-y | inv-x+scale for the split impls), so
    # the transposes, recursion temporaries, and the eigenvalue table do
    # not coexist (see make_curvature_solve_phases). Each phase donates
    # its input. Applied on [1, nx, ny] (per-plane identical to the
    # 2-channel solve — the transform matmuls batch over the leading
    # axis).
    curv_phases = tuple(
        jax.jit(f, donate_argnums=(0,))
        for f in make_curvature_solve_phases(
            cfg.alpha, cfg.tau, cfg.jnp_dtype, cfg.resolved_dct_impl)
    )

    def curv_finish(u_x, u_y, u_est):
        # Final curvature program: reassemble ([1, nx, ny] components)
        # + Logger error.
        u_new = jnp.concatenate([u_x, u_y], axis=0)
        return u_new, _rel_step_error(u_new, u_est)

    # --- split demons programs (dynamic-exp-map diffeo on huge grids) ---
    # A single-program demons iteration holds warp + derivative + force +
    # smooth temporaries at once. The split runs the
    # reference loop at program granularity: correspondence program, ONE
    # scalar maxabs readback, nsq host-counted squaring programs (the
    # EXACT dynamic semantics of Motion.cpp:253-277 — the host computes
    # ceil(1+log2(maxabs)) in double just like the C++), then the
    # accumulate+smooth program with in-program Logger sums.

    def demons_corr(u_est, iref, iaux):
        from opticalflow2d_tpu.ops.conv import gaussian_smooth
        from opticalflow2d_tpu.solvers.base import demons_force

        fb = jnp.int32(0)
        if cfg.warp_halo > 0:
            px, py = _sample_coords(u_est)
            fb = (~_displacement_bounded(
                iaux[None], px, py, cfg.warp_halo)).astype(jnp.int32)
        iwar = warp2d(iaux, u_est, cfg.warp_halo)
        d = derivatives(iref, iwar)
        c = demons_force(d, cfg.sigma_i, cfg.sigma_x)
        c = gaussian_smooth(c, cfg.sigma_fluid, cfg.kernelwidth,
                            flatwrap=cfg.compat.conv_flatwrap)
        return c, fb

    def demons_maxabs(c):
        from opticalflow2d_tpu.ops.reduce import motion_maxabs

        return motion_maxabs(c, bug=cfg.compat.maxabs_bug)

    def demons_scale(c, s):
        return c * s

    def demons_square(v):
        return compose(v, v, cfg.warp_halo)

    def _demons_accumulate(u_est, c):
        diffeo = cfg.method == Method.DIFFEOMORPHIC_DEMONS
        if diffeo or cfg.accumulation == MotionAccumulation.COMPOSITION:
            return compose(u_est, c, cfg.warp_halo)
        return u_est + c

    def demons_update(u_est, c):
        from opticalflow2d_tpu.ops.conv import gaussian_smooth
        from opticalflow2d_tpu.solvers.demons import logger_sums

        u_new = _demons_accumulate(u_est, c)
        u_new = gaussian_smooth(u_new, cfg.sigma_diffusion, cfg.kernelwidth,
                                flatwrap=cfg.compat.conv_flatwrap)
        sums = logger_sums(u_new, u_est)
        n_pix = u_est.shape[1] * u_est.shape[2]
        dn = sums[0] / n_pix
        pn = sums[1] / n_pix
        err = jnp.where(pn == 0, 0.0, dn / jnp.where(pn == 0, 1.0, pn))
        return u_new, err

    # Split update for huge extents: accumulate, per-component diffusion
    # smooth, then the Logger program, so the whole-plane smooth's
    # separable-pass temporaries on [2, 16384, 16384] never sit next to
    # the level state. Per-component
    # smoothing is expression-identical (the conv operates on trailing
    # axes).

    def demons_compose_split(u_est, c):
        uc = _demons_accumulate(u_est, c)
        return uc[0:1], uc[1:2]

    def demons_smooth_c(x):
        from opticalflow2d_tpu.ops.conv import gaussian_smooth

        return gaussian_smooth(x, cfg.sigma_diffusion, cfg.kernelwidth,
                               flatwrap=cfg.compat.conv_flatwrap)

    def demons_finish(u_x, u_y, u_est):
        from opticalflow2d_tpu.solvers.demons import logger_sums

        u_new = jnp.concatenate([u_x, u_y], axis=0)
        sums = logger_sums(u_new, u_est)
        n_pix = u_est.shape[1] * u_est.shape[2]
        dn = sums[0] / n_pix
        pn = sums[1] / n_pix
        err = jnp.where(pn == 0, 0.0, dn / jnp.where(pn == 0, 1.0, pn))
        return u_new, err

    def fluid_kernel(u_est, vel, g):
        # Fluid iteration, program 1 of 2: force + SOR sweep + material
        # derivative + maxabs (make_fluid_step's chain, reference
        # OpticalFlowFluid.cpp:123-140). Split from the Euler/Logger/
        # Jacobian tail so the tail's temporaries never coexist with the
        # sweep's.
        from opticalflow2d_tpu.ops.grid import partial_x, partial_y
        from opticalflow2d_tpu.ops.reduce import motion_maxabs
        from opticalflow2d_tpu.solvers.base import lssd_force
        from opticalflow2d_tpu.solvers.elastic import sor_sweep

        d = Derivatives(g[:2], g[2])
        f = lssd_force(d, u_est)
        if cfg.navier_lame_solver in ("spectral", "spectral_dirichlet"):
            vel = _make_navier_lame_spectral(cfg, *u_est.shape[1:])(f)
        else:
            vel = sor_sweep(vel, f, cfg.mu, cfg.lam, cfg.omega,
                            cfg.compat.elastic_stencil_reference,
                            cfg.sor_ordering)
        dudx = partial_x(u_est)
        dudy = partial_y(u_est)
        r = vel - dudx * vel[0:1] - dudy * vel[1:2]
        m = motion_maxabs(r, bug=cfg.compat.maxabs_bug)
        return vel, r, m

    def _fluid_tail_impl(u_est, prev, r, m):
        # Program 2 of 2: adaptive Euler step + Logger error + regrid
        # predicate (same expressions as solvers.fluid.make_fluid_step's
        # tail and the monolithic driver's jacobian check).
        dt = cfg.dumax / m
        do_step = dt < cfg.timestep_skip
        u_new = jnp.where(do_step,
                          u_est + r * jnp.where(do_step, dt, 0.0), u_est)
        err = _rel_step_error(u_new, prev)
        jac_min = jnp.min(jacobian_det(u_new))
        return u_new, err, jac_min

    def fluid_tail(u_est, r, m):
        # Common-path variant: the Logger prev IS the step input (the
        # last logged estimate) except right after a regrid — u_est and
        # r are donated (the host drops both handles).
        return _fluid_tail_impl(u_est, u_est, r, m)

    def fluid_tail_postregrid(u_est, prev, r, m):
        # Right after a regrid u_est was zeroed but the Logger prev keeps
        # the pre-regrid estimate (the Logger lives outside the regrid
        # block, ImageRegistrationFluid.cpp:99-124).
        return _fluid_tail_impl(u_est, prev, r, m)

    def compose_outer(u, u_est):
        # NOT donated: in the first refinement ``u`` is the caller's own
        # array (register_phased's u_s, a test's u0) — donating it would
        # delete a buffer the caller may still hold. The fluid regrid
        # reuses this program for its compose (ImageRegistrationFluid.
        # cpp:108-112) and the re-warp/re-derive runs as a second
        # prederive_stacked program with the stale derivatives freed in
        # between (one 3 GB plane of slack at 16384^2).
        return compose(u, u_est, ho)

    # Donation: at 16384^2 each motion field is 2 GB. u_est is donated
    # wherever the host provably drops its handle after the call (variational + common-path fluid:
    # prev == u_est, so no alias survives; demons: err comes from in-step
    # sums; post-regrid fluid: u_est is a fresh zeros buffer). The
    # velocity buffer is donated in both fluid variants.
    return {
        "prederive": jax.jit(prederive),
        "prederive_stacked": jax.jit(prederive_stacked),
        "warp_outer_chunk": jax.jit(warp_outer_chunk, donate_argnums=(0,)),
        "derive_stack": jax.jit(derive_stack),
        "warp_outer": jax.jit(warp_outer),
        "var_step": jax.jit(var_step, donate_argnums=(0,)),
        "curv_rhs_x": jax.jit(curv_rhs_x),
        "curv_rhs_y": jax.jit(curv_rhs_y),
        "curv_phases": curv_phases,
        "curv_finish": jax.jit(curv_finish, donate_argnums=(0, 1)),
        "demons_corr": jax.jit(demons_corr),
        "demons_maxabs": jax.jit(demons_maxabs),
        "demons_scale": jax.jit(demons_scale, donate_argnums=(0,)),
        "demons_square": jax.jit(demons_square, donate_argnums=(0,)),
        "demons_update": jax.jit(demons_update, donate_argnums=(0, 1)),
        "demons_compose_split": jax.jit(demons_compose_split),
        "demons_smooth_c": jax.jit(demons_smooth_c, donate_argnums=(0,)),
        "demons_finish": jax.jit(demons_finish, donate_argnums=(0, 1)),
        "fluid_kernel": jax.jit(fluid_kernel, donate_argnums=(1,)),
        "fluid_tail": jax.jit(fluid_tail, donate_argnums=(0, 1)),
        "fluid_tail_postregrid": jax.jit(fluid_tail_postregrid,
                                         donate_argnums=(0, 2)),
        "compose_outer": jax.jit(compose_outer),
    }


def _warp_outer_chunked(fns, imov, u_tot):
    """Host-chunked exact-gather outer warp for huge stepped levels (see
    _jitted_stepped.warp_outer_chunk): one program per output-row chunk.
    Values equal warp2d's exact-gather path (same expressions); the
    whole-plane exact gather's ~8 GB of index/tap temporaries never sit
    next to the level state."""
    nx = imov.shape[0]
    chunk = nx // _WARP_CHUNKS
    iaux = jnp.zeros_like(imov)
    for r0 in range(0, nx, chunk):
        iaux = fns["warp_outer_chunk"](iaux, imov, u_tot, jnp.int32(r0))
    return iaux


def _fluid_g_chunked(fns, imov, u_tot, iref):
    """Chunked warp + derivative stack for huge fluid levels."""
    return fns["derive_stack"](iref, _warp_outer_chunked(fns, imov, u_tot))


def _solve_level_stepped(u, iref, imov, cfg: RegConfig, niter: int,
                         scale: int):
    """Host-stepped level solve (see the section comment above): same
    semantics as _solve_level — same step math, same Logger stop check
    (src/Logger.cpp:32-58), same fluid regrid predicate and Logger-prev
    carry (ImageRegistrationFluid.cpp:99-124) — with the control flow on
    the host instead of inside lax.while_loop. Iterate/trace parity with
    the monolithic driver is test-pinned at small sizes
    (tests/test_registration.py::test_stepped_*)."""
    import numpy as np

    fns = _jitted_stepped(cfg)
    tol = cfg.convergence_tol
    demons = cfg.method in (Method.THIRIONS_DEMONS,
                            Method.DIFFEOMORPHIC_DEMONS)
    fluid = cfg.method == Method.FLUID
    traces = []
    velocity = jnp.zeros_like(u) if fluid else None
    for _refine in range(cfg.nrefine):
        errs = np.zeros((niter,), np.float64)
        nregrid = 0
        nfb = 0
        # Fluid at huge extents uses the CHUNKED outer warp: its level
        # carries velocity + prestacked derivatives, and the whole-plane
        # exact gather's ~8 GB of temporaries would sit next to that.
        # Curvature keeps the whole-plane gather. The
        # chunked path needs equal chunks (dynamic_slice CLAMPS
        # out-of-range starts while the chunk's coordinate iota does
        # not), hence the divisibility gate.
        fluid_chunked = (fluid
                         and max(u.shape[1:]) > _DERIV_BARRIER_MIN_EXTENT
                         and u.shape[1] % _WARP_CHUNKS == 0)
        if demons:
            if cfg.warp_halo_outer > 0:
                pxo, pyo = _sample_coords(u)
                nfb += int(~_displacement_bounded(
                    imov[None], pxo, pyo, cfg.warp_halo_outer))
                del pxo, pyo
            if (max(u.shape[1:]) > _DERIV_BARRIER_MIN_EXTENT
                    and u.shape[1] % _WARP_CHUNKS == 0):
                # Chunk the whole-plane exact-gather refinement warp, so its
                # temporaries never sit next to the iteration programs'.
                iaux = _warp_outer_chunked(fns, imov, u)
            else:
                iaux = fns["warp_outer"](imov, u)
        elif fluid:
            if fluid_chunked:
                g = _fluid_g_chunked(fns, imov, u, iref)
            else:
                g = fns["prederive_stacked"](imov, u, iref)
        else:
            iaux, grad_i, it_img = fns["prederive"](imov, u, iref)
            del iaux  # only the derivatives are consumed; frees a plane

        u_est = jnp.zeros_like(u)
        prev_sep = None  # fluid: a separate Logger prev exists only right after a regrid
        it = 0
        u_tot_level = u  # fluid: regridding folds into the level total
        while it < niter:
            if demons:
                # Split programs (see demons_corr): correspondence, then
                # for diffeo the reference's DYNAMIC exp map at program
                # granularity — one scalar maxabs readback, the squaring
                # count computed on the host exactly as Motion.cpp:
                # 265-268 does, nsq compose programs — then the
                # accumulate+smooth program with in-program Logger sums.
                c, fb = fns["demons_corr"](u_est, iref, iaux)
                nfb += int(fb)
                if cfg.method == Method.DIFFEOMORPHIC_DEMONS:
                    import math as _m

                    mval = float(fns["demons_maxabs"](c))
                    nsq = (max(0, _m.ceil(1.0 + _m.log2(mval)))
                           if mval > 0 else 0)
                    if nsq > 0:
                        barrier = (max(c.shape[1:])
                                   > _DERIV_BARRIER_MIN_EXTENT)
                        c = fns["demons_scale"](c, 2.0 ** -nsq)
                        if barrier:
                            float(jnp.sum(c[0, 0, :8]))
                        for _sq in range(nsq):
                            c = fns["demons_square"](c)
                            if barrier:
                                # At 16384^2 each enqueued squaring
                                # pre-allocates a 2 GB output before the
                                # previous one's input can free; one tiny
                                # scalar readback per program serializes
                                # the chain.
                                float(jnp.sum(c[0, 0, :8]))
                if max(c.shape[1:]) > _DERIV_BARRIER_MIN_EXTENT:
                    # Split update (see demons_compose_split); barriers
                    # keep one 2 GB output in flight at a time.
                    c_x, c_y = fns["demons_compose_split"](u_est, c)
                    del c
                    float(jnp.sum(c_x[0, 0, :8]))
                    u_x = fns["demons_smooth_c"](c_x)
                    del c_x
                    float(jnp.sum(u_x[0, 0, :8]))
                    u_y = fns["demons_smooth_c"](c_y)
                    del c_y
                    float(jnp.sum(u_y[0, 0, :8]))
                    u_new, err = fns["demons_finish"](u_x, u_y, u_est)
                    del u_x, u_y
                else:
                    u_new, err = fns["demons_update"](u_est, c)
                    del c
            elif fluid:
                velocity, r_inc, m = fns["fluid_kernel"](u_est, velocity, g)
                if prev_sep is None:
                    u_new, err, jac_min = fns["fluid_tail"](u_est, r_inc, m)
                else:
                    u_new, err, jac_min = fns["fluid_tail_postregrid"](
                        u_est, prev_sep, r_inc, m)
                    prev_sep = None
                del r_inc
            elif cfg.method == Method.CURVATURE:
                # One component in flight at a time, its spectral solve
                # phased per axis (rhs_c | fwd-y | fwd-x | eig | inv-y |
                # inv-x | ... | finish): the splits are what fit
                # curvature in HBM at 16384^2 (see _curv_rhs_c and
                # make_curvature_solve_phases).
                def _solve_component(x):
                    for ph in fns["curv_phases"]:
                        x = ph(x)
                    return x

                u_x = _solve_component(fns["curv_rhs_x"](u_est, grad_i,
                                                         it_img))
                u_y = _solve_component(fns["curv_rhs_y"](u_est, grad_i,
                                                         it_img))
                u_new, err = fns["curv_finish"](u_x, u_y, u_est)
                del u_x, u_y
            else:
                u_new, err = fns["var_step"](u_est, grad_i, it_img)
            err_f = float(err)
            errs[it] = err_f
            if cfg.verbose_stream:
                _print_iter(scale, it, err_f)
            conv = (err_f < tol) and (it > 1)
            if fluid and not conv and float(jac_min) < cfg.regrid_threshold:
                # The reference regrid block (ImageRegistrationFluid.cpp:
                # 108-124) as two host programs: fold the estimate into
                # the total, then re-warp + re-derive with the stale
                # derivatives freed first.
                u_tot_level = fns["compose_outer"](u_tot_level, u_new)
                g = None
                if fluid_chunked:
                    g = _fluid_g_chunked(fns, imov, u_tot_level, iref)
                else:
                    g = fns["prederive_stacked"](imov, u_tot_level, iref)
                # The Logger prev keeps the pre-regrid estimate
                # (ImageRegistrationFluid.cpp:99-124).
                prev_sep = u_new
                u_new = jnp.zeros_like(u_new)
                nregrid += 1
            u_est = u_new
            it += 1
            if conv:
                break

        # Refinement-scope inputs are dead before the level compose —
        # free them first (g alone is 3 GB at 16384^2).
        if demons:
            iaux = None
        elif fluid:
            g = None
        else:
            grad_i = it_img = None
        u = fns["compose_outer"](u_tot_level if fluid else u, u_est)
        traces.append(LevelTrace(
            jnp.int32(scale),
            jnp.asarray(errs, u.dtype),
            jnp.int32(it),
            jnp.int32(nregrid),
            fallbacks=jnp.int32(nfb),
        ))
    return u, traces


def _register_impl(
    iref: jnp.ndarray, imov: jnp.ndarray, cfg: RegConfig, initial_motion=None,
    start_scale=None, stop_scale=0, initial_coarse_motion=None,
):
    dtype = cfg.jnp_dtype
    iref = iref.astype(dtype)
    imov = imov.astype(dtype)
    dims = pyramid_dims(iref.shape, cfg.nscales)
    if min(dims[-1]) < 4:
        # The reference would index out of bounds here (dims are truncated
        # by 2^s with no validation); we fail loudly instead.
        raise ValueError(
            f"nscales={cfg.nscales} shrinks the coarsest level to "
            f"{dims[-1]}; every level needs at least 4 pixels per side"
        )

    # Each pyramid level is downsampled directly from full resolution, as the
    # reference does on set_reference_image/set_moving_image
    # (ImageRegistration.cpp:103-121).
    irefs = {0: iref}
    imovs = {0: imov}
    for s in range(1, cfg.nscales + 1):
        irefs[s] = downsample_image(iref, dims[s])
        imovs[s] = downsample_image(imov, dims[s])

    if initial_motion is not None:
        # Warm start (checkpoint resume / sequential registration): the
        # initial full-resolution field seeds the pyramid. Note a deliberate
        # deviation from the reference's repeated-register behavior: there,
        # motion[nscales] retains its stale per-level value from the previous
        # call (ImageRegistration.cpp:137-139 skips the downsample at
        # s == nscales); here the coarsest level is re-seeded by downsampling
        # the warm-start field, which is better-behaved and self-consistent.
        u_full = jnp.asarray(initial_motion, dtype)
    elif initial_coarse_motion is not None and cfg.nscales == 0:
        # Single-scale repeated-register continuation: the coarsest level
        # IS the full-resolution field (WrapperOpticalFlow2d.cpp:86-102).
        u_full = jnp.asarray(initial_coarse_motion, dtype)
    else:
        u_full = jnp.zeros((2,) + dims[0], dtype)
    if start_scale is None:
        start_scale = cfg.nscales
    traces = []
    coarse_final = None
    for s in range(start_scale, stop_scale - 1, -1):
        if s == cfg.nscales and s > 0:
            if initial_coarse_motion is not None:
                # Repeated-register warm continuation (CompatFlags.
                # persistent_motion): the reference never re-seeds
                # motion[nscales], so a second register call continues the
                # coarsest level from the previous call's coarse solution
                # (ImageRegistration.cpp:137-139).
                u_s = jnp.asarray(initial_coarse_motion, dtype)
            elif initial_motion is not None:
                u_s = downsample_motion(u_full, dims[s])
            else:
                # Coarsest level starts from zero: the reference skips the
                # motion downsample at s == nscales
                # (ImageRegistration.cpp:137-139).
                u_s = jnp.zeros((2,) + dims[s], dtype)
        elif 0 < s < cfg.nscales:
            u_s = downsample_motion(u_full, dims[s])
        else:  # s == 0
            u_s = u_full

        u_s, level_traces = _solve_level(
            u_s, irefs[s], imovs[s], cfg, int(cfg.niter[s]), s
        )
        traces.extend(level_traces)
        if s == cfg.nscales:
            coarse_final = u_s

        if s > 0:
            u_full = upsample_motion(u_s, dims[0])
        else:
            u_full = u_s

    return RegistrationResult(motion=u_full, traces=tuple(traces),
                              coarse_motion=coarse_final)


@functools.lru_cache(maxsize=64)
def _jitted_register(cfg: RegConfig, warm: bool, start_scale, stop_scale,
                     warm_coarse: bool = False):
    if warm_coarse:
        return jax.jit(
            lambda iref, imov, uc: _register_impl(
                iref, imov, cfg, None, start_scale, stop_scale,
                initial_coarse_motion=uc,
            )
        )
    if warm:
        return jax.jit(
            lambda iref, imov, u0: _register_impl(
                iref, imov, cfg, u0, start_scale, stop_scale
            )
        )
    return jax.jit(
        lambda iref, imov: _register_impl(
            iref, imov, cfg, None, start_scale, stop_scale
        )
    )


def register(
    iref, imov, cfg: RegConfig, initial_motion=None,
    start_scale=None, stop_scale=0, initial_coarse_motion=None,
) -> RegistrationResult:
    """Estimate the motion field u with T(x + u) ~= R(x).

    Args:
      iref: reference image ``[nx, ny]``.
      imov: moving image ``[nx, ny]``.
      cfg: registration configuration (static; one XLA compilation per
        distinct (cfg, shape)).
      initial_motion: optional ``[2, nx, ny]`` warm-start field (checkpoint
        resume, sequential frames): the full-resolution field seeds every
        pyramid level by downsampling (self-consistent warm start).
      initial_coarse_motion: optional coarsest-level field — the
        reference's repeated-register semantics, where ONLY
        ``motion[nscales]`` persists across calls (the coarsest downsample
        is skipped, ImageRegistration.cpp:137-139). Used by the session
        object under ``CompatFlags.persistent_motion``. Mutually exclusive
        with ``initial_motion``.
      start_scale / stop_scale: run only pyramid scales
        ``start_scale .. stop_scale`` (inclusive, coarse -> fine; defaults
        cover the whole pyramid). With ``start_scale < cfg.nscales`` pass the
        full-resolution motion of the completed coarser levels as
        ``initial_motion`` — this is the checkpoint-resume path
        (``utils.checkpoint.register_resumable``); splitting a pyramid at
        level boundaries matches the monolithic run to float associativity
        (XLA fuses across monolithic level boundaries; ~1 ulp).

    Returns:
      ``RegistrationResult(motion=[2, nx, ny], traces=...)``.
    """
    iref = jnp.asarray(iref)
    imov = jnp.asarray(imov)
    if iref.shape != imov.shape or iref.ndim != 2:
        raise ValueError(
            f"iref/imov must be matching 2D images, got {iref.shape} vs {imov.shape}"
        )
    if start_scale is not None and not 0 <= start_scale <= cfg.nscales:
        raise ValueError(f"start_scale {start_scale} outside 0..{cfg.nscales}")
    if not 0 <= stop_scale <= (cfg.nscales if start_scale is None else start_scale):
        raise ValueError(f"stop_scale {stop_scale} outside the pyramid range")
    if (cfg.warp_halo_auto and cfg.nscales >= 1 and start_scale is None
            and stop_scale == 0 and initial_motion is None
            and initial_coarse_motion is None):
        # Two-phase auto halo (config.warp_halo_auto): coarse levels with
        # the configured halos (small grids — a fallback there is cheap),
        # one scalar readback of the upsampled coarse motion's max
        # component, then the full-resolution level with a fitted OUTER
        # halo. The outer halo is the knob that matters: the driver-level
        # warps/composes see the TOTAL motion, and when it overshoots the
        # outer halo they silently take the exact gather. The
        # per-iteration solver halo sees only level increments (the level
        # loop estimates relative to the refinement warp), stays at its
        # configured value, and is fallback-counted.
        import dataclasses as _dc
        import math as _math

        base = _dc.replace(cfg, warp_halo_auto=False)
        coarse = register(iref, imov, base, stop_scale=1)
        maxu = float(jnp.max(jnp.abs(coarse.motion)))
        h_out = max(cfg.warp_halo_outer, min(7, _math.ceil(maxu + 0.5)))
        fitted = _dc.replace(base, warp_halo_outer=h_out)
        fine = register(iref, imov, fitted, initial_motion=coarse.motion,
                        start_scale=0)
        return RegistrationResult(
            motion=fine.motion,
            traces=coarse.traces + fine.traces,
            coarse_motion=coarse.coarse_motion,
        )

    if initial_coarse_motion is not None:
        if initial_motion is not None:
            raise ValueError(
                "initial_motion and initial_coarse_motion are mutually "
                "exclusive (full-res warm start vs reference repeated-"
                "register continuation)"
            )
        dims = pyramid_dims(iref.shape, cfg.nscales)
        uc = jnp.asarray(initial_coarse_motion)
        if uc.shape != (2,) + dims[cfg.nscales]:
            raise ValueError(
                f"initial_coarse_motion must be [2, {dims[cfg.nscales][0]}, "
                f"{dims[cfg.nscales][1]}] (coarsest level), got {uc.shape}"
            )
        return _jitted_register(cfg, False, start_scale, stop_scale,
                                warm_coarse=True)(iref, imov, uc)
    if initial_motion is not None:
        u0 = jnp.asarray(initial_motion)
        if u0.shape != (2,) + iref.shape:
            raise ValueError(
                f"initial_motion must be [2, {iref.shape[0]}, {iref.shape[1]}], "
                f"got {u0.shape}"
            )
        return _jitted_register(cfg, True, start_scale, stop_scale)(iref, imov, u0)
    return _jitted_register(cfg, False, start_scale, stop_scale)(iref, imov)


@functools.lru_cache(maxsize=128)
def _jitted_resample(kind: str, a: int, b: int):
    if kind == "down_img":
        return jax.jit(lambda x: downsample_image(x, (a, b)))
    if kind == "down_motion":
        return jax.jit(lambda u: downsample_motion(u, (a, b)))
    return jax.jit(lambda u: upsample_motion(u, (a, b)))


@functools.lru_cache(maxsize=64)
def _jitted_level(cfg: RegConfig, niter: int, scale: int):
    return jax.jit(
        lambda u, r, m: _solve_level(u, r, m, cfg, niter, scale)
    )


def register_phased(iref, imov, cfg: RegConfig,
                    initial_motion=None,
                    initial_coarse_motion=None) -> RegistrationResult:
    """Host-phased registration for huge grids.

    Same semantics as ``register`` (same level flow as
    ``_register_impl``, including the reference's §2.3.6 motion round
    trip), but every phase runs as its OWN XLA program with arrays
    materialized between phases: per-level image downsamples, each
    level's solve (with its refinement loop), and the motion up/down
    resamples. Splitting at these boundaries matches the monolithic run
    to float associativity — the checkpoint-resume property the
    per-level ``start_scale``/``stop_scale`` path already relies on.

    Past 8192 lanes curvature, fluid and diffeomorphic demons run their
    levels HOST-STEPPED (``_solve_level_stepped``: one program per
    iteration, split so that large temporaries never coexist); the other
    families run each level as one program. Below that extent
    ``register_phased`` works for every family and simply trades one big
    compile for a few small ones. Whether a large-memory card still needs
    this split is ROADMAP design item 2.
    """
    iref = jnp.asarray(iref, cfg.jnp_dtype)
    imov = jnp.asarray(imov, cfg.jnp_dtype)
    if iref.shape != imov.shape or iref.ndim != 2:
        raise ValueError(
            f"iref/imov must be matching 2D images, got {iref.shape} vs "
            f"{imov.shape}"
        )
    dims = pyramid_dims(iref.shape, cfg.nscales)
    if min(dims[-1]) < 4:
        raise ValueError(
            f"nscales={cfg.nscales} shrinks the coarsest level to "
            f"{dims[-1]}; every level needs at least 4 pixels per side"
        )
    import dataclasses as _dc
    import math as _math

    auto_halo = (bool(cfg.warp_halo_auto) and cfg.nscales >= 1
                 and initial_motion is None)
    if cfg.warp_halo_auto:
        cfg = _dc.replace(cfg, warp_halo_auto=False)

    irefs = {0: iref}
    imovs = {0: imov}
    for s in range(1, cfg.nscales + 1):
        down = _jitted_resample("down_img", *dims[s])
        irefs[s] = down(iref)
        imovs[s] = down(imov)

    if initial_coarse_motion is not None and initial_motion is not None:
        raise ValueError(
            "initial_motion and initial_coarse_motion are mutually "
            "exclusive (full-res warm start vs reference repeated-"
            "register continuation)"
        )
    if initial_coarse_motion is not None:
        # Repeated-register warm continuation (CompatFlags.persistent_motion):
        # the reference never re-seeds motion[nscales]
        # (ImageRegistration.cpp:137-139) — same semantics as
        # register(initial_coarse_motion=...), host-phased. The coarse warm
        # field also sizes the fitted outer halo below: the stale solution
        # can be large even before the coarse level runs.
        initial_coarse_motion = jnp.asarray(initial_coarse_motion,
                                            cfg.jnp_dtype)
        if initial_coarse_motion.shape != (2,) + dims[cfg.nscales]:
            raise ValueError(
                f"initial_coarse_motion must be [2, "
                f"{dims[cfg.nscales][0]}, {dims[cfg.nscales][1]}] "
                f"(coarsest level), got {initial_coarse_motion.shape}"
            )
    if initial_motion is not None:
        u_full = jnp.asarray(initial_motion, cfg.jnp_dtype)
        if u_full.shape != (2,) + dims[0]:
            raise ValueError(
                f"initial_motion must be [2, {dims[0][0]}, {dims[0][1]}], "
                f"got {u_full.shape}"
            )
    else:
        u_full = None  # zeros created per level below

    traces = []
    coarse_final = None
    level_cfg = cfg
    for s in range(cfg.nscales, -1, -1):
        if s == cfg.nscales and s > 0:
            if initial_coarse_motion is not None:
                u_s = initial_coarse_motion
            elif u_full is not None:
                u_s = _jitted_resample("down_motion", *dims[s])(u_full)
            else:
                u_s = jnp.zeros((2,) + dims[s], cfg.jnp_dtype)
        elif 0 < s < cfg.nscales:
            u_s = _jitted_resample("down_motion", *dims[s])(u_full)
        elif s == 0 and u_full is None:
            if cfg.nscales == 0 and initial_coarse_motion is not None:
                # Single-scale continuation: the coarsest level IS the
                # full-resolution field (WrapperOpticalFlow2d.cpp:86-102).
                u_s = initial_coarse_motion
            else:
                u_s = jnp.zeros((2,) + dims[0], cfg.jnp_dtype)
        else:
            u_s = u_full

        if s == 0 and cfg.nscales >= 1 and auto_halo:
            # The two-phase fitted outer halo of register()'s
            # warp_halo_auto path, which is naturally host-driven here:
            # one scalar readback of the coarse solution's max component
            # sizes the full-resolution level's outer halo.
            maxu = float(jnp.max(jnp.abs(u_s)))
            h_out = max(cfg.warp_halo_outer, min(7, _math.ceil(maxu + 0.5)))
            level_cfg = _dc.replace(cfg, warp_halo_outer=h_out)

        stepped_here = cfg.method in (Method.CURVATURE, Method.FLUID,
                                      Method.DIFFEOMORPHIC_DEMONS)
        if max(dims[s]) > _DERIV_BARRIER_MIN_EXTENT and stepped_here:
            # These families run this level host-stepped: one program per
            # iteration, Logger stop and fluid regridding on the host (see
            # _solve_level_stepped).
            u_s, level_traces = _solve_level_stepped(
                u_s, irefs[s], imovs[s], level_cfg, int(cfg.niter[s]), s
            )
        else:
            u_s, level_traces = _jitted_level(level_cfg, int(cfg.niter[s]), s)(
                u_s, irefs[s], imovs[s]
            )
        traces.extend(level_traces)
        if s == cfg.nscales:
            coarse_final = u_s
        if s > 0:
            # The coarser pyramid images are done — free them before the
            # finer (larger) levels run; every MB matters at 16384^2.
            irefs.pop(s, None)
            imovs.pop(s, None)
            u_full = _jitted_resample("up_motion", *dims[0])(u_s)
        else:
            u_full = u_s

    return RegistrationResult(
        motion=u_full, traces=tuple(traces),
        coarse_motion=coarse_final,
    )
