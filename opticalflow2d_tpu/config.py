"""Typed configuration for the registration engine.

Mirrors the reference's positional MEX argument surface and per-method
regularisation-parameter packing (reference ``WrapperOpticalFlow2d.cpp:23-83``,
``ImageRegistrationOpticalFlow.cpp:8-12``, ``ImageRegistrationDemons.cpp:7-10``,
``ImageRegistrationFluid.cpp:5-7``) as one frozen dataclass, plus engine
knobs (dtype, compat switches) that have no reference counterpart.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import jax.numpy as jnp


class Method(enum.IntEnum):
    """Solver families; values match the reference's ``Regularisation`` enum
    (``src/SolverOptions.h:4``)."""

    DIFFUSION = 0
    CURVATURE = 1
    ELASTIC = 2
    THIRIONS_DEMONS = 3
    DIFFEOMORPHIC_DEMONS = 4
    FLUID = 5


class MotionAccumulation(enum.IntEnum):
    """``src/SolverOptions.h:8``."""

    COMPOSITION = 0
    ADDITION = 1


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Bug-compatibility switches for quirks in the reference (SURVEY.md §2.3).

    Defaults are the *fixed* behaviors; parity tests against the C++ oracle
    flip these on to reproduce the reference bit patterns.
    """

    # Motion::maxabs sums .y twice instead of .x^2 + .y^2
    # (reference src/Motion.cpp:54). Affects the fluid adaptive timestep and
    # the exp() scaling.
    maxabs_bug: bool = False

    # Field::convolute bounds-checks the *flat* index, so kernels wrap across
    # row boundaries in x instead of being clipped (reference
    # src/Field.tpp:245-246). Affects demons Gaussian smoothing near edges.
    conv_flatwrap: bool = False

    # Elastic/Fluid SOR y-component (mu+lambda) term reads x-direction
    # neighbours where the symmetric Navier-Lame operator calls for
    # y-direction ones (reference src/regularization/OpticalFlow/
    # OpticalFlowElastic.cpp:46-49). True = reproduce the reference stencil.
    # The reference stencil is the default because parity with the reference's
    # converged fields is the primary contract.
    elastic_stencil_reference: bool = True

    # The reference MEX wrapper keeps one ImageRegistration object alive
    # across register calls, so a second OpticalFlow2d(Iref, Imov) call
    # CONTINUES from persistent state: the coarsest-level field
    # motion[nscales] is never re-seeded (estimate_motion skips the
    # downsample at s == nscales, reference src/ImageRegistration.cpp:
    # 137-139), so it carries the previous call's coarse solution into the
    # new call; for nscales == 0 the full-resolution field itself carries
    # over (WrapperOpticalFlow2d.cpp:86-102). True = the session object
    # reproduces this warm-continuation statefulness; False (default) =
    # every register() starts from zero, which is the self-consistent
    # behavior.
    persistent_motion: bool = False


@dataclasses.dataclass(frozen=True)
class RegConfig:
    """Full registration configuration.

    ``niter`` has ``nscales + 1`` entries; ``niter[s]`` is the iteration cap
    at pyramid scale ``s`` (s=0 is full resolution), matching the reference
    (``WrapperOpticalFlow2d.cpp:35-38``, ``ImageRegistration.cpp:133-156``).
    """

    method: Method
    niter: Tuple[int, ...]
    nscales: int = 0
    nrefine: int = 1

    # --- Variational (Diffusion/Curvature/Elastic/Fluid) parameters ---
    # Diffusion: alpha (Horn-Schunck regularisation weight).
    alpha: float = 1.0
    # Curvature: alpha + time step tau (reference OpticalFlowCurvature.h:10;
    # the second MEX regparam is named "omega" at the call site but binds to
    # tau — SURVEY.md §2.3.11).
    tau: float = 1.0
    # Elastic/Fluid: Navier-Lame mu/lambda + SOR relaxation omega
    # (reference OpticalFlowElastic.h:9, OpticalFlowFluid.h:10).
    mu: float = 1.0
    lam: float = 0.0
    omega: float = 0.66
    # Fluid adaptive-timestep cap du_max (reference OpticalFlowFluid.h:32).
    dumax: float = 0.65

    # --- Demons parameters (reference Demons.h:10-13) ---
    sigma_i: float = 1.0
    sigma_x: float = 0.25
    sigma_diffusion: float = 2.0
    sigma_fluid: float = 2.0
    kernelwidth: int = 5
    accumulation: MotionAccumulation = MotionAccumulation.COMPOSITION

    # --- Convergence (reference ImageRegistrationOpticalFlow.cpp:130-134) ---
    convergence_tol: float = 0.001
    # Fluid regridding threshold on min Jacobian (ImageRegistrationFluid.cpp:108).
    regrid_threshold: float = 0.5
    # Fluid timestep skip threshold (OpticalFlowFluid.cpp:135-137).
    timestep_skip: float = 65.0

    # --- Engine knobs (no reference counterpart) ---
    # SOR sweep ordering for elastic/fluid: "redblack" (data-parallel, same
    # fixed point, different iterate path) or "lexicographic" (exact
    # wavefront reproduction of the reference's sequential sweep — slow,
    # for bit-parity runs).
    sor_ordering: str = "redblack"
    # Navier-Lame solve for elastic/fluid: "sor" (reference behavior: one
    # relaxation sweep per iteration), "spectral" (exact FFT solve of the
    # same system per iteration, periodic BCs), or "spectral_dirichlet"
    # (DST-based exact solve of the reference's interior-point system with
    # its untouched-border Dirichlet semantics — the north-star upgrade
    # with reference-faithful boundaries).
    navier_lame_solver: str = "sor"
    # Curvature DCT implementation; "auto" resolves per
    # ``resolved_dct_impl``. Explicit values: "matmul" (dense transform
    # matmuls at Precision.HIGHEST), "matmul_high" / "matmul_fast" (the
    # same at Precision.HIGH / DEFAULT), "fft" (Makhoul's FFT algorithm),
    # "split" / "split_high" / "split_fast" (split-radix factorization at
    # the matching precision: about 1/3 the multiply-adds of the dense
    # transform, coefficient permutation absorbed into the eigenvalue
    # table; falls back to the dense transform per axis when the extent is
    # odd or < 128).
    dct_impl: str = "auto"
    # Warp fast-path halo: bilinear warps use masked circular shifts when
    # every in-bounds sample's floor offset is within this many pixels
    # (runtime-checked; exact-gather fallback otherwise). 0 disables the
    # fast path. Results are identical either way. Cost (runtime AND
    # compile time — the select-chain is (2h+2)^2 shifted copies, compiled
    # alongside the fallback branch) grows ~quadratically in the halo.
    warp_halo: int = 2
    # Halo for the driver-level warps/composes (per-refinement image warp,
    # level composition, regridding), where the accumulated motion is larger
    # than the per-iteration increments.
    warp_halo_outer: int = 4
    # Driver-level halo automation: run the coarse pyramid levels first,
    # read back ONE scalar (max |u| of the upsampled coarse motion), pick
    # warp_halo_outer = ceil(max|u| + 0.5) clamped to <= 7 (the select
    # chain grows as (2h+2)^2) for the full-resolution level, and run it
    # warm-started from the coarse field (the same level-boundary split as
    # checkpoint resume; matches the monolithic run to ~1 ulp). The OUTER
    # halo is the knob that matters: driver-level warps/composes see the
    # total motion and silently take the exact gather when it overshoots.
    # The per-iteration solver halo only sees level increments, stays as
    # configured, and is fallback-counted in LevelTrace. Only acts on
    # whole-pyramid host-level register() calls (nscales >= 1, no
    # start/stop_scale, no warm start); ignored under jit/vmap drivers.
    # None = auto: ON for nscales >= 1. Bit-parity configs pin False (the
    # two-phase level split changes float associativity by ~1 ulp).
    warp_halo_auto: bool | None = None
    dtype: str = "float32"
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)
    # Stream per-iteration relative errors to the host console as they
    # happen (the reference Logger's verbose mode, src/Logger.cpp:62-79),
    # via jax.debug.callback. Costs a host sync per iteration — leave off
    # for production/batched runs; OpticalFlow2d(verbose=True) turns it on.
    verbose_stream: bool = False

    def __post_init__(self):
        # Resolve the None=auto knobs here so downstream consumers see
        # plain bools.
        if self.warp_halo_auto is None:
            object.__setattr__(self, "warp_halo_auto", self.nscales >= 1)
        if len(self.niter) < self.nscales + 1:
            raise ValueError(
                f"niter needs at least nscales+1={self.nscales + 1} entries, "
                f"got {len(self.niter)}"
            )
        if self.nscales < 0:
            raise ValueError("nscales must be >= 0")
        if self.nrefine < 1:
            raise ValueError("nrefine must be >= 1")
        if self.kernelwidth < 1 or self.kernelwidth % 2 == 0:
            raise ValueError("kernelwidth must be odd and >= 1")

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def resolved_dct_impl(self) -> str:
        """Resolve ``dct_impl="auto"``: bug-compat (parity) configs get the
        dense transform at ``Precision.HIGHEST`` (bit-closest to the
        reference's FFTW transform); every other config gets the
        split-radix transform at ``Precision.HIGH``."""
        if self.dct_impl != "auto":
            return self.dct_impl
        if self.compat.maxabs_bug or self.compat.conv_flatwrap:
            return "matmul"
        return "split_high"

    @staticmethod
    def from_regparams(
        method: Method | int,
        niter: Sequence[int],
        nscales: int,
        regparams: Sequence[float],
        nrefine: int = 1,
        **overrides,
    ) -> "RegConfig":
        """Build a config from the reference's positional regparam packing.

        Validation mirrors ``valid_regularisation_parameters``:
        Diffusion: [alpha]; Curvature: [alpha(, tau)];
        Elastic: [mu, lambda(, omega)]; Fluid: [mu, lambda(, omega)];
        ThirionsDemons: [sigma_i, sigma_x, sigma_diffusion, sigma_fluid,
        kernelwidth, accumulation]; DiffeomorphicDemons: same minus
        accumulation. (reference ImageRegistrationOpticalFlow.cpp:8-12,
        ImageRegistrationDemons.cpp:7-10, ImageRegistrationFluid.cpp:5-7)
        """
        method = Method(method)
        p = [float(v) for v in regparams]
        n = len(p)
        kw = dict(
            method=method,
            niter=tuple(int(v) for v in niter),
            nscales=int(nscales),
            nrefine=int(nrefine),
        )
        if method == Method.DIFFUSION:
            if n != 1:
                raise ValueError("Diffusion takes exactly 1 regparam [alpha]")
            kw["alpha"] = p[0]
        elif method == Method.CURVATURE:
            if not 1 <= n <= 2:
                raise ValueError("Curvature takes 1-2 regparams [alpha(, tau)]")
            kw["alpha"] = p[0]
            if n == 2:
                kw["tau"] = p[1]
        elif method in (Method.ELASTIC, Method.FLUID):
            if not 2 <= n <= 3:
                raise ValueError(
                    f"{method.name} takes 2-3 regparams [mu, lambda(, omega)]"
                )
            kw["mu"], kw["lam"] = p[0], p[1]
            if n == 3:
                kw["omega"] = p[2]
        elif method == Method.THIRIONS_DEMONS:
            if n != 6:
                raise ValueError(
                    "ThirionsDemons takes exactly 6 regparams "
                    "[sigma_i, sigma_x, sigma_diff, sigma_fluid, kernelwidth, accum]"
                )
            kw.update(
                sigma_i=p[0], sigma_x=p[1], sigma_diffusion=p[2],
                sigma_fluid=p[3],
                # kernelwidth truncated from float, as the reference does
                # (ImageRegistrationDemons.cpp:26)
                kernelwidth=int(p[4]),
                accumulation=MotionAccumulation(int(p[5])),
            )
        elif method == Method.DIFFEOMORPHIC_DEMONS:
            if n != 5:
                raise ValueError(
                    "DiffeomorphicDemons takes exactly 5 regparams "
                    "[sigma_i, sigma_x, sigma_diff, sigma_fluid, kernelwidth]"
                )
            kw.update(
                sigma_i=p[0], sigma_x=p[1], sigma_diffusion=p[2],
                sigma_fluid=p[3], kernelwidth=int(p[4]),
            )
        kw.update(overrides)
        return RegConfig(**kw)
