"""Stateful session API mirroring the reference MEX wrapper's 5-command
surface (``WrapperOpticalFlow2d.cpp:18-155``):

    OpticalFlow2d([dimx dimy], niter, nscales, reg, regparams, nparams,
                  nrefine, verbose)                       -> __init__
    OpticalFlow2d(Iref, Imov)                             -> register()
    motion = OpticalFlow2d()                              -> get_motion()
    Ireg = OpticalFlow2d(Imov)                            -> warp(Imov)
    OpticalFlow2d() [close]                               -> close()

Unlike the MEX singleton, sessions are ordinary objects — create as many as
you like; the functional core underneath is ``engine.registration.register``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax.numpy as jnp

from opticalflow2d_tpu.config import Method, RegConfig
from opticalflow2d_tpu.engine.registration import register, RegistrationResult
from opticalflow2d_tpu.ops.warp import warp2d


class OpticalFlow2d:
    """Session object holding the last estimated motion field.

    Images are ``[nx, ny]`` arrays (axis 0 = the reference's "x"/row
    dimension). ``get_motion()`` returns ``[nx, ny, 2]`` to match the MEX
    readback layout (``WrapperOpticalFlow2d.cpp:105-117`` returns
    ``(dimx, dimy, 2)`` with the x-plane first, ``src/Motion.cpp:23-39``).
    """

    def __init__(
        self,
        dims: Sequence[int],
        niter: Sequence[int],
        nscales: int,
        regularisation: Method | int,
        regparams: Sequence[float],
        nrefine: int = 1,
        verbose: bool = False,
        **config_overrides,
    ):
        self.dims = (int(dims[0]), int(dims[1]))
        # verbose turns on the live per-iteration trace (the reference
        # Logger's verbose mode) unless explicitly overridden.
        config_overrides.setdefault("verbose_stream", bool(verbose))
        self.config = RegConfig.from_regparams(
            regularisation, niter, nscales, regparams, nrefine, **config_overrides
        )
        self.verbose = verbose
        self._result: Optional[RegistrationResult] = None
        if verbose:
            print(self._banner())

    def _banner(self) -> str:
        """Parameter banner, the analogue of
        ``ImageRegistration::display_registration_parameters``
        (``ImageRegistration.cpp:6-47``)."""
        c = self.config
        lines = [
            "=" * 72,
            "Optical flow image registration (JAX implementation)",
            f"dimensions:      {self.dims}",
            f"niter:           {c.niter[: c.nscales + 1]}",
            f"nscales:         {c.nscales}",
            f"nrefine:         {c.nrefine}",
            f"regularisation:  {c.method.name}",
        ]
        # Regularisation parameters, per method — the second half of the
        # reference banner (ImageRegistration.cpp:6-47).
        if c.method == Method.DIFFUSION:
            lines.append(f"alpha:           {c.alpha}")
        elif c.method == Method.CURVATURE:
            lines.append(f"alpha:           {c.alpha}")
            lines.append(f"tau:             {c.tau}")
        elif c.method in (Method.ELASTIC, Method.FLUID):
            lines.append(f"mu:              {c.mu}")
            lines.append(f"lambda:          {c.lam}")
            lines.append(f"omega (SOR):     {c.omega}")
        else:  # demons families
            lines.append(f"sigma_i:         {c.sigma_i}")
            lines.append(f"sigma_x:         {c.sigma_x}")
            lines.append(f"sigma_diffusion: {c.sigma_diffusion}")
            lines.append(f"sigma_fluid:     {c.sigma_fluid}")
            lines.append(f"kernelwidth:     {c.kernelwidth}")
            if c.method == Method.THIRIONS_DEMONS:
                lines.append(f"accumulation:    {c.accumulation.name}")
        lines.append("=" * 72)
        return "\n".join(lines)

    def register(self, iref, imov) -> RegistrationResult:
        """Run the registration; motion is retained for get_motion()/warp().

        With ``CompatFlags.persistent_motion`` a second register call
        CONTINUES from the previous one, exactly as the reference's
        persistent MEX object does: only the coarsest-level field
        ``motion[nscales]`` survives between calls — the coarsest
        downsample is skipped (ImageRegistration.cpp:137-139), so the new
        pyramid's coarse level starts from the stale coarse solution (for
        ``nscales == 0`` that IS the full-resolution field,
        WrapperOpticalFlow2d.cpp:86-102)."""
        iref = jnp.asarray(iref)
        if iref.shape != self.dims:
            raise ValueError(f"expected images of shape {self.dims}, got {iref.shape}")
        warm_coarse = None
        if (self.config.compat.persistent_motion and self._result is not None
                and self._result.coarse_motion is not None):
            warm_coarse = self._result.coarse_motion
        if max(self.dims) > 8192:
            # Huge grids: the phased driver runs each pyramid phase as its
            # own program with identical semantics, which bounds the
            # device memory a level needs — including persistent_motion
            # warm continuation, which seeds the phased coarse level
            # directly. Whether a large-memory card still needs this
            # routing is ROADMAP design item 2.
            from opticalflow2d_tpu.engine.registration import register_phased

            self._result = register_phased(iref, imov, self.config,
                                           initial_coarse_motion=warm_coarse)
        else:
            self._result = register(iref, imov, self.config,
                                    initial_coarse_motion=warm_coarse)
        if self.verbose:
            for t in self._result.traces:
                n = int(t.iterations)
                errs = np.asarray(t.errors)[:n]
                print(
                    f"scale {int(t.scale)}: {n} iterations, "
                    f"final rel-err {errs[-1] if n else 0:.4f}, "
                    f"regrids {int(t.regrids)}"
                )
        return self._result

    @property
    def result(self) -> Optional[RegistrationResult]:
        return self._result

    def get_motion(self) -> np.ndarray:
        """Return the estimated motion as ``[nx, ny, 2]`` (x-plane first)."""
        if self._result is None:
            raise RuntimeError("no registration has been run")
        return np.moveaxis(np.asarray(self._result.motion), 0, -1)

    def warp(self, image) -> np.ndarray:
        """Warp an image with the stored motion field
        (``WrapperOpticalFlow2d.cpp:120-137``)."""
        if self._result is None:
            raise RuntimeError("no registration has been run")
        return np.asarray(warp2d(jnp.asarray(image, self.config.jnp_dtype),
                                 self._result.motion))

    def close(self):
        """Drop the stored state (the MEX 'close' command)."""
        self._result = None
