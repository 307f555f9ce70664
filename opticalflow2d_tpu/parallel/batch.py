"""Batched (data-parallel) registration.

``register_batch`` vmaps the full pyramid/refine/iterate driver over a batch
of image pairs and shards the batch axis over the mesh's ``"data"`` axis.
Under vmap the per-pair ``while_loop`` convergence gates become masked
iterations (a pair that converged early idles until the batch maximum), which
preserves per-pair results exactly while keeping the computation SPMD.

Performance note: under vmap, ``lax.cond`` branches execute unconditionally
(batched select), so the warp fast path's exact-gather fallback and the
fluid regrid branch run every iteration for every pair. Batching therefore
amortizes well for the variational solvers (diffusion/curvature/elastic)
but is counterproductive on a single device for the gather-heavy
demons/fluid paths — loop single-pair ``register`` calls there, or give
each mesh device one pair so the per-device program stays unbatched.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opticalflow2d_tpu.config import Method, RegConfig
from opticalflow2d_tpu.engine.registration import _register_impl, RegistrationResult

# Methods whose inner loops contain data-dependent lax.cond branches
# (gather fallbacks, regridding) that vmap would force to both-execute.
_COND_HEAVY = (Method.THIRIONS_DEMONS, Method.DIFFEOMORPHIC_DEMONS, Method.FLUID)


def _map_local(irefs, imovs, cfg, u0s=None):
    """Sequential per-pair registration (lax.map keeps lax.cond as real
    branching, unlike vmap's both-branch select)."""
    if u0s is None:
        return lax.map(lambda rm: _register_impl(rm[0], rm[1], cfg), (irefs, imovs))
    return lax.map(
        lambda rmu: _register_impl(rmu[0], rmu[1], cfg, rmu[2]),
        (irefs, imovs, u0s),
    )


@functools.lru_cache(maxsize=32)
def _jitted_batch(cfg: RegConfig, mesh: Optional[Mesh], impl: str, warm: bool):
    if impl == "vmap":
        if warm:
            fn = jax.vmap(lambda r, m, u0: _register_impl(r, m, cfg, u0))
        else:
            fn = jax.vmap(lambda r, m: _register_impl(r, m, cfg))
        if mesh is None:
            return jax.jit(fn)
        ds = NamedSharding(mesh, P("data"))
        n_in = 3 if warm else 2
        return jax.jit(fn, in_shardings=(ds,) * n_in, out_shardings=ds)
    # impl == "map": per-device unbatched programs; across devices via
    # shard_map so each device runs its local pairs sequentially.
    if warm:
        local = lambda r, m, u0: _map_local(r, m, cfg, u0)
        specs = (P("data"), P("data"), P("data"))
    else:
        local = lambda r, m: _map_local(r, m, cfg)
        specs = (P("data"), P("data"))
    if mesh is None:
        return jax.jit(local)
    fn = shard_map(
        local, mesh=mesh, in_specs=specs, out_specs=P("data"), check_vma=False
    )
    return jax.jit(fn)


def _resolve_impl(cfg: RegConfig, impl: str) -> str:
    """Resolve ``impl="auto"``: map for cond-heavy methods (vmap
    both-executes their gather-fallback and regrid branches), vmap for the
    variational methods, where SPMD batching amortizes. Which side wins on
    the card at each size is ROADMAP speed item 5."""
    if impl != "auto":
        return impl
    cond_heavy = cfg.method in _COND_HEAVY and cfg.warp_halo > 0
    return "map" if cond_heavy else "vmap"


def register_batch(
    irefs, imovs, cfg: RegConfig, mesh: Optional[Mesh] = None,
    impl: str = "auto", initial_motions=None,
) -> RegistrationResult:
    """Register a batch of pairs.

    Args:
      irefs, imovs: ``[B, nx, ny]`` image stacks.
      cfg: static registration config.
      mesh: optional mesh with a ``"data"`` axis; the batch is sharded over
        it (B must be divisible by the axis size).
      impl: "vmap" (SPMD-batched; suits the variational solvers), "map"
        (per-pair programs, sequential within each device — preserves real
        cond branching for demons/fluid), or "auto" (picks by method —
        ``_resolve_impl``).
      initial_motions: optional ``[B, 2, nx, ny]`` warm-start fields (e.g.
        previous-frame solutions in sequence processing).

    Returns:
      ``RegistrationResult`` with a leading batch axis on every leaf
      (``motion`` is ``[B, 2, nx, ny]``).
    """
    irefs = jnp.asarray(irefs)
    imovs = jnp.asarray(imovs)
    if irefs.ndim != 3 or irefs.shape != imovs.shape:
        raise ValueError(
            f"expected matching [B, nx, ny] stacks, got {irefs.shape} vs {imovs.shape}"
        )
    if mesh is not None:
        b = irefs.shape[0]
        nd = mesh.shape["data"]
        if b % nd != 0:
            raise ValueError(f"batch {b} not divisible by data-axis size {nd}")
    impl = _resolve_impl(cfg, impl)
    if impl not in ("vmap", "map"):
        raise ValueError(f"unknown impl {impl!r}")
    if initial_motions is not None:
        u0s = jnp.asarray(initial_motions)
        if u0s.shape != (irefs.shape[0], 2) + irefs.shape[1:]:
            raise ValueError(
                f"initial_motions must be [B, 2, nx, ny], got {u0s.shape}"
            )
        return _jitted_batch(cfg, mesh, impl, True)(irefs, imovs, u0s)
    return _jitted_batch(cfg, mesh, impl, False)(irefs, imovs)
