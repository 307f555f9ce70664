"""Numerical-health checks (SURVEY.md §5: the replacement for the
reference's absent sanitizers — JAX is functional, so data races are
structural non-issues; the risks here are NaN/Inf propagation and silently
diverging solves)."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped ``jax_debug_nans``: any NaN produced under jit raises with the
    offending primitive. Use around a failing registration to localize."""
    # Context-managed flags must be read via the attribute, not config.read.
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, name: str = "value"):
    """Host-side finiteness check over a pytree of arrays (post-hoc; for
    in-graph checks use ``debug_nans``)."""
    import numpy as np

    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        arr = np.asarray(leaf, dtype=np.float64)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite values "
                f"(shape {arr.shape})"
            )


def divergence_guard(errors: jnp.ndarray, window: int = 5, factor: float = 10.0):
    """Return True (host bool) if the convergence trace is diverging: the
    mean of the last ``window`` logged relative-step errors exceeds
    ``factor`` x the mean of the first ``window`` nonzero entries."""
    import numpy as np

    e = np.asarray(errors)
    nz = e[e > 0]
    if len(nz) < 2 * window:
        return False
    return float(nz[-window:].mean()) > factor * float(nz[:window].mean())
