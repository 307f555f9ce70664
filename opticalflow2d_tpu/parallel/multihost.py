"""Multi-host setup (SURVEY.md §2.2: the reference's MATLAB driver has no
distributed analog; this is the multi-process launcher).

Scaling within one host needs nothing beyond a Mesh over ``jax.devices()``.
Across processes, call ``initialize_multihost`` once per process before any
JAX computation; all processes then see the global device set and the same
``make_mesh`` calls build one global mesh.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Initialize the JAX distributed runtime. Arguments left as None are
    taken from the cluster environment, where JAX can detect one; without
    a detectable cluster pass all three. Returns a summary dict."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def shard_batch_for_host(batch_size: int) -> slice:
    """The slice of a globally-indexed batch this host should feed
    (per-host data loading for ``register_batch`` on a global mesh)."""
    n = jax.process_count()
    i = jax.process_index()
    if batch_size % n != 0:
        raise ValueError(f"global batch {batch_size} not divisible by host count {n}")
    per = batch_size // n
    return slice(i * per, (i + 1) * per)
