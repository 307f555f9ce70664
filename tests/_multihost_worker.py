"""Worker process for the two-process ``jax.distributed`` CPU test
(run by tests/test_multihost.py, not collected by pytest).

Each of the two processes owns 2 virtual CPU devices (4 global), joins the
localhost coordinator via ``initialize_multihost``, feeds only its
``shard_batch_for_host`` slice of a deterministic batch, runs
``register_batch`` on the global (data=4) mesh, and process 0 writes the
allgathered motion stack for the parent to compare against a
single-process run. This exercises the multi-process code path the
framework uses across hosts (SURVEY.md §2.2); cross-process CPU collectives go
through gloo.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    coordinator = sys.argv[3]
    out_path = sys.argv[4]

    from opticalflow2d_tpu.parallel.multihost import (
        initialize_multihost,
        shard_batch_for_host,
    )

    info = initialize_multihost(coordinator, num_processes, process_id)
    assert info["process_count"] == num_processes, info
    assert info["global_devices"] == 2 * num_processes, info

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils

    from opticalflow2d_tpu.config import Method, RegConfig
    from opticalflow2d_tpu.parallel.mesh import make_mesh
    from opticalflow2d_tpu.parallel.batch import register_batch

    # Deterministic batch, identical in every process; each host materializes
    # only its own slice (per-host data loading).
    rng = np.random.default_rng(7)
    batch = 4
    irefs = rng.random((batch, 24, 20), dtype=np.float32)
    imovs = rng.random((batch, 24, 20), dtype=np.float32)
    cfg = RegConfig(
        method=Method.DIFFUSION, niter=(5, 4), nscales=1, alpha=0.5,
        warp_halo=0, warp_halo_outer=0,
    )

    mesh = make_mesh(data=len(jax.devices()))
    sl = shard_batch_for_host(batch)
    sharding = NamedSharding(mesh, P("data"))
    girefs = jax.make_array_from_process_local_data(
        sharding, irefs[sl], (batch, 24, 20)
    )
    gimovs = jax.make_array_from_process_local_data(
        sharding, imovs[sl], (batch, 24, 20)
    )

    res = register_batch(girefs, gimovs, cfg, mesh=mesh, impl="vmap")
    motion = multihost_utils.process_allgather(res.motion, tiled=True)
    iters = multihost_utils.process_allgather(res.traces[0].iterations, tiled=True)

    if process_id == 0:
        tmp = out_path + ".tmp.npz"
        np.savez(tmp, motion=np.asarray(motion), iterations=np.asarray(iters))
        os.replace(tmp, out_path)
    # Every process must reach the end for the barrier semantics of
    # process_allgather to have been exercised.
    print(f"worker {process_id} done", flush=True)


if __name__ == "__main__":
    main()
