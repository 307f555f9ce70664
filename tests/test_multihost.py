"""Two-process ``jax.distributed`` test for ``parallel/multihost.py``.

Spawns two subprocesses (2 virtual CPU devices each -> 4 global devices)
with a localhost coordinator, runs a per-host-fed ``register_batch`` on the
global mesh, and compares the allgathered result against a single-process
run of the same batch. This validates the multi-process launcher end to end:
``jax.distributed`` init, global mesh construction over multiple processes,
``shard_batch_for_host`` data feeding, cross-process collectives (gloo),
and ``process_allgather`` readback.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_register_batch_matches_single(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    out_path = str(tmp_path / "multihost_result.npz")
    coordinator = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    # Two fresh processes — the parent's initialized backend is not shared.
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", coordinator, out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outputs.append(out)
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    data = np.load(out_path)
    motion = data["motion"]
    iters = data["iterations"]
    assert motion.shape == (4, 2, 24, 20)

    # Single-process oracle: same deterministic batch, same config.
    from opticalflow2d_tpu.config import Method, RegConfig
    from opticalflow2d_tpu.parallel.batch import register_batch

    rng = np.random.default_rng(7)
    irefs = rng.random((4, 24, 20), dtype=np.float32)
    imovs = rng.random((4, 24, 20), dtype=np.float32)
    cfg = RegConfig(
        method=Method.DIFFUSION, niter=(5, 4), nscales=1, alpha=0.5,
        warp_halo=0, warp_halo_outer=0,
    )
    ref = register_batch(irefs, imovs, cfg, impl="vmap")
    np.testing.assert_array_equal(iters, np.asarray(ref.traces[0].iterations))
    np.testing.assert_allclose(
        motion, np.asarray(ref.motion), rtol=1e-6, atol=1e-7
    )
