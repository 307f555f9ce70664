"""The code around the solvers: the batch driver's map/vmap rule, the
compile-cache location, the card helpers, and the chip smoke test and
bench run at tiny sizes on the CPU (their checks, not their speed)."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opticalflow2d_tpu import Method, RegConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("method,warp_halo,expected", [
    (Method.DIFFUSION, 2, "vmap"),
    (Method.CURVATURE, 2, "vmap"),
    (Method.ELASTIC, 2, "vmap"),
    (Method.THIRIONS_DEMONS, 2, "map"),
    (Method.DIFFEOMORPHIC_DEMONS, 2, "map"),
    (Method.FLUID, 2, "map"),
    (Method.THIRIONS_DEMONS, 0, "vmap"),
    (Method.DIFFEOMORPHIC_DEMONS, 0, "vmap"),
    (Method.FLUID, 0, "vmap"),
])
def test_resolve_impl_rule(method, warp_halo, expected):
    """auto maps the methods whose loops carry data-dependent branches
    (the halo gather fallback, fluid's regrid) and vmaps the rest."""
    from opticalflow2d_tpu.parallel.batch import _resolve_impl

    cfg = RegConfig(method=method, niter=(4,), warp_halo=warp_halo)
    assert _resolve_impl(cfg, "auto") == expected
    assert _resolve_impl(cfg, "map") == "map"


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_when_set(monkeypatch, tmp_path,
                                         restore_cache_dir):
    from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert enable_compile_cache() == path  # fixed: no pid, time or tmp name


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H200, 700.00 W", "NVIDIA H200", 700.0),
    ("NVIDIA H200, 450.00 W", "NVIDIA H200", 450.0),
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
])
def test_parse_nvidia_smi_line(line, name, watts):
    from opticalflow2d_tpu.utils.device import parse_nvidia_smi

    assert parse_nvidia_smi(line) == (name, watts)


def test_parse_nvidia_smi_rejects_missing_limit():
    from opticalflow2d_tpu.utils.device import parse_nvidia_smi

    with pytest.raises(ValueError):
        parse_nvidia_smi("NVIDIA H200, [N/A]")


def test_hbm_peak_table():
    from opticalflow2d_tpu.utils.device import hbm_peak

    assert hbm_peak("NVIDIA H200") == 4.8e12
    with pytest.raises(KeyError, match="no peak bandwidth"):
        hbm_peak("some other card")


def test_require_gpu_refuses_cpu():
    from opticalflow2d_tpu.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    proc = _run_script(os.path.join(REPO, script), REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _tiny_demo_pair():
    from examples.demo import synthesize_pair

    out = []
    for img in synthesize_pair(40, seed=3):
        img = (img - img.min()) / (img.max() - img.min())
        out.append(np.pad(img, ((3, 3), (0, 0)), mode="edge")
                   .astype(np.float32))
    return out


def test_chip_smoke_session_phase_tiny():
    import chip_smoke

    fails = []
    rows = chip_smoke.phase_session(*_tiny_demo_pair(), "cpu", fails,
                                    niter=(5, 5))
    assert fails == []
    assert sorted(rows) == sorted([m.name for m in Method]
                                  + ["FLUID (textured)"])
    for row in rows.values():
        assert row["iters"] == row["iters_ref"]


def test_chip_smoke_batch_phase_tiny():
    import chip_smoke

    fails = []
    chip_smoke.phase_batch(*chip_smoke.batch_pairs(24, 3), "cpu", fails,
                           niter=(4, 4))
    assert fails == []


def test_chip_smoke_large_phase_tiny():
    import chip_smoke

    fails = []
    chip_smoke.phase_large("cpu", fails, n_diffeo=48, n_thirion=64,
                           niter=(3, 3, 3))
    assert fails == []


def test_chip_smoke_four_card_phase_tiny():
    """The four-card path on four of the suite's virtual CPU devices."""
    import chip_smoke

    fails = []
    chip_smoke.phase_four_cards("cpu", fails, n_batch=24, n_sp=32,
                                niter=(4, 4))
    assert fails == []


@pytest.mark.parametrize("name", ["diffusion", "curvature", "elastic",
                                  "fluid", "thirions", "diffeo"])
def test_bench_level_steps(name):
    """Each timed body is one finite, state-preserving iteration."""
    import bench
    from examples.demo import REGPARAMS, synthesize_pair_jax

    iref, imov = synthesize_pair_jax(32, seed=3)

    def cfg_for(method):
        return RegConfig.from_regparams(method, [25, 25], 1,
                                        REGPARAMS[method])

    body = bench._level_steps(iref[:30], imov[:30], cfg_for)[name]
    u0 = jnp.zeros((2, 30, 32), jnp.float32)
    state = (u0, u0) if name == "fluid" else u0
    out = jax.jit(body)(state)
    leaves = jax.tree_util.tree_leaves(out)
    assert [x.shape for x in leaves] == [x.shape for x in
                                         jax.tree_util.tree_leaves(state)]
    assert all(bool(jnp.isfinite(x).all()) for x in leaves)
    assert bench._PLANES[name] >= 6
