"""Test harness: force the CPU backend with 8 virtual devices so sharding
tests run anywhere; numerics match the GPU modulo float rounding."""

import os

# Set before any backend initializes: the tests run on the CPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_pair(nx=48, ny=40, shift=(1.5, -0.8), rng=None):
    """Synthetic smooth image pair with a known constant translation:
    Imov(x) = Iref(x - shift) so that warping Imov by u=shift recovers Iref."""
    rng = rng or np.random.default_rng(0)
    xs = np.arange(nx)[:, None]
    ys = np.arange(ny)[None, :]

    def img(ox, oy):
        g = np.zeros((nx, ny))
        for (cx, cy, s, a) in [
            (nx * 0.4, ny * 0.5, 6.0, 1.0),
            (nx * 0.65, ny * 0.3, 4.0, 0.7),
            (nx * 0.3, ny * 0.75, 5.0, 0.5),
        ]:
            g += a * np.exp(-(((xs - ox) - cx) ** 2 + ((ys - oy) - cy) ** 2) / (2 * s * s))
        return g

    iref = img(0.0, 0.0)
    imov = img(shift[0], shift[1])
    return iref.astype(np.float32), imov.astype(np.float32)
