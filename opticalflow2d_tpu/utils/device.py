"""The card a measurement runs on: its name, power limit and peak rates.

A time is only meaningful beside the card that produced it, and a card
set below its maximum power limit runs slower under load, so every
measurement script prints what ``nvidia-smi`` reports next to its numbers.
"""

from __future__ import annotations

import subprocess

import jax

# Published peak device-memory bandwidth, bytes/s, keyed by JAX's
# ``device_kind`` (NVIDIA H200 SXM data sheet). A card missing here is an
# error, not a default.
HBM_BYTES_PER_S = {
    "NVIDIA H200": 4.8e12,
}

_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def require_gpu() -> list:
    """The GPU devices JAX sees; raises when the default backend is not a
    GPU, so that no measurement silently falls back to the CPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")
    return jax.devices()


def nvidia_smi_lines() -> list[str]:
    """``name, power.limit`` of each card, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(_SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def parse_nvidia_smi(line: str) -> tuple[str, float]:
    """``"NVIDIA H200, 700.00 W"`` -> ``("NVIDIA H200", 700.0)``."""
    name, limit = (part.strip() for part in line.rsplit(",", 1))
    value, unit = limit.split()
    if unit != "W":
        raise ValueError(f"power limit not in watts: {line!r}")
    return name, float(value)


def hbm_peak(device_kind: str) -> float:
    """Published peak memory bandwidth (bytes/s) of ``device_kind``."""
    try:
        return HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth recorded for {device_kind!r}; add it to "
            f"HBM_BYTES_PER_S with its source") from None
