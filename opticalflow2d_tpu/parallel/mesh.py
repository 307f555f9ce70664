"""Mesh helpers.

The framework uses at most two mesh axes:
- ``"data"``: batch of registration pairs (DP) — embarrassingly parallel,
  the data-parallel replacement for the reference wrapper's
  one-pair-at-a-time loop (``WrapperOpticalFlow2d.cpp:86-102``).
- ``"x"``: spatial strips of the image's x axis (the SP/CP analog) with
  halo exchange for stencil sweeps (SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    x: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ``(data, x)`` mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = data * x
    if len(devices) < n:
        raise ValueError(f"need {n} devices for mesh (data={data}, x={x}), "
                         f"have {len(devices)}")
    dev = np.array(devices[:n]).reshape(data, x)
    return Mesh(dev, ("data", "x"))
