"""Backward bilinear warping, motion composition, and the exponential map.

Matches the reference semantics precisely, including the edge-weight
renormalization and the out-of-bounds passthrough:
- ``warp2d``: reference ``src/Image.cpp:119-182``
- ``compose`` (= ``Motion::accumulate``): reference ``src/Motion.cpp:113-178``
- ``expmap`` (scaling-and-squaring): reference ``src/Motion.cpp:253-277``
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from opticalflow2d_tpu.ops.reduce import motion_maxabs


def _gather_taps_exact(data, dx, dy):
    """The four bilinear taps via flat-index XLA take (exact for any
    displacement)."""
    nx, ny = data.shape[-2], data.shape[-1]
    dxc = jnp.clip(dx, 0, nx - 1)
    dyc = jnp.clip(dy, 0, ny - 1)
    dxc1 = jnp.clip(dx + 1, 0, nx - 1)
    dyc1 = jnp.clip(dy + 1, 0, ny - 1)
    flat = data.reshape(*data.shape[:-2], nx * ny)
    out_shape = dx.shape  # may differ from data's grid (e.g. upsampling)

    def take(ix, iy):
        out = jnp.take(flat, (ix * ny + iy).reshape(-1), axis=-1, mode="clip")
        return out.reshape(*data.shape[:-2], *out_shape)

    return (
        take(dxc, dyc),
        take(dxc1, dyc),
        take(dxc, dyc1),
        take(dxc1, dyc1),
    )


def _gather_taps_rolls(data, dx, dy, halo: int):
    """The four bilinear taps via masked circular shifts — a gather-free
    tap fetch for displacement-bounded warps (shift-and-select only).
    Valid when ``floor(px) - i`` lies in ``[-halo, halo]`` for
    every pixel; callers guard with a runtime bound check (``lax.cond``).

    Taps whose weights are masked to zero (edge/out-of-bounds handling in
    the caller) may read wrapped garbage harmlessly.
    """
    nx, ny = data.shape[-2], data.shape[-1]
    gi = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 0)
    gj = jax.lax.broadcasted_iota(jnp.int32, (nx, ny), 1)
    rx = dx - gi
    ry = dy - gj

    # Share the (expensive) lane-dim rolls across all sublane offsets:
    # (2H+2) lane rolls + (2H+2)^2 cheap sublane rolls instead of
    # (2H+2)^2 full 2D rolls.
    lane_rolls = {
        b: jnp.roll(data, -b, axis=-1) for b in range(-halo, halo + 2)
    }
    rolls = {}

    def rolled(a, b):
        if (a, b) not in rolls:
            rolls[(a, b)] = jnp.roll(lane_rolls[b], -a, axis=-2)
        return rolls[(a, b)]

    g00 = jnp.zeros_like(data)
    g10 = jnp.zeros_like(data)
    g01 = jnp.zeros_like(data)
    g11 = jnp.zeros_like(data)
    for ox in range(-halo, halo + 1):
        mx = rx == ox
        for oy in range(-halo, halo + 1):
            m = mx & (ry == oy)  # broadcasts over any leading component axes
            g00 = jnp.where(m, rolled(ox, oy), g00)
            g10 = jnp.where(m, rolled(ox + 1, oy), g10)
            g01 = jnp.where(m, rolled(ox, oy + 1), g01)
            g11 = jnp.where(m, rolled(ox + 1, oy + 1), g11)
    return g00, g10, g01, g11


def _bilinear_from_taps(data, px, py, taps_fn):
    """Shared core of warp2d/compose: weights, edge renormalization, and the
    out-of-bounds floor-cell check, with the tap fetch pluggable.

    Tap inclusion mirrors the reference: the (dx+1, *) taps are only added
    when ``dx < nx-1``, etc., and the result is renormalized by the summed
    weight of included taps (reference ``src/Image.cpp:155-173``).
    """
    nx, ny = data.shape[-2], data.shape[-1]

    dxf = jnp.floor(px)
    dyf = jnp.floor(py)
    fx = px - dxf
    fy = py - dyf
    dx = dxf.astype(jnp.int32)
    dy = dyf.astype(jnp.int32)

    in_bounds = (dx >= 0) & (dx < nx) & (dy >= 0) & (dy < ny)

    has_x1 = dx < nx - 1
    has_y1 = dy < ny - 1

    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = jnp.where(has_x1, fx * (1.0 - fy), 0.0)
    w01 = jnp.where(has_y1, (1.0 - fx) * fy, 0.0)
    w11 = jnp.where(has_x1 & has_y1, fx * fy, 0.0)

    g00, g10, g01, g11 = taps_fn(data, dx, dy)
    value = g00 * w00 + g10 * w10 + g01 * w01 + g11 * w11
    weight = w00 + w10 + w01 + w11
    return value, weight, in_bounds


def _displacement_bounded(data, px, py, halo: int):
    """Runtime predicate: every in-bounds sample's floor offset within
    ``halo`` (out-of-bounds pixels take the passthrough path and are
    ignored)."""
    nx, ny = data.shape[-2], data.shape[-1]
    gi = jax.lax.broadcasted_iota(px.dtype, (nx, ny), 0)
    gj = jax.lax.broadcasted_iota(px.dtype, (nx, ny), 1)
    dx = jnp.floor(px)
    dy = jnp.floor(py)
    in_b = (dx >= 0) & (dx < nx) & (dy >= 0) & (dy < ny)
    off_pix = jnp.maximum(jnp.abs(dx - gi), jnp.abs(dy - gj))
    return jnp.max(jnp.where(in_b, off_pix, 0.0)) <= halo


# Largest extent at which the roll fast path is traced. The chain's
# (2h+2)^2 shifted copies make its compile time grow with the extent; past
# this, halo>0 takes the exact gather (identical results). Whether the
# roll path stays at all is ROADMAP design item 3.
_ROLL_PATH_MAX_EXTENT = 4096


def _bilinear_gather(data, px, py, halo: int = 0):
    """Dispatch: exact gather (``halo=0``) or roll-based fast path guarded
    by a runtime displacement bound (``lax.cond`` falls back to the exact
    gather when any pixel's floor offset exceeds ``halo``)."""
    if halo > 0 and max(data.shape[-2], data.shape[-1]) > _ROLL_PATH_MAX_EXTENT:
        halo = 0  # exact gather past this extent (see above)
    if halo <= 0:
        return _bilinear_from_taps(data, px, py, _gather_taps_exact)

    def fast(_):
        return _bilinear_from_taps(
            data, px, py, lambda d, a, b: _gather_taps_rolls(d, a, b, halo)
        )

    def exact(_):
        return _bilinear_from_taps(data, px, py, _gather_taps_exact)

    return jax.lax.cond(
        _displacement_bounded(data, px, py, halo), fast, exact, None
    )


def _sample_coords(u: jnp.ndarray):
    nx, ny = u.shape[-2], u.shape[-1]
    gi = jax.lax.broadcasted_iota(u.dtype, (nx, ny), 0)
    gj = jax.lax.broadcasted_iota(u.dtype, (nx, ny), 1)
    px = gi + u[..., 0, :, :]
    py = gj + u[..., 1, :, :]
    return px, py


def warp2d(image: jnp.ndarray, u: jnp.ndarray, halo: int = 0) -> jnp.ndarray:
    """Backward-warp ``image [nx, ny]`` by motion ``u [2, nx, ny]``:
    out(x) = I(x + u(x)) with bilinear interpolation.

    Out-of-bounds samples (floor corner outside the grid) keep the original
    image value; edge samples are renormalized by the summed in-bounds tap
    weight (reference ``src/Image.cpp:137-175``).

    ``halo > 0`` enables the roll-based fast path for displacement-bounded
    fields (identical results; a runtime bound check falls back to the
    exact gather when ``max |floor offset| > halo``).
    """
    px, py = _sample_coords(u)
    value, weight, in_bounds = _bilinear_gather(image[None], px, py, halo)
    value = value[0]
    ok = in_bounds & (weight != 0)
    safe_w = jnp.where(weight != 0, weight, 1.0)
    return jnp.where(ok, value / safe_w, image)


def compose(u_total: jnp.ndarray, u_inc: jnp.ndarray, halo: int = 0) -> jnp.ndarray:
    """Motion composition ``u <- u_inc + u_total(x + u_inc)``.

    This is the reference's ``Motion::accumulate`` (``src/Motion.cpp:113-178``):
    the *accumulated* field is backward-warped by the increment and the
    increment is added. Out-of-bounds pixels keep the old accumulated value;
    pixels whose bilinear weight vanishes keep only the increment.
    ``halo``: see ``warp2d``.
    """
    px, py = _sample_coords(u_inc)
    value, weight, in_bounds = _bilinear_gather(u_total, px, py, halo)
    safe_w = jnp.where(weight != 0, weight, 1.0)
    warped = value / safe_w
    # In bounds & weight != 0: u_inc + warped(u_total)
    # In bounds & weight == 0: u_inc alone (reference sets field=moin then
    #                          skips the += when weight == 0)
    # Out of bounds:           old u_total untouched
    inc_plus = u_inc + jnp.where(weight != 0, warped, 0.0)
    return jnp.where(in_bounds[None], inc_plus, u_total)


def expmap(u: jnp.ndarray, maxabs_bug: bool = False, halo: int = 0) -> jnp.ndarray:
    """Exponential map of a velocity field by scaling and squaring
    (reference ``src/Motion.cpp:253-277``).

    ``nsq = max(0, ceil(1 + log2(maxabs(u))))``; u is scaled by ``2^-nsq``
    and self-composed ``nsq`` times. ``maxabs_bug=True`` reproduces the
    reference's ``Motion::maxabs`` defect (``src/Motion.cpp:54``, uses the y
    component twice), which changes the number of squarings.
    """
    m = motion_maxabs(u, bug=maxabs_bug)
    # log2(0) = -inf -> nsq clamps to 0 -> identity (matches the reference's
    # early return for nsquares == 0).
    nsq_f = jnp.ceil(1.0 + jnp.log2(jnp.maximum(m, jnp.finfo(u.dtype).tiny)))
    nsq = jnp.maximum(nsq_f, 0.0).astype(jnp.int32)
    nsq = jnp.where(m > 0, nsq, 0)

    scaled = u * jnp.exp2(-nsq.astype(u.dtype))

    def body(_, v):
        # The scaled field has maxabs < 1, and each squaring at most doubles
        # it back toward the original magnitude; a small halo covers every
        # squaring step except the last few of large fields, which the
        # runtime bound check in compose() routes to the exact path.
        return compose(v, v, halo)

    return jax.lax.fori_loop(0, nsq, body, scaled)
