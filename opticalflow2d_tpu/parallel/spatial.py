"""Spatial (grid) sharding — the sequence-parallel analog for large images
(SURVEY.md §2.2, §5 "long-context").

Two complementary paths:

1. ``register_sharded``: the full registration pipeline jitted with the
   images sharded in strips along x (``P('x', None)``). XLA's SPMD
   partitioner inserts the halo exchanges (collective-permutes) for every
   shift/pad stencil and handles the DCT matmuls as sharded matmuls — the
   "annotate shardings, let XLA insert collectives" recipe. Numerically
   identical to the single-device trace.

2. Explicit ``shard_map`` drivers: hand-scheduled strip-local pipelines
   with ppermute halo exchange, used to validate and benchmark against
   path 1. Every family's
   per-iteration body lives in exactly ONE strip-local function
   (``_demons_iter_strip``, ``_sor_sweep_strip``, ``_diffusion_step``,
   ``_curvature_solve_strip``, ``_fluid_level_strip``); the public
   ``make_*_sharded`` / ``make_register_sp`` factories are thin shard_map
   wrappers around them.
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from opticalflow2d_tpu.config import RegConfig
from opticalflow2d_tpu.engine.registration import _register_impl, RegistrationResult


# ---------------------------------------------------------------------------
# Path 1: whole-pipeline SPMD via sharding annotations
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _jitted_register_sharded(cfg: RegConfig, mesh: Mesh):
    img_sharding = NamedSharding(mesh, P("x", None))
    replicated = NamedSharding(mesh, P())
    return jax.jit(
        lambda r, m: _register_impl(r, m, cfg),
        in_shardings=(img_sharding, img_sharding),
        out_shardings=replicated,
    )


def register_sharded(iref, imov, cfg: RegConfig, mesh: Mesh) -> RegistrationResult:
    """Run the full registration with the image grid sharded in x-strips
    across the mesh's ``"x"`` axis. Semantics identical to ``register``."""
    iref = jnp.asarray(iref)
    imov = jnp.asarray(imov)
    return _jitted_register_sharded(cfg, mesh)(iref, imov)


# ---------------------------------------------------------------------------
# Path 2 building blocks: strip-local ops with explicit halo exchange.
# Everything below runs INSIDE shard_map on ``[..., nxl, ny]`` local strips
# of the mesh's "x" axis. ``lax.psum(1, axis)`` of a Python int is
# constant-folded to the static axis size, so global extents stay static.
# ---------------------------------------------------------------------------

def _strip_info(shape_local, axis_name: str):
    """(gi, gj, nx_glob): global row/col index grids for a local strip."""
    nxl, ny = shape_local
    idx = lax.axis_index(axis_name)
    n = lax.psum(1, axis_name)
    gi = lax.broadcasted_iota(jnp.int32, (nxl, ny), 0) + idx * nxl
    gj = lax.broadcasted_iota(jnp.int32, (nxl, ny), 1)
    return gi, gj, n * nxl


def _halo_exchange_k(f: jnp.ndarray, k: int, axis_name: str):
    """Exchange k-row halos along the sharded x axis. Returns (top, bot)
    blocks of shape ``[..., k, ny]`` (zeros at the global boundary).

    Supports ``k > nxl`` (halo wider than a strip, e.g. warp halos at coarse
    pyramid levels) via multi-hop ppermutes: whole neighbour strips are
    pulled hop by hop and the halo sliced from their concatenation.
    """
    nxl = f.shape[-2]
    n = lax.psum(1, axis_name)
    if k <= nxl:
        send_down = [(i, i + 1) for i in range(n - 1)]
        send_up = [(i + 1, i) for i in range(n - 1)]
        top = lax.ppermute(f[..., -k:, :], axis_name, send_down)
        bot = lax.ppermute(f[..., :k, :], axis_name, send_up)
        return top, bot

    hops = -(-k // nxl)  # ceil
    top_parts = []
    bot_parts = []
    for h in range(hops, 0, -1):
        top_parts.append(
            lax.ppermute(f, axis_name, [(i, i + h) for i in range(n - h)])
        )
    for h in range(1, hops + 1):
        bot_parts.append(
            lax.ppermute(f, axis_name, [(i + h, i) for i in range(n - h)])
        )
    top = jnp.concatenate(top_parts, axis=-2)[..., -k:, :]
    bot = jnp.concatenate(bot_parts, axis=-2)[..., :k, :]
    return top, bot


def _halo_pad(f: jnp.ndarray, k: int, axis_name: str) -> jnp.ndarray:
    """Local strip extended with k exchanged halo rows on each side."""
    top, bot = _halo_exchange_k(f, k, axis_name)
    return jnp.concatenate([top, f, bot], axis=-2)


def _qlaplacian_halo(f: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """Quasi-laplacian (4-neighbour average, zero at global borders) on a
    local x-strip with halo exchange. ``f`` is ``[..., nxl, ny]``."""
    nxl, ny = f.shape[-2], f.shape[-1]
    fp = _halo_pad(f, 1, axis_name)  # [..., nxl+2, ny]

    x_sum = fp[..., 2:, :] + fp[..., :-2, :]
    y_pad = jnp.pad(f, [(0, 0)] * (f.ndim - 1) + [(1, 1)])
    y_sum = y_pad[..., :, 2:] + y_pad[..., :, :-2]
    q = (x_sum + y_sum) * 0.25

    # Zero the global borders (gradients.h:72-80): global first/last row and
    # first/last column.
    gi, gj, nx_glob = _strip_info((nxl, ny), axis_name)
    border = (gi == 0) | (gi == nx_glob - 1) | (gj == 0) | (gj == ny - 1)
    return jnp.where(border, 0.0, q)


def _partials_strip(f: jnp.ndarray, axis_name: str):
    """(d/dx, d/dy) of each channel of ``f [..., nxl, ny]``: central
    differences with 1-row halo exchange in x, one-sided at the global
    borders (matches ``ops.grid`` partials)."""
    nxl, ny = f.shape[-2], f.shape[-1]
    gi, _, nx_glob = _strip_info((nxl, ny), axis_name)
    fp = _halo_pad(f, 1, axis_name)
    gx = (fp[..., 2:, :] - fp[..., :-2, :]) * 0.5
    first = fp[..., 2:, :] - fp[..., 1:-1, :]   # forward diff (global row 0)
    last = fp[..., 1:-1, :] - fp[..., :-2, :]   # backward diff (row nx-1)
    gx = jnp.where(gi == 0, first, jnp.where(gi == nx_glob - 1, last, gx))

    from opticalflow2d_tpu.ops.grid import partial_y

    return gx, partial_y(f)  # y is unsharded


def _gradient_local(img_loc: jnp.ndarray, axis_name: str) -> jnp.ndarray:
    """``[nxl, ny] -> [2, nxl, ny]`` spatial gradient (matches
    ``ops.grid.spatial_gradient``)."""
    gx, gy = _partials_strip(img_loc, axis_name)
    return jnp.stack([gx, gy], axis=0)


def _norm_psum(v, axis_name: str):
    """Mean per-pixel magnitude of a motion field across all strips
    (the reference Logger's norm, src/Logger.cpp:32-58)."""
    mag = jnp.sqrt(v[0] ** 2 + v[1] ** 2)
    return lax.psum(jnp.sum(mag), axis_name) / lax.psum(
        jnp.float32(mag.size), axis_name
    )


def _rel_err_psum(u_new, prev, axis_name: str):
    """Logger relative step error with psum-reduced norms."""
    pn = _norm_psum(prev, axis_name)
    dn = _norm_psum(u_new - prev, axis_name)
    return jnp.where(pn == 0, 0.0, dn / jnp.where(pn == 0, 1.0, pn))


def _redblack_masks(shape_local, axis_name: str):
    """(red, black) interior checkerboard masks in GLOBAL coordinates."""
    nxl, ny = shape_local
    gi, gj, nx_glob = _strip_info(shape_local, axis_name)
    interior = (gi >= 1) & (gi <= nx_glob - 2) & (gj >= 1) & (gj <= ny - 2)
    red = ((gi + gj) % 2 == 0) & interior
    black = ((gi + gj) % 2 == 1) & interior
    return red, black


def _sor_sweep_strip(x, b, mu, lam, omega, reference_stencil, axis_name: str):
    """One full red-black Navier-Lame SOR sweep on local strips with 1-row
    halo exchange per half-sweep. Matches the unsharded
    ``solvers.elastic.sor_sweep`` exactly: global-coordinate masks, borders
    untouched, identical stencil — only the neighbour fetch differs
    (ppermute halos instead of pad). THE single definition of the sharded
    SOR body (elastic step, fluid velocity solve, standalone sweeps)."""
    from opticalflow2d_tpu.solvers.elastic import _gs_candidate

    ny = x.shape[-1]
    red, black = _redblack_masks((x.shape[-2], ny), axis_name)
    zrow = jnp.zeros((2, 1, ny), x.dtype)
    b_pad = jnp.concatenate([zrow, b, zrow], axis=-2)

    def half(x, mask):
        xp = _halo_pad(x, 1, axis_name)
        cand = _gs_candidate(xp, b_pad, mu, lam, omega, reference_stencil)
        return jnp.where(mask, cand[:, 1:-1, :], x)

    return half(half(x, red), black)


def _gaussian_local(f, sigma: float, width: int, axis_name: str = "x"):
    """Strip-local boundary-renormalized separable Gaussian smoothing
    (matches ``ops.conv.convolve2d_clip``): c-row halo exchange for the
    x pass; the renormalization denominator comes from global positions."""
    from opticalflow2d_tpu.ops.conv import gaussian_kernel_1d, _sepconv_axis

    c = (width - 1) // 2
    g = gaussian_kernel_1d(sigma, width)

    fp = _halo_pad(f, c, axis_name)
    num = _sepconv_axis(fp, g, fp.ndim - 2)
    num = num[..., c:-c, :]
    num = _sepconv_axis(num, g, num.ndim - 1)

    nxl, ny = f.shape[-2], f.shape[-1]
    idx = lax.axis_index(axis_name)
    n = lax.psum(1, axis_name)
    nx_glob = n * nxl
    gi = (lax.broadcasted_iota(jnp.int32, (nxl, 1), 0) + idx * nxl).astype(f.dtype)
    gj = lax.broadcasted_iota(jnp.int32, (1, ny), 1).astype(f.dtype)
    # denominator: sum of in-bounds taps = separable 1D sums of clipped
    # windows, computed from global positions.
    taps = jnp.asarray(g, f.dtype)

    def den_1d(pos, nglob):
        # pos [..., 1] broadcastable; den(pos) = sum_t g[t] * [0 <= pos+t-c < n]
        total = jnp.zeros_like(pos)
        for t in range(width):
            off = t - c
            total = total + taps[t] * (
                (pos + off >= 0) & (pos + off <= nglob - 1)
            ).astype(f.dtype)
        return total

    den = den_1d(gi, nx_glob) * den_1d(gj, ny)
    return num / den


def make_gaussian_smooth_sharded(mesh: Mesh, sigma: float, width: int):
    """Boundary-renormalized separable Gaussian smoothing with k/2-row
    halo exchange; matches ``ops.conv.convolve2d_clip`` exactly.
    Signature: ``f [..., nx, ny] -> f`` sharded ``P(..., 'x', None)``."""

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(None, "x", None),),
        out_specs=P(None, "x", None), check_vma=False,
    )
    def smooth(f):
        return _gaussian_local(f, sigma, width)

    return jax.jit(smooth)


# --- strip-local warp / compose (masked-roll gather over halos) -----------

def _bilinear_local(data_loc, px, py, halo: int, axis_name: str):
    """Local-strip bilinear tap fetch via halo exchange + masked rolls.

    ``data_loc [..., nxl, ny]``; ``px, py [nxl, ny]`` are GLOBAL sample
    coordinates. Valid within the displacement contract ``|floor offset| <=
    halo``. Returns (value, weight, in_bounds) with the reference's edge
    renormalization and floor-cell bounds semantics.
    """
    nxl, ny = data_loc.shape[-2], data_loc.shape[-1]
    gi, gj, nx_glob = _strip_info((nxl, ny), axis_name)
    h1 = halo + 1

    dx = jnp.floor(px)
    dy = jnp.floor(py)
    fx = px - dx
    fy = py - dy
    dxi = dx.astype(jnp.int32)
    dyi = dy.astype(jnp.int32)
    in_bounds = (dxi >= 0) & (dxi < nx_glob) & (dyi >= 0) & (dyi < ny)
    rx = dxi - gi
    ry = dyi - gj

    pad = _halo_pad(data_loc, h1, axis_name)

    lane_rolls = {b: jnp.roll(pad, -b, axis=-1) for b in range(-halo, halo + 2)}
    rolls = {}

    def rolled(a, b):
        if (a, b) not in rolls:
            rolls[(a, b)] = jnp.roll(lane_rolls[b], -a, axis=-2)[
                ..., h1 : h1 + nxl, :
            ]
        return rolls[(a, b)]

    z = jnp.zeros_like(data_loc)
    g00, g10, g01, g11 = z, z, z, z
    for ox in range(-halo, halo + 1):
        mx = rx == ox
        for oy in range(-halo, halo + 1):
            m = mx & (ry == oy)
            g00 = jnp.where(m, rolled(ox, oy), g00)
            g10 = jnp.where(m, rolled(ox + 1, oy), g10)
            g01 = jnp.where(m, rolled(ox, oy + 1), g01)
            g11 = jnp.where(m, rolled(ox + 1, oy + 1), g11)

    has_x1 = dxi < nx_glob - 1
    has_y1 = dyi < ny - 1
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = jnp.where(has_x1, fx * (1.0 - fy), 0.0)
    w01 = jnp.where(has_y1, (1.0 - fx) * fy, 0.0)
    w11 = jnp.where(has_x1 & has_y1, fx * fy, 0.0)
    value = g00 * w00 + g10 * w10 + g01 * w01 + g11 * w11
    weight = w00 + w10 + w01 + w11
    return value, weight, in_bounds


def _global_coords(u_loc, axis_name: str):
    nxl, ny = u_loc.shape[-2], u_loc.shape[-1]
    idx = lax.axis_index(axis_name)
    gi = lax.broadcasted_iota(u_loc.dtype, (nxl, ny), 0) + (idx * nxl).astype(
        u_loc.dtype
    )
    gj = lax.broadcasted_iota(u_loc.dtype, (nxl, ny), 1)
    return gi + u_loc[0], gj + u_loc[1]


def _warp_local(img_loc, u_loc, halo: int, axis_name: str):
    px, py = _global_coords(u_loc, axis_name)
    value, weight, in_b = _bilinear_local(img_loc, px, py, halo, axis_name)
    ok = in_b & (weight != 0)
    return jnp.where(ok, value / jnp.where(weight != 0, weight, 1.0), img_loc)


def _compose_local(u_tot_loc, u_inc_loc, halo: int, axis_name: str):
    px, py = _global_coords(u_inc_loc, axis_name)
    value, weight, in_b = _bilinear_local(u_tot_loc, px, py, halo, axis_name)
    warped = value / jnp.where(weight != 0, weight, 1.0)
    inc_plus = u_inc_loc + jnp.where(weight != 0, warped, 0.0)
    return jnp.where(in_b, inc_plus, u_tot_loc)


def _expmap_strip(c, halo: int, axis_name: str):
    """Scaling-and-squaring exponential of a correspondence field with a
    globally reduced max-magnitude (matches ``ops.warp.expmap``)."""
    normsq = c[0] ** 2 + c[1] ** 2
    m = jnp.sqrt(lax.pmax(jnp.max(normsq), axis_name))
    nsq_f = jnp.ceil(1.0 + jnp.log2(jnp.maximum(m, jnp.finfo(c.dtype).tiny)))
    nsq = jnp.where(m > 0, jnp.maximum(nsq_f, 0.0), 0.0).astype(jnp.int32)
    v = c * jnp.exp2(-nsq.astype(c.dtype))
    return lax.fori_loop(
        0, nsq, lambda _, w: _compose_local(w, w, halo, axis_name), v
    )


# --- family iteration bodies (ONE definition each) ------------------------

def _demons_iter_strip(u_est, iref_l, iaux, p: dict, halo: int,
                       diffeomorphic: bool, axis_name: str):
    """One Thirion/diffeomorphic demons iteration on local strips:
    halo-exchanged warp -> gradient -> demons force -> fluid smoothing ->
    (exp map ->) compose -> diffusion smoothing. THE single definition of
    the sharded demons body (step driver, level driver, SP pyramid).
    Matches ``solvers.demons.make_demons_step`` (DemonsThirions.cpp:18-42).
    """
    iwar = _warp_local(iaux, u_est, halo, axis_name)
    grad = _gradient_local(iwar, axis_name)
    it_img = iwar - iref_l
    den = (grad[0] ** 2 + grad[1] ** 2
           + it_img ** 2 * (p["sigma_i"] ** 2) / (p["sigma_x"] ** 2))
    num = grad * it_img[None] * -1.0
    c = jnp.where(den[None] > 0,
                  num / jnp.where(den[None] > 0, den[None], 1.0), 0.0)
    c = _gaussian_local(c, p["sigma_fluid"], p["kernelwidth"], axis_name)
    if diffeomorphic:
        c = _expmap_strip(c, halo, axis_name)
    u_new = _compose_local(u_est, c, halo, axis_name)
    return _gaussian_local(u_new, p["sigma_diffusion"], p["kernelwidth"],
                           axis_name)


def _diffusion_consts_strip(grad_i, it_img, alpha: float):
    den = alpha * alpha + grad_i[0] ** 2 + grad_i[1] ** 2
    return grad_i, it_img, den


def _diffusion_step_strip(u_est, grad_i, it_img, den, axis_name: str):
    """One Horn-Schunck Jacobi update on local strips (matches
    ``solvers.diffusion.diffusion_step``)."""
    q = _qlaplacian_halo(u_est, axis_name)
    inner = it_img + q[0] * grad_i[0] + q[1] * grad_i[1]
    f = grad_i * inner[None]
    return q - f / den[None]


def _elastic_step_strip(u_est, grad_i, it_img, p: dict, axis_name: str):
    """One elastic iteration: L-SSD force then one red-black SOR sweep on
    the motion (matches ``solvers.elastic.elastic_step``)."""
    inner = it_img + u_est[0] * grad_i[0] + u_est[1] * grad_i[1]
    b = grad_i * inner[None]
    return _sor_sweep_strip(
        b=b, x=u_est, mu=p["mu"], lam=p["lam"], omega=p.get("omega", 0.66),
        reference_stencil=p.get("reference_stencil", True),
        axis_name=axis_name,
    )


def _curvature_solve_strip(rhs, nx_g: int, ny_g: int, alpha: float,
                           tau: float, axis_name: str,
                           precision=lax.Precision.HIGHEST):
    """Distributed semi-implicit curvature solve of ``rhs [c, nxl, ny]``:
    local y-DCT, all_to_all transpose between devices, local x-DCT + eigenvalue
    multiply in the transposed layout, inverse transforms back — two
    all_to_alls total (the classic distributed-FFT decomposition). THE
    single definition of the sharded DCT body (also used by
    ``parallel.dct_dist``). Matches ``solvers.curvature.make_curvature_step``
    (OpticalFlowCurvature.cpp:144-167)."""
    from opticalflow2d_tpu.ops.dct import _dct_matrix, curvature_eigenvalues

    n = lax.psum(1, axis_name)
    nyl = ny_g // n
    # _dct_matrix switches to on-device generation past 2048 so no
    # giant transform constants ride the compile request (ops/dct.py).
    c2x = _dct_matrix(nx_g, 2, rhs.dtype)
    c3x = _dct_matrix(nx_g, 3, rhs.dtype)
    c2y = _dct_matrix(ny_g, 2, rhs.dtype)
    c3y = _dct_matrix(ny_g, 3, rhs.dtype)
    eig = curvature_eigenvalues(nx_g, ny_g, alpha, tau, rhs.dtype)
    scale = 1.0 / (4.0 * nx_g * ny_g)

    t = jnp.matmul(rhs, c2y.T, precision=precision)
    t = lax.all_to_all(t, axis_name, split_axis=2, concat_axis=1, tiled=True)
    eig_slice = lax.dynamic_slice(
        eig, (0, lax.axis_index(axis_name) * nyl), (nx_g, nyl)
    )
    t = jnp.einsum("kx,cxy->cky", c2x, t, precision=precision) * eig_slice[None]
    t = jnp.einsum("kx,cxy->cky", c3x, t, precision=precision)
    t = lax.all_to_all(t, axis_name, split_axis=1, concat_axis=2, tiled=True)
    t = jnp.matmul(t, c3y.T, precision=precision)
    return t * scale


def _curvature_step_strip(u_est, grad_i, it_img, p: dict, nx_g: int,
                          ny_g: int, axis_name: str):
    """One curvature iteration: L-SSD force, rhs, distributed DCT solve."""
    inner = it_img + u_est[0] * grad_i[0] + u_est[1] * grad_i[1]
    f = grad_i * inner[None]
    rhs = u_est - p.get("tau", 1.0) * f
    # Default HIGH: matches the serial driver's dct_impl="auto" resolution
    # (RegConfig.resolved_dct_impl), so SP-vs-serial comparisons stay
    # precision-consistent.
    return _curvature_solve_strip(
        rhs, nx_g, ny_g, p["alpha"], p.get("tau", 1.0), axis_name,
        p.get("dct_precision", lax.Precision.HIGH),
    )


def _fluid_level_strip(u, iref_l, imov_l, niter: int, halo: int, p: dict,
                       convergence_tol: float, axis_name: str):
    """A full viscous-fluid LEVEL solve on local strips: per-iteration
    red-black SOR velocity solve, material-derivative increment, adaptive
    timestep via pmax, Jacobian-triggered regridding via pmin, Logger
    convergence gate via psum norms, final composition. THE single
    definition of the sharded fluid loop (level driver AND SP pyramid).
    Matches ``engine.registration._solve_level_fluid``
    (ImageRegistrationFluid.cpp:67-142). Returns (u, iterations, regrids).
    """
    mu, lam = p["mu"], p["lam"]
    omega = p.get("omega", 0.66)
    dumax = p.get("dumax", 0.65)
    ts_skip = p.get("timestep_skip", 65.0)
    rg_thr = p.get("regrid_threshold", 0.5)
    ref_stencil = p.get("reference_stencil", True)

    def derive(u_tot):
        ia = _warp_local(imov_l, u_tot, halo, axis_name)
        return _gradient_local(ia, axis_name), ia - iref_l

    grad_i0, it_img0 = derive(u)

    def fcond(carry):
        it, conv = carry[-3], carry[-2]
        return (it < niter) & ~conv

    def fbody(carry):
        u_tot, u_est, prev, vel, grad_i, it_img, it, conv, nregrid = carry
        inner = it_img + u_est[0] * grad_i[0] + u_est[1] * grad_i[1]
        f = grad_i * inner[None]
        vel = _sor_sweep_strip(vel, f, mu, lam, omega, ref_stencil,
                               axis_name)
        dudx, dudy = _partials_strip(u_est, axis_name)
        r = vel - dudx * vel[0:1] - dudy * vel[1:2]
        m = jnp.sqrt(lax.pmax(jnp.max(r[0] ** 2 + r[1] ** 2), axis_name))
        dt = dumax / m
        do_step = dt < ts_skip
        u_new = jnp.where(do_step, u_est + r * jnp.where(do_step, dt, 0.0),
                          u_est)
        err = _rel_err_psum(u_new, prev, axis_name)
        conv = (err < convergence_tol) & (it > 1)

        dudx2, dudy2 = _partials_strip(u_new, axis_name)
        jac = (1.0 + dudx2[0]) * (1.0 + dudy2[1]) - dudx2[1] * dudy2[0]
        do_regrid = ~conv & (lax.pmin(jnp.min(jac), axis_name) < rg_thr)
        # The Logger's prev is the PRE-regrid logged estimate (it lives
        # outside the regrid block in the reference).
        logged = u_new

        def regrid(args):
            u_tot, u_new, grad_i, it_img = args
            u_tot2 = _compose_local(u_tot, u_new, halo, axis_name)
            g2, t2 = derive(u_tot2)
            return u_tot2, jnp.zeros_like(u_new), g2, t2

        u_tot, u_new, grad_i, it_img = lax.cond(
            do_regrid, regrid, lambda a: a, (u_tot, u_new, grad_i, it_img)
        )
        return (u_tot, u_new, logged, vel, grad_i, it_img, it + 1, conv,
                nregrid + do_regrid.astype(jnp.int32))

    u0 = jnp.zeros_like(u)
    carry = (u, u0, u0, u0, grad_i0, it_img0, jnp.int32(0), jnp.bool_(False),
             jnp.int32(0))
    u_tot, u_est, _, _, _, _, it, _, nregrid = lax.while_loop(
        fcond, fbody, carry
    )
    return _compose_local(u_tot, u_est, halo, axis_name), it, nregrid


def _iterate_level_strip(one_step, u, niter: int, halo: int,
                         convergence_tol: float, axis_name: str):
    """Generic level loop on local strips: while_loop of ``one_step`` gated
    by the Logger relative step error (psum norms), then compose the level
    estimate into the incoming motion. Used by every non-fluid family."""

    def cond(carry):
        _, _, it, conv = carry
        return (it < niter) & ~conv

    def body(carry):
        u_est, prev, it, conv = carry
        u_new = one_step(u_est)
        err = _rel_err_psum(u_new, prev, axis_name)
        conv = (err < convergence_tol) & (it > 1)
        return (u_new, u_new, it + 1, conv)

    u0 = jnp.zeros_like(u)
    u_est, _, it, _ = lax.while_loop(
        cond, body, (u0, u0, jnp.int32(0), jnp.bool_(False))
    )
    return _compose_local(u, u_est, halo, axis_name), it


def _level_local(family: str, u, iref_l, imov_l, level_niter: int, halo: int,
                 p: dict, convergence_tol: float):
    """One level solve on local strips (inside shard_map): family-dispatched
    per-iteration step + the Logger convergence gate + final composition.
    Families: thirions, diffeo, diffusion, elastic, curvature, fluid."""
    if family == "fluid":
        u, it, _ = _fluid_level_strip(
            u, iref_l, imov_l, level_niter, halo, p, convergence_tol, "x",
        )
        return u, it

    iaux = _warp_local(imov_l, u, halo, "x")

    if family in ("thirions", "diffeo"):
        def one_step(u_est):
            return _demons_iter_strip(
                u_est, iref_l, iaux, p, halo, family == "diffeo", "x",
            )
    else:
        grad_i = _gradient_local(iaux, "x")
        it_img = iaux - iref_l
        if family == "diffusion":
            _, _, den = _diffusion_consts_strip(grad_i, it_img, p["alpha"])

            def one_step(u_est):
                return _diffusion_step_strip(u_est, grad_i, it_img, den, "x")
        elif family == "elastic":
            def one_step(u_est):
                return _elastic_step_strip(u_est, grad_i, it_img, p, "x")
        elif family == "curvature":
            nxl, ny = iref_l.shape
            n = lax.psum(1, "x")
            if ny % n:
                raise ValueError("curvature SP needs ny divisible by the mesh")
            nx_g = n * nxl

            def one_step(u_est):
                return _curvature_step_strip(
                    u_est, grad_i, it_img, p, nx_g, ny, "x"
                )
        else:  # pragma: no cover
            raise ValueError(family)

    return _iterate_level_strip(
        one_step, u, level_niter, halo, convergence_tol, "x"
    )


# ---------------------------------------------------------------------------
# Public factories: thin shard_map wrappers around the strip-local bodies
# ---------------------------------------------------------------------------

_SPEC_U = P(None, "x", None)
_SPEC_IM = P("x", None)


def make_sor_sweeps_sharded(
    mesh: Mesh,
    mu: float,
    lam: float,
    omega: float,
    niter: int,
    reference_stencil: bool = True,
):
    """Red-black Navier-Lame SOR sweeps with explicit 1-row halo
    exchange per half-sweep. Signature: ``(x [2,nx,ny], b [2,nx,ny]) -> x``
    with both sharded ``P(None, 'x', None)``."""

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(_SPEC_U, _SPEC_U), out_specs=_SPEC_U,
        check_vma=False,
    )
    def sweeps(x, b):
        return lax.fori_loop(
            0, niter,
            lambda _, x: _sor_sweep_strip(
                x, b, mu, lam, omega, reference_stencil, "x"
            ),
            x,
        )

    return jax.jit(sweeps)


def make_demons_step_sharded(
    mesh: Mesh,
    sigma_i: float,
    sigma_x: float,
    sigma_diffusion: float,
    sigma_fluid: float,
    kernelwidth: int,
    halo: int = 2,
    diffeomorphic: bool = False,
):
    """One Thirion/diffeomorphic demons iteration with every op expressed as
    explicit shard_map collectives: halo-exchanged warp, gradient, Gaussian
    smoothing, and composition; pmax for the exp-map scaling. The fully
    hand-scheduled SP pipeline (contrast with the auto-SPMD
    ``register_sharded`` path).

    Signature: ``(u [2,nx,ny], iref [nx,ny], imov [nx,ny]) -> u`` with u
    sharded ``P(None,'x',None)`` and images ``P('x',None)``. Displacement
    contract: all warp/compose offsets within ``halo``.
    """
    p = dict(sigma_i=sigma_i, sigma_x=sigma_x, sigma_diffusion=sigma_diffusion,
             sigma_fluid=sigma_fluid, kernelwidth=kernelwidth)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(_SPEC_U, _SPEC_IM, _SPEC_IM),
        out_specs=_SPEC_U,
        check_vma=False,
    )
    def step(u, iref, imov):
        return _demons_iter_strip(u, iref, imov, p, halo, diffeomorphic, "x")

    return jax.jit(step)


def make_warp2d_sharded(mesh: Mesh, halo: int):
    """Blockwise backward warp with bounded-displacement halo exchange
    (SURVEY.md §5: the SP-equivalent of the reference's warp window logic,
    ``Image.cpp:144-151``). Each x-strip exchanges ``halo+1`` rows with its
    neighbours and gathers via the masked-roll select chain — no
    global collectives, O(halo) communication per device. Requires every
    in-bounds sample's floor offset within ``halo`` (the serial ``warp2d``
    with its runtime fallback is the safe general path).

    Signature: ``(image [nx, ny], u [2, nx, ny]) -> warped [nx, ny]`` with
    image sharded ``P('x', None)`` and u ``P(None, 'x', None)``.
    """

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(_SPEC_IM, _SPEC_U),
        out_specs=_SPEC_IM,
        check_vma=False,
    )
    def warp(img_loc, u_loc):
        return _warp_local(img_loc, u_loc, halo, "x")

    return jax.jit(warp)


def make_demons_level_sharded(
    mesh: Mesh,
    sigma_i: float,
    sigma_x: float,
    sigma_diffusion: float,
    sigma_fluid: float,
    kernelwidth: int,
    niter: int,
    halo: int = 2,
    diffeomorphic: bool = False,
    convergence_tol: float = 0.001,
):
    """A full demons LEVEL solve as one explicit shard_map program:
    per-iteration step (halo-exchanged warp/gradient/smooth/compose) inside
    a lax.while_loop whose convergence gate is the reference Logger's
    relative step norm computed with psum reductions over the mesh.

    Signature: ``(u [2,nx,ny], iref, imov) -> (u, iterations)``;
    reproduces ``engine.registration._solve_level_demons`` for one
    refinement within the displacement contract.
    """
    family = "diffeo" if diffeomorphic else "thirions"
    p = dict(sigma_i=sigma_i, sigma_x=sigma_x, sigma_diffusion=sigma_diffusion,
             sigma_fluid=sigma_fluid, kernelwidth=kernelwidth)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(_SPEC_U, _SPEC_IM, _SPEC_IM),
        out_specs=(_SPEC_U, P()),
        check_vma=False,
    )
    def solve(u, iref, imov):
        return _level_local(family, u, iref, imov, niter, halo, p,
                            convergence_tol)

    return jax.jit(solve)


def make_variational_level_sharded(
    mesh: Mesh,
    method: str,
    niter: int,
    halo: int = 2,
    alpha: float = 1.0,
    tau: float = 1.0,
    mu: float = 1.0,
    lam: float = 0.0,
    omega: float = 0.66,
    convergence_tol: float = 0.001,
    reference_stencil: bool = True,
    grid_shape=None,
    dct_precision=lax.Precision.HIGH,
):
    """A full variational LEVEL solve (``method`` in {"diffusion",
    "elastic", "curvature"}) as one explicit shard_map program: derivatives
    once (halo-exchanged warp + gradient), then while_loop iterations of the
    solver stencil with ppermute halos (curvature: distributed DCT via
    all_to_all), the Logger convergence gate via psum norms, and the final
    composition — the reference's ImageRegistrationOpticalFlow level loop
    with every collective explicit.

    Curvature extra kwargs: ``tau`` (uses ``alpha`` as the regularisation
    weight) and ``dct_precision`` (HIGH default, matching the serial
    ``dct_impl="auto"`` resolution; HIGHEST = parity grade); requires ny divisible by the mesh x-axis
    size.

    Signature: ``(u [2,nx,ny], iref, imov) -> (u, iterations)``.
    """
    if method not in ("diffusion", "elastic", "curvature"):
        raise ValueError(method)
    n_static = mesh.shape["x"]
    if method == "curvature" and grid_shape is not None:
        if grid_shape[0] % n_static or grid_shape[1] % n_static:
            raise ValueError("curvature grid dims must divide the mesh x size")
    p = dict(alpha=alpha, tau=tau, mu=mu, lam=lam, omega=omega,
             reference_stencil=reference_stencil, dct_precision=dct_precision)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(_SPEC_U, _SPEC_IM, _SPEC_IM),
        out_specs=(_SPEC_U, P()),
        check_vma=False,
    )
    def solve(u, iref, imov):
        return _level_local(method, u, iref, imov, niter, halo, p,
                            convergence_tol)

    return jax.jit(solve)


def make_fluid_level_sharded(
    mesh: Mesh,
    mu: float,
    lam: float,
    omega: float,
    niter: int,
    halo: int = 2,
    dumax: float = 0.65,
    timestep_skip: float = 65.0,
    regrid_threshold: float = 0.5,
    convergence_tol: float = 0.001,
    reference_stencil: bool = True,
):
    """A full viscous-fluid LEVEL solve as one explicit shard_map program
    (see ``_fluid_level_strip`` for the body; the reference's
    ``ImageRegistrationFluid.cpp:67-142`` with every collective explicit).

    Signature: ``(u [2,nx,ny], iref, imov) -> (u, iterations, regrids)``.
    """
    p = dict(mu=mu, lam=lam, omega=omega, dumax=dumax,
             timestep_skip=timestep_skip, regrid_threshold=regrid_threshold,
             reference_stencil=reference_stencil)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(_SPEC_U, _SPEC_IM, _SPEC_IM),
        out_specs=(_SPEC_U, P(), P()),
        check_vma=False,
    )
    def solve(u, iref, imov):
        return _fluid_level_strip(u, iref, imov, niter, halo, p,
                                  convergence_tol, "x")

    return jax.jit(solve)


# --- sharded pyramid resampling -------------------------------------------

def _downsample2_local(f, axis_name: str):
    """Factor-2 box downsample of ``[..., nxl, ny]`` strips — purely local
    when nxl is even (each strip's patches stay inside it), matching
    ``ops.resample.downsample_image`` for pyramid dims."""
    nxl, ny = f.shape[-2], f.shape[-1]
    shaped = f.reshape(*f.shape[:-2], nxl // 2, 2, ny // 2, 2)
    return shaped.mean(axis=(-3, -1))


def _upsample2_local(f, axis_name: str):
    """Factor-2 origin-aligned bilinear upsample of ``[..., nxl, ny]``
    strips with a 1-row halo (output rows 2i need in-rows i, i ok; rows
    2i+1 need i and i+1 — the +1 may live on the next strip). Matches
    ``ops.resample.upsample_image`` for even global dims."""
    nxl, ny = f.shape[-2], f.shape[-1]
    idx = lax.axis_index(axis_name)
    n = lax.psum(1, axis_name)
    nx_glob = n * nxl

    # x-direction: out[2i] = in[i]; out[2i+1] = (in[i] + in[i+1]) / 2,
    # renormalized at the global last row (only in[i] contributes).
    _top, bot = _halo_exchange_k(f, 1, axis_name)
    nxt = jnp.concatenate([f[..., 1:, :], bot], axis=-2)  # in[i+1]
    gi = lax.broadcasted_iota(jnp.int32, (nxl, 1), 0) + idx * nxl
    last = (gi == nx_glob - 1)
    odd = jnp.where(last, f, (f + nxt) * 0.5)
    up_x = jnp.stack([f, odd], axis=-2).reshape(*f.shape[:-2], 2 * nxl, ny)

    # y-direction (unsharded): same pattern locally.
    nxt_y = jnp.concatenate(
        [up_x[..., :, 1:], jnp.zeros_like(up_x[..., :, :1])], axis=-1
    )
    gj = lax.broadcasted_iota(jnp.int32, (1, ny), 1)
    last_y = (gj == ny - 1)
    odd_y = jnp.where(last_y, up_x, (up_x + nxt_y) * 0.5)
    return jnp.stack([up_x, odd_y], axis=-1).reshape(
        *up_x.shape[:-1], 2 * ny
    )


def make_register_sp(
    mesh: Mesh,
    family: str,
    niter,
    nscales: int = 1,
    nrefine: int = 1,
    halo: int = 2,
    convergence_tol: float = 0.001,
    **params,
):
    """A COMPLETE multi-resolution registration as one explicit shard_map
    program for any of {"thirions", "diffeo", "diffusion", "elastic",
    "curvature", "fluid"}:
    sharded image pyramid, per-level solves with explicit collectives, and
    sharded factor-2 resampling with motion rescale between levels.

    Constraints as in ``make_register_demons_sp`` (dims divisible by
    ``2^nscales * mesh_x``; displacement contract within ``halo``). The
    pyramid motion transport reproduces the reference's full-resolution
    round trip, so it matches the registration driver at any depth.
    ``nrefine`` runs the reference's outer refinement loop per level
    (ImageRegistrationOpticalFlow.cpp:97-151): each refinement re-warps
    the level image by the accumulated motion, solves a fresh estimate
    from zero, and composes it back — ``_level_local`` is exactly one
    refinement, so the loop is a static unroll around it.
    Signature: ``(iref, imov) -> (u [2,nx,ny],
    iterations [(nscales+1) * nrefine])`` — iteration counts ordered
    coarse -> fine, refine-major, matching the serial driver's traces.
    """
    niter = tuple(int(v) for v in niter)
    nrefine = int(nrefine)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(_SPEC_IM, _SPEC_IM),
        out_specs=(_SPEC_U, P()),
        check_vma=False,
    )
    def solve(iref, imov):
        irefs = [iref]
        imovs = [imov]
        for _ in range(nscales):
            irefs.append(_downsample2_local(irefs[-1], "x"))
            imovs.append(_downsample2_local(imovs[-1], "x"))

        iters = []
        u_full = jnp.zeros((2,) + iref.shape, iref.dtype)
        for sc in range(nscales, -1, -1):
            if sc == nscales and sc > 0:
                # Coarsest level starts from zero (the reference skips the
                # motion downsample at s == nscales).
                u = jnp.zeros((2,) + irefs[sc].shape, iref.dtype)
            elif 0 < sc < nscales:
                # The reference's quirk: intermediate levels re-derive their
                # motion by downsampling the running FULL-RES field (which
                # was itself upsampled from the coarser solve) — reproduce
                # the round trip exactly (ImageRegistration.cpp:137-151).
                u = u_full
                for _ in range(sc):
                    u = _downsample2_local(u, "x") * 0.5
            else:  # sc == 0
                u = u_full
            for _refine in range(nrefine):
                u, it = _level_local(
                    family, u, irefs[sc], imovs[sc], niter[sc], halo, params,
                    convergence_tol,
                )
                iters.append(it)
            if sc > 0:
                for _ in range(sc):
                    u = _upsample2_local(u, "x") * 2.0
                u_full = u
            else:
                u_full = u
        return u_full, jnp.stack(iters)

    return jax.jit(solve)


def make_register_demons_sp(
    mesh: Mesh,
    sigma_i: float,
    sigma_x: float,
    sigma_diffusion: float,
    sigma_fluid: float,
    kernelwidth: int,
    niter,
    nscales: int = 1,
    halo: int = 2,
    convergence_tol: float = 0.001,
):
    """Back-compat wrapper: the complete explicit-SP Thirion demons
    registration (see ``make_register_sp``)."""
    return make_register_sp(
        mesh, "thirions", niter, nscales=nscales, halo=halo,
        convergence_tol=convergence_tol,
        sigma_i=sigma_i, sigma_x=sigma_x, sigma_diffusion=sigma_diffusion,
        sigma_fluid=sigma_fluid, kernelwidth=kernelwidth,
    )


def make_diffusion_sweeps_sharded(mesh: Mesh, alpha: float, niter: int):
    """Build a jitted function running ``niter`` Horn-Schunck sweeps with
    explicit halo exchange; inputs/outputs sharded in x-strips.

    Signature: ``(u [2, nx, ny], grad_i [2, nx, ny], it [nx, ny]) -> u``.
    The image x-size must be divisible by the mesh's "x" axis.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(_SPEC_U, _SPEC_U, _SPEC_IM),
        out_specs=_SPEC_U,
        check_vma=False,
    )
    def sweeps(u, grad_i, it_img):
        _, _, den = _diffusion_consts_strip(grad_i, it_img, alpha)

        def body(_, u):
            return _diffusion_step_strip(u, grad_i, it_img, den, "x")

        return lax.fori_loop(0, niter, body, u)

    return jax.jit(sweeps)
