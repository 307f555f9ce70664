"""Python side of the native C API (see native/of2d_capi.cpp).

Array layout at the C boundary mirrors the reference MEX wrapper
(``WrapperOpticalFlow2d.cpp:86-137``): double arrays, x-fastest
(``flat[i + j*dimx]``), motion as the x-plane followed by the y-plane
(``src/Motion.cpp:23-39``).
"""

from __future__ import annotations

import numpy as np

_session = None
_dims = None


def _from_flat(buf, dimx: int, dimy: int) -> np.ndarray:
    a = np.frombuffer(buf, dtype=np.float64, count=dimx * dimy)
    return a.reshape(dimy, dimx).T.astype(np.float32)  # -> [nx, ny]


def _to_flat(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64).T).tobytes()


def init(dimx, dimy, niter, nscales, reg, regparams, nrefine, verbose):
    global _session, _dims
    from opticalflow2d_tpu import OpticalFlow2d
    from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    _dims = (int(dimx), int(dimy))
    _session = OpticalFlow2d(
        _dims, niter=list(niter), nscales=int(nscales),
        regularisation=int(reg), regparams=list(regparams),
        nrefine=int(nrefine), verbose=bool(verbose),
    )
    return 0


def register_images(iref_buf, imov_buf):
    nx, ny = _dims
    iref = _from_flat(iref_buf, nx, ny)
    imov = _from_flat(imov_buf, nx, ny)
    _session.register(iref, imov)
    return 0


def get_motion() -> bytes:
    u = _session.get_motion()  # [nx, ny, 2]
    return _to_flat(u[..., 0]) + _to_flat(u[..., 1])


def warp(img_buf) -> bytes:
    nx, ny = _dims
    img = _from_flat(img_buf, nx, ny)
    return _to_flat(_session.warp(img))


def close():
    global _session
    if _session is not None:
        _session.close()
        _session = None
    return 0
