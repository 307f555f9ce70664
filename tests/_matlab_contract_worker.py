"""Subprocess worker: replay the EXACT calllib sequences that
matlab/OpticalFlow2d.m emits, via ctypes against libopticalflow2d.so.

No Octave/MATLAB exists in this image, so the .m glue cannot execute; this
worker pins its contract instead: the same five
commands, the same argument marshaling (int32 niter, double regparams,
column-major = x-fastest flattening, [dimx dimy 2] motion readback), and
the same header prototypes the .m writes for loadlibrary. Run by
tests/test_native_capi.py::test_matlab_glue_contract.
"""

import ctypes
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    libpath = os.environ["OF2D_LIB"]
    lib = ctypes.CDLL(libpath)

    # --- 1. the .m file's loadlibrary header: every prototype it declares
    # must resolve in the library (so the glue's loadlibrary succeeds).
    msrc = open(os.path.join(REPO, "matlab", "OpticalFlow2d.m")).read()
    protos = re.findall(r"(of2d_\w+)\(", msrc)
    assert protos, "no prototypes found in OpticalFlow2d.m"
    for name in sorted(set(protos)):
        assert hasattr(lib, name), f"{name} declared in .m but not exported"

    # ctypes signatures = the header block OpticalFlow2d.m writes (lines
    # 27-35): int of2d_init(int, int, const int*, int, int, const double*,
    # int, int, int) etc.
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int)
    lib.of2d_init.argtypes = [ctypes.c_int, ctypes.c_int, c_ip, ctypes.c_int,
                              ctypes.c_int, c_dp, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.of2d_register_images.argtypes = [c_dp, c_dp]
    lib.of2d_get_motion.argtypes = [c_dp]
    lib.of2d_warp.argtypes = [c_dp, c_dp]
    lib.of2d_last_error.restype = ctypes.c_char_p

    def check(rc):
        assert rc == 0, lib.of2d_last_error().decode()

    dimx, dimy = 48, 40
    n = dimx * dimy
    # Smooth synthetic pair (same construction as conftest.make_pair).
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from conftest import make_pair
    iref, imov = make_pair(dimx, dimy, shift=(1.5, -0.8))

    # --- 2. init: niter(1:nscales+1) as int32, regparams(1:nparams) as
    # double (OpticalFlow2d.m lines 44-57).
    nscales, nrefine, verbose = 1, 1, 0
    reg = 0  # diffusion
    niter = (ctypes.c_int * (nscales + 1))(20, 10)
    regparams = (ctypes.c_double * 1)(0.5)
    check(lib.of2d_init(dimx, dimy, niter, nscales, reg, regparams, 1,
                        nrefine, verbose))

    # --- 3. register: MATLAB's (:) column-major flatten == the C API's
    # x-fastest layout (OpticalFlow2d.m lines 58-62).
    iref64 = np.asarray(iref, np.float64)
    imov64 = np.asarray(imov, np.float64)
    fr = np.asfortranarray(iref64).ravel(order="F")
    fm = np.asfortranarray(imov64).ravel(order="F")
    check(lib.of2d_register_images(fr.ctypes.data_as(c_dp),
                                   fm.ctypes.data_as(c_dp)))

    # --- 4. motion readback: 2n buffer -> reshape [dimx dimy 2]
    # column-major (OpticalFlow2d.m lines 63-70).
    mbuf = np.zeros(2 * n, np.float64)
    check(lib.of2d_get_motion(mbuf.ctypes.data_as(c_dp)))
    motion_m = mbuf.reshape((dimx, dimy, 2), order="F")

    # --- 5. warp (OpticalFlow2d.m lines 71-77).
    wbuf = np.zeros(n, np.float64)
    check(lib.of2d_warp(fm.ctypes.data_as(c_dp),
                        wbuf.ctypes.data_as(c_dp)))
    warped_m = wbuf.reshape((dimx, dimy), order="F")

    # --- 6. close (OpticalFlow2d.m lines 78-81).
    check(lib.of2d_close())

    # --- Reference: the same registration through the Python session API
    # (the library embeds this very interpreter, so results must agree to
    # float64<->float32 round-trip tolerance).
    from opticalflow2d_tpu import OpticalFlow2d
    sess = OpticalFlow2d((dimx, dimy), [20, 10], nscales, reg, [0.5],
                         nrefine=nrefine)
    sess.register(iref, imov)
    motion_p = sess.get_motion()          # [nx, ny, 2]
    warped_p = sess.warp(imov)

    np.testing.assert_allclose(motion_m, motion_p, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(warped_m, warped_p, rtol=1e-6, atol=1e-7)
    assert np.isfinite(motion_m).all()
    # The registration must actually do something.
    assert np.abs(motion_m).max() > 0.1
    print("PASSED matlab-glue contract")


if __name__ == "__main__":
    main()
