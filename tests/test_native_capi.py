"""Native C API: build the shared library + C harness and run it in a
subprocess (CPU backend)."""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_SH = os.path.join(REPO, "native", "build.sh")
TEST_BIN = os.path.join(REPO, "native", "build", "of2d_test")


@pytest.fixture(scope="module")
def native_binary():
    if not os.path.exists(TEST_BIN):
        try:
            subprocess.run([BUILD_SH], check=True, capture_output=True, timeout=300)
        except Exception as e:  # pragma: no cover
            pytest.skip(f"native build failed: {e}")
    return TEST_BIN


def test_c_api_end_to_end(native_binary):
    env = dict(
        os.environ,
        OF2D_PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
    )
    proc = subprocess.run(
        [native_binary], env=env, capture_output=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr.decode()[-1500:]
    assert b"PASSED" in proc.stdout


def test_matlab_glue_contract(native_binary):
    """Replay the exact calllib sequences matlab/OpticalFlow2d.m emits via
    ctypes (no Octave in this image): the header prototypes it writes for
    loadlibrary, the five commands, the int32/double marshaling, the
    column-major flattening, and the [dimx dimy 2] motion readback — and
    pin the results against the Python session API."""
    lib = os.path.join(REPO, "native", "build", "libopticalflow2d.so")
    assert os.path.exists(lib), "library missing after native build"
    env = dict(
        os.environ,
        OF2D_LIB=lib,
        OF2D_PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
    )
    proc = subprocess.run(
        ["python", os.path.join(REPO, "tests", "_matlab_contract_worker.py")],
        env=env, capture_output=True, timeout=300,
    )
    assert proc.returncode == 0, (proc.stderr.decode()[-2000:]
                                  + proc.stdout.decode()[-500:])
    assert b"PASSED matlab-glue contract" in proc.stdout
