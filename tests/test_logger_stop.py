"""The reference Logger's stop rule (src/Logger.cpp:32-58) in every family's
level loop: stop after the first iteration ``it > 1`` whose relative step
error is below the tolerance, or at the niter cap, with the error trace
zero past the stop."""

import numpy as np
import pytest

from conftest import make_pair
from opticalflow2d_tpu import Method, RegConfig, register

FAMILIES = [
    (Method.DIFFUSION, dict(alpha=0.5)),
    (Method.CURVATURE, dict(alpha=0.1, tau=1.0)),
    (Method.ELASTIC, dict(mu=0.5, lam=0.0)),
    (Method.THIRIONS_DEMONS, {}),
    (Method.DIFFEOMORPHIC_DEMONS, {}),
    (Method.FLUID, dict(mu=0.25, lam=0.0)),
]
IDS = [m.name for m, _ in FAMILIES]
NITER = 16


def _run(method, kw, tol, niter=NITER):
    iref, imov = make_pair(40, 36, shift=(1.4, -0.9))
    cfg = RegConfig(method=method, niter=(niter,), nscales=0,
                    convergence_tol=tol, **kw)
    res = register(iref, imov, cfg)
    return res, np.asarray(res.traces[0].errors), int(res.traces[0].iterations)


@pytest.mark.parametrize("method,kw", FAMILIES, ids=IDS)
def test_logger_runs_to_niter_cap(method, kw):
    """With a tolerance no error can undercut, every family runs exactly
    niter iterations and logs an error for each after the first."""
    _, errs, iters = _run(method, kw, tol=0.0)
    assert iters == NITER
    assert errs.shape == (NITER,)
    assert errs[0] == 0.0  # the first step's previous estimate is zero
    assert np.all(errs[1:] > 0)


@pytest.mark.parametrize("method,kw", FAMILIES, ids=IDS)
def test_logger_stops_mid_run(method, kw):
    """A tolerance between the logged errors stops the loop exactly where
    the rule says, with the same field as a run capped at that count."""
    full, errs, _ = _run(method, kw, tol=0.0)
    tol = float(np.median(errs[2:])) * 1.0001
    stop = next(it for it in range(2, NITER) if errs[it] < tol)
    res, got_errs, iters = _run(method, kw, tol=tol)
    assert iters == stop + 1
    assert 2 < iters < NITER
    np.testing.assert_allclose(got_errs[:iters], errs[:iters], rtol=1e-5,
                               atol=1e-7)
    assert np.all(got_errs[iters:] == 0.0)
    capped, _, _ = _run(method, kw, tol=0.0, niter=iters)
    np.testing.assert_allclose(np.asarray(res.motion),
                               np.asarray(capped.motion), rtol=1e-5,
                               atol=1e-6)
