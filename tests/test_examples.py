"""Smoke tests for the examples/ scripts (an example with no test can rot
silently). Run the real main() at reduced sizes."""

import contextlib
import io

import numpy as np


def test_sequence_tracking_example_runs(monkeypatch):
    """examples/sequence_tracking.py end-to-end at a reduced size: warm
    starts must run and produce positive SSD reductions on every frame."""
    import examples.sequence_tracking as st

    orig = st.make_sequence
    monkeypatch.setattr(st, "make_sequence",
                        lambda *a, **k: orig(n=48, frames=3))
    # The suite's workers share no compile cache.
    monkeypatch.setattr(st, "enable_compile_cache", lambda: None)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st.main()
    out = buf.getvalue()
    lines = [ln for ln in out.splitlines() if "|" in ln and "frame" not in ln]
    assert len(lines) == 2  # frames-1 rows at frames=3
    for ln in lines:
        cold, warm = (float(tok) for tok in ln.split("|")[1:])
        assert np.isfinite(cold) and np.isfinite(warm)
        assert warm > 0.1, f"warm-start SSD reduction too small: {ln}"
