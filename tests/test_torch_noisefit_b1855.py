"""The committed b1855_noise snapshot's ``Fitter.auto`` noise fit (4005
TOAs, 14 noise parameters freed) against its stored reference outputs, at
the noise-fit bars of ``tests/test_torch_noisefit.py``: each noise round's
L-BFGS-B iterations and converged flag exact and lnlike 1e-9 rel, noise
values within 1e-2 of their uncertainties, timing values within 1e-2
sigma and uncertainties 1e-4 rel.  A file of its own: the fit takes
minutes on the CPU, and a test file holds one worker.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


def test_committed_b1855_noise_fit_matches_reference():
    """The 4005-TOA noise fit (14 parameters, Sigma ~536 x 536)."""
    from pint_torch.bridge import NOISE_PATH

    standin.snapshot_noise_bars(NOISE_PATH, "DownhillGLSFitter")
