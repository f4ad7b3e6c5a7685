"""The batched lnposterior's gradient against the reference's on the
white-noise stand-ins with orbital waves and the solar wind (K6, K7): the
checks of ``test_torch_posterior_grad.py``, split so that each file stays
short."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import test_torch_posterior_grad as pg  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.mark.parametrize("which", ["small_dd_fbx", "small_pta"])
def test_batched_posterior_gradient_matches_reference(which):
    pg.check_posterior_gradient(which)
