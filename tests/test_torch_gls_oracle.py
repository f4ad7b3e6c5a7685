"""The mpmath dense oracle of ``tests/test_gls_oracle.py`` held against
the port: its Woodbury chi2 (``Residuals.calc_chi2``), its log-likelihood
(``Residuals.lnlikelihood``), the noise likelihood
(``build_noise_lnlikelihood``) and the wideband joint chi2
(``WidebandTOAResiduals.calc_chi2``), each to 1e-9 rel of the dense
covariance's r^T C^-1 r and logdet C evaluated at 70 digits.

The oracle's data set is rebuilt from in-repo par text -- the NGC6440E
stand-in's (``bench.py``'s ``FALLBACK_PAR``) plus the oracle's
``NOISE_LINES`` -- with the same simulated TOAs, so this runs where the
reference's data files are absent; the port reads the reference
package's state through a snapshot and the oracle is given the port's own
residuals.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

mp = pytest.importorskip("mpmath")

import _torch_standin as standin  # noqa: E402
from test_gls_oracle import (NOISE_LINES, _dense_chi2_logdet,  # noqa: E402
                             _oracle_cov)

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def dataset():
    """(reference model, reference TOAs with wideband DMs, port model,
    port batch, the oracle's C): the oracle test's data set on in-repo par
    text."""
    from pint_tpu.io.par import parse_parfile
    from pint_tpu.models import get_model
    from pint_tpu.simulation import make_fake_toas_fromMJDs

    from pint_torch.bridge import load_snapshot

    text = standin.ngc_par(standin.NGC_SETTINGS)
    m = get_model(parse_parfile(text + "\n" + "\n".join(NOISE_LINES) + "\n"))
    epochs = np.linspace(53005.0, 54795.0, 20)
    mjds = (epochs[:, None] + np.arange(3)[None, :] * 0.4 / 86400.0).ravel()
    t = make_fake_toas_fromMJDs(mjds, m, error_us=2.0, add_noise=True,
                                add_correlated_noise=True,
                                rng=np.random.default_rng(31))
    rng = np.random.default_rng(5)
    dme = np.full(len(t), 1e-3)
    t.update_dms(float(m.DM.value) + rng.standard_normal(len(t)) * dme, dme)
    pm, pb = load_snapshot(standin.export_state(m, t), device="cpu")
    return m, t, pm, pb, _oracle_cov(m, t)


def _oracle(C, r, n):
    chi2, logdet = _dense_chi2_logdet(C, r)
    with mp.workdps(70):
        lnl = -(chi2 / 2 + logdet / 2 + n * mp.log(2 * mp.pi) / 2)
    return float(chi2), float(lnl)


def test_woodbury_chi2_matches_dense_oracle(dataset):
    from pint_torch.residuals import Residuals

    _, _, m, b, C = dataset
    res = Residuals(b, m)
    chi2_o, _ = _oracle(C, res.time_resids.numpy(), b.ntoas)
    assert abs(res.calc_chi2() / chi2_o - 1) < 1e-9


def test_lnlikelihood_matches_dense_oracle(dataset):
    from pint_torch.residuals import Residuals

    _, _, m, b, C = dataset
    res = Residuals(b, m)
    _, lnl_o = _oracle(C, res.time_resids.numpy(), b.ntoas)
    assert abs(res.lnlikelihood() / lnl_o - 1) < 1e-9


def test_noisefit_lnlike_matches_dense_oracle(dataset):
    """The noise likelihood (the autodiff path) at the current values,
    with the white noise and ECORR free."""
    import torch

    from pint_torch.noisefit import build_noise_lnlikelihood
    from pint_torch.residuals import Residuals

    _, _, m, b, C = dataset
    m2 = m.copy()
    for p in ("EFAC1", "EQUAD1", "ECORR1"):
        m2[p].frozen = False
    r = Residuals(b, m2).time_resids
    lnl, x0, names = build_noise_lnlikelihood(m2, b)
    assert {"EFAC1", "EQUAD1", "ECORR1"} <= set(names)
    _, lnl_o = _oracle(C, r.numpy(), b.ntoas)
    assert abs(float(lnl(torch.tensor(x0), r)) / lnl_o - 1) < 1e-9


def test_wideband_combined_chi2_matches_oracle(dataset):
    """The joint chi2 = the TOA GLS chi2 (dense oracle) + the diagonal DM
    chi2 of the measured DMs about the model's."""
    from pint_torch.wideband import WidebandTOAResiduals

    ref_model, toas, m, b, C = dataset
    wr = WidebandTOAResiduals(b, m)
    chi2_toa, _ = _oracle(C, wr.toa.time_resids.numpy(), b.ntoas)
    dms, dme = np.asarray(toas.get_dms()), np.asarray(toas.get_dm_errors())
    chi2_dm = float(np.sum(((dms - float(ref_model.DM.value)) / dme) ** 2))
    total = chi2_toa + chi2_dm
    assert abs(wr.calc_chi2() / total - 1) < 1e-9
