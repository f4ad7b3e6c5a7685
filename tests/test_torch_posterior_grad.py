"""The batched lnposterior's gradient, on the CPU.

``BatchedPosterior.fn`` (``pint_torch/bayesian.py``) under
``torch.autograd.grad`` reaches every free parameter through the hand
kernels' ``backward`` (K1, K2, K6, K7 here; their twins behind them on
CPU tensors) and is held against ``jax.grad`` of the reference's
``batched_posterior().fn`` on white-noise stand-ins built live by the
reference package (the small ones with their red noise and ECORR off, as
small_wb_white is): in box units ``g_j (pmax_j - pmin_j)`` within 5e-7 x
max(1, chi2) (the lnposterior bar carried to the gradient) plus 1e-7 of the
point's largest box-unit gradient (see :data:`GRAD_REL`).  The prior box is
``set_priors_basic``'s about the committed snapshot's post-fit
uncertainties.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64


#: the stand-ins of the posterior gradient: (settings, full width, the
#: committed snapshot whose post-fit uncertainties set the prior box)
POSTERIOR = {
    "ngc_phoff": (standin.NGC_PHOFF_SETTINGS, True, "NGC_PHOFF_PATH"),
    "small_bt": (standin.SMALL_BT_SETTINGS, False, "BT_SMALL_PATH"),
    "small_dds": (standin.SMALL_DDS_SETTINGS, False, "DDS_SMALL_PATH"),
    "small_ddh": (standin.SMALL_DDH_SETTINGS, False, "DDH_SMALL_PATH"),
    "small_dd_fbx": (standin.SMALL_DD_FBX_SETTINGS, False,
                     "DD_FBX_SMALL_PATH"),
    "small_pta": (standin.SMALL_PTA_SETTINGS, False, "PTA_SMALL_PATH"),
    "small_wb_white": (standin.SMALL_WB_WHITE_SETTINGS, False,
                       "WB_WHITE_SMALL_PATH"),
}
#: the gradient in box units against the reference's: per max(1, chi2),
#: plus per the point's largest box-unit gradient (below)
GRAD_BAR = 5e-7
#: near the minimum a box-unit gradient is many times chi2, a sum over
#: the TOAs that cancels, and the two packages' derivatives of their
#: residuals (equal to rounding, ~1e-14 s) part at up to ~5e-8 of the
#: point's largest; each package's own derivative is as far from its
#: central difference (measured on small_dds: 1.7e-3 on 6791.34, chi2 71)
GRAD_REL = 1e-7


#: the stand-ins held here; small_dd_fbx and small_pta in
#: test_torch_posterior_grad_more.py, small_wb_white in
#: test_torch_posterior_grad_wb.py
HERE_HELD = ("ngc_phoff", "small_bt", "small_dds", "small_ddh")


@pytest.mark.parametrize("which", HERE_HELD)
def test_batched_posterior_gradient_matches_reference(which):
    check_posterior_gradient(which)


def check_posterior_gradient(which):
    """``torch.autograd.grad`` of ``BatchedPosterior.fn`` at 6 seeded
    points in the prior box (``set_priors_basic``'s about a reference WLS
    fit) against ``jax.grad`` of the reference's ``batched_posterior().fn``:
    ``g_j (pmax_j - pmin_j)`` within 5e-7 x max(1, chi2) plus 1e-7 of the
    point's largest of the reference's, and every free parameter's
    gradient nonzero somewhere."""
    from pint_torch import bridge
    from pint_torch.bayesian import BayesianTiming as PBT
    from pint_tpu.bayesian import BayesianTiming as RBT

    settings, full, path = POSTERIOR[which]
    model, toas = standin.make_standin(dict(settings, rn_modes=0,
                                            ecorr=False), full=full)
    # small_pta's PLSWNoise: its solar-wind delay stays, its basis goes
    for name, comp in list(model.components.items()):
        if getattr(comp, "introduces_correlated_errors", False):
            model.remove_component(name)
    m, b = bridge.load_snapshot(standin.export_state(model, toas),
                                device="cpu")
    meta, ref = bridge.read_snapshot(getattr(bridge, path))
    unc = dict(zip(meta["reference"]["postfit_params"],
                   ref["ref/postfit_uncertainties"]))
    names = list(model.free_params)
    info = standin.bayes_prior_info(model, toas, names,
                                    [float(unc[p]) for p in names])
    pmin = np.array([info[p]["pmin"] for p in names])
    pmax = np.array([info[p]["pmax"] for p in names])
    values = np.array([float(getattr(model, p).value) for p in names])
    pts = standin.bayes_points(values, pmin, pmax, 4)[0][:6]
    rbp = RBT(model, toas, prior_info=info).batched_posterior()
    pbt = PBT(m, b, prior_info=info)
    bp = pbt.batched_posterior()
    assert bp.param_labels == tuple(names)
    want = np.asarray(jax.grad(lambda x: jnp.sum(rbp.fn(x)))(
        jnp.asarray(pts)))
    x = torch.tensor(pts, dtype=F64, requires_grad=True)
    lp = bp.fn(x)
    (got,) = torch.autograd.grad(lp.sum(), x)
    got = got.numpy()
    lnpr = np.array([pbt.lnprior(p) for p in pts])
    chi2 = -2.0 * (lp.detach().numpy() - lnpr + pbt.lognorm)
    width = pmax - pmin
    err = np.abs(got - want) * width
    bar = GRAD_BAR * np.maximum(1.0, chi2)[:, None] \
        + GRAD_REL * np.abs(want * width).max(axis=1, keepdims=True)
    assert np.all(err <= bar), dict(zip(names, (err / bar).max(axis=0)))
    assert np.all(np.abs(got).max(axis=0) > 0), names
