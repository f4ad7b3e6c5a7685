"""K8's MIXED mode (``pint_torch/kernels/photon_lnlike.py``, through its
plain twin): any mixture of the closed-form primitives in one pass per
photon, against the reference's templates on the CPU.

* each primitive alone, and the mixture of one of each
  (``_torch_standin.PHOTON_MIXED``), at seeded phases with the edges
  (0, the location, half a cycle off, 1 - 2^-53): the density within
  1e-12 of the reference's ``jnp`` template (the branch its MCMC traces)
  scaled by the sum of |terms| (bg and each norm x pdf); the log-sum
  mode within 1e-12 of its sum of |log terms|;
* the table holds the reference's numpy constants; a template with a
  primitive outside the set refuses the table;
* ``MCMCFitterAnalyticTemplate`` routes the mixed template to K8 MIXED
  (the repr says so) and its ``lnposterior_batch`` on the small photon
  stand-in is within 1e-12 rel of the reference's live and of the stored
  ``ref/photon_mixed/lnposterior`` (-inf where theirs); the stored
  density at the stored phases within 1e-12 of the sum of |terms|; the
  stored seeded chain replays: each accept decision the reference's
  unless the port's margin is within 2e-12 of the lnposterior's size,
  the walkers bitwise up to the first differing decision and, with none
  differing, the whole chain and its maximum (``LCSkewGaussian`` keeping
  the torch branches: ``test_torch_photon.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

S = standin.SMALL_PHOTON_SETTINGS
P = "ref/photon_mixed/"


def _prims(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.templates.lcprimitives")


def _template(pkg, entries):
    import importlib

    mod = importlib.import_module(f"{pkg}.templates")
    prims = _prims(pkg)
    return mod.LCTemplate([getattr(prims, c)(list(p), **kw)
                           for c, p, _, kw in entries],
                          [n for _, _, n, _ in entries])


def _phases(entries):
    rng = np.random.default_rng(20261101)
    locs = [p[-1] for _, p, _, _ in entries]
    edge = [0.0, 1.0 - 2.0 ** -53, 0.5] + locs \
        + [(x + 0.5) % 1.0 for x in locs]
    return np.concatenate([rng.random(2000), np.array(edge)])


def _scale(tpl, phi):
    """bg and each norm x pdf's magnitudes, summed (the reference's numpy
    branch)."""
    norms = tpl.norms()
    out = np.abs(1.0 - norms.sum()) * np.ones_like(phi)
    for n, prim in zip(norms, tpl.primitives):
        out = out + np.abs(n * np.asarray(prim(phi)))
    return out


CASES = [(e,) for e in standin.PHOTON_MIXED] + [standin.PHOTON_MIXED]


@pytest.mark.parametrize("entries", CASES,
                         ids=[c[0][0] if len(c) == 1 else "mixture"
                              for c in CASES])
def test_mixed_twin_is_the_references_template(entries):
    import jax.numpy as jnp

    from pint_torch.kernels.photon_lnlike import (MIXED, mixed_table,
                                                  photon_lnlike)

    rt, pt = _template("pint_tpu", entries), _template("pint_torch", entries)
    phi = _phases(entries)
    want = np.asarray(rt(jnp.asarray(phi)))
    table = torch.from_numpy(mixed_table(pt))
    frac = torch.from_numpy(np.stack([phi, phi - 3.0]))
    got = photon_lnlike(frac, None, table, MIXED, density=True).numpy()
    scale = _scale(rt, phi)
    for row in got:
        assert np.all(np.abs(row - want) <= 1e-12 * scale)
    w = np.random.default_rng(3).random(phi.shape[0])
    lw = w * want + (1.0 - w)
    terms = np.log(np.maximum(lw, 1e-300))
    got_l = photon_lnlike(frac, torch.from_numpy(w), table, MIXED).numpy()
    assert np.all(np.abs(got_l - terms.sum()) <= 1e-12 * np.abs(terms).sum())


def test_mixed_table_constants_are_numpys():
    import math

    from scipy.special import gammaln, i0e

    from pint_torch.kernels.photon_lnlike import MIXED_CODES, REC, mixed_table

    pt = _template("pint_torch", standin.PHOTON_MIXED)
    tab = mixed_table(pt)
    norms = pt.norms()
    assert tab.shape == (1 + REC * len(standin.PHOTON_MIXED),)
    assert tab[0] == 1.0 - norms.sum()
    recs = tab[1:].reshape(-1, REC)
    for (c, p, _, kw), r, n in zip(standin.PHOTON_MIXED, recs, norms):
        assert r[0] == MIXED_CODES[c] and r[4] == n
        if c == "LCGaussian":
            assert r[5] == p[0] * np.sqrt(2 * np.pi)
        if c == "LCGaussian2":
            assert r[7] == math.sqrt(2.0 / np.pi) / (p[0] + p[1])
        if c == "LCLorentzian":
            assert r[5] == np.sinh(2 * np.pi * p[0])
        if c == "LCVonMises":
            k = 1.0 / (2 * np.pi * p[0]) ** 2
            assert r[5] == k and r[6] == i0e(k)
        if c == "LCKing":
            assert r[5] == p[0] * np.sqrt(2 * np.pi * p[1]) * np.exp(
                gammaln(p[1] - 0.5) - gammaln(p[1]))
        if c == "LCHarmonic":
            assert r[5] == 2 * np.pi * kw["order"]
    skew = _template("pint_torch", [("LCSkewGaussian", [0.03, 0.5, 2.0],
                                     0.3, {})])
    with pytest.raises(ValueError, match="closed-form"):
        mixed_table(skew)


@pytest.fixture(scope="module")
def small():
    from pint_torch.bridge import PHOTON_SMALL_PATH, load_snapshot, \
        read_snapshot

    truth, toas, w = standin.make_photon_standin(S)
    m2, info = standin.photon_start(truth, S)
    m, b = load_snapshot(PHOTON_SMALL_PATH, device="cpu")
    meta, ref = read_snapshot(PHOTON_SMALL_PATH)
    return dict(toas=toas, w=w, m2=m2, info=info, m=m, b=b, ref=ref,
                R=meta["reference"])


def _fitter(small, pkg, nwalkers=16):
    import importlib

    ef = importlib.import_module(f"{pkg}.event_fitter")
    sam = importlib.import_module(f"{pkg}.sampler")
    import pint_tpu.templates as RT

    import pint_torch.templates as PT

    port = pkg == "pint_torch"
    tpl = standin.photon_mixed_template(
        PT if port else RT, small["R"]["photon"]["fftfit"][0])
    sampler = sam.EnsembleSampler(nwalkers,
                                  seed=standin.PHOTON_SEEDS["sampler"])
    if port:
        return ef.MCMCFitterAnalyticTemplate(small["b"], small["m"], tpl,
                                             prior_info=small["info"],
                                             sampler=sampler)
    return ef.MCMCFitterAnalyticTemplate(small["toas"], small["m2"], tpl,
                                         weights=small["w"],
                                         prior_info=small["info"],
                                         sampler=sampler)


def test_mixed_lnposterior_batch_matches_reference(small):
    pts = small["ref"]["ref/photon/points"]
    port, ref = _fitter(small, "pint_torch"), _fitter(small, "pint_tpu")
    assert "K8 photon_lnlike MIXED" in repr(port)
    got, want = port.lnposterior_batch(pts), ref.lnposterior_batch(pts)
    stored = small["ref"][P + "lnposterior"]
    fin = np.isfinite(want)
    assert (~fin).sum() == standin.PHOTON_OUTSIDE
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.array_equal(np.isneginf(stored), np.isneginf(want))
    for w in (want, stored):
        assert (np.abs(got[fin] - w[fin]) <= 1e-12 * np.abs(w[fin])).all()
    phases = small["ref"]["ref/photon/phases"]
    dens = port._template_density(phases)
    scale = _scale(_template("pint_tpu", standin.PHOTON_MIXED), phases)
    assert np.all(np.abs(dens - small["ref"][P + "density"]) <= 1e-12
                  * scale)


def test_stored_mixed_chain_replays_at_the_chain_bars(small):
    R = small["R"]["photon_mixed"]
    steps = R["steps"]
    port = _fitter(small, "pint_torch", S["nwalkers"])
    pos = small["ref"]["ref/photon/analytic/pos"].copy()
    port.sampler.decision_log = []
    port.fit_toas(maxiter=steps, pos=pos.copy())
    want = small["ref"][P + "walker_chain"].transpose(2, 0, 1)
    acc_ref = small["ref"][P + "accepted"]
    half, upto = S["nwalkers"] // 2, steps
    for t in range(steps):
        for h, sl in enumerate((slice(0, half),
                                slice(half, S["nwalkers"]))):
            marg, lp = port.sampler.decision_log[2 * t + h]
            differ = (marg > 0) != acc_ref[t, sl]
            assert not (differ & ~(np.abs(marg) <= 2e-12 * np.abs(lp))).any()
            if differ.any() and upto == steps:
                upto = t
    got = port.sampler.get_chain()
    assert np.array_equal(got[:upto], want[:upto])
    if upto < steps:
        return
    assert np.array_equal(got, want)
    assert port.sampler.naccepted == R["naccepted"]
    assert np.array_equal(port.maxpost_fitvals,
                          small["ref"][P + "maxpost_fitvals"])
