"""The port's pulse-profile templates, event statistics and FFTFIT
(``pint_torch/templates/``, ``pint_torch/eventstats.py``,
``pint_torch/fftfit.py``) against the JAX package's on the CPU.

Every primitive's torch ``_pdf`` against the reference's ``jnp`` one on
seeded phases (1e-13 of the largest value; bitwise for the Gaussian shapes
with XLA's exponential swapped in for torch's); the norms, the
``LCTemplate`` mixture on numpy phases (bitwise) and on tensors (1e-13),
its random draws from the same generator (bitwise), the gaussian template
file's round trip, ``LCFitter``'s fits (host copies: bitwise) and
``check_gradient`` (``torch.func.jacfwd`` against ``jax.jacfwd``, 1e-10
rel); every ``eventstats`` function (bitwise); ``fftfit_full`` (the shift
within 1e-12 cycles, the scale 1e-12 rel), on the host device asked for.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

pytestmark = pytest.mark.torch

PHASES = np.random.default_rng(20261017).random(257)
#: (class name, parameters, keyword arguments) of each primitive checked
PRIMS = [
    ("LCGaussian", [0.03, 0.4], {}),
    ("LCGaussian", [0.005, 0.999], {}),
    ("LCGaussian2", [0.02, 0.035, 0.6], {}),
    ("LCLorentzian", [0.03, 0.2], {}),
    ("LCLorentzian2", [0.02, 0.04, 0.7], {}),
    ("LCVonMises", [0.05, 0.3], {}),
    ("LCTopHat", [0.1, 0.5], {}),
    ("LCKing", [0.03, 5.0, 0.5], {}),
    ("LCHarmonic", [0.1], {"order": 3}),
    ("LCSkewGaussian", [0.03, 1.5, 0.4], {}),
    ("LCEmpiricalFourier", None, {"phases": PHASES[:40], "nharm": 6}),
    ("LCKernelDensity", None, {"phases": PHASES[:40]}),
]


def _prim(mod, name, p, kw):
    cls = getattr(mod, name)
    return cls(p, **kw) if p is not None else cls(**kw)


def _both(name, p, kw):
    from pint_torch.templates import lcprimitives as P
    from pint_tpu.templates import lcprimitives as R

    return _prim(P, name, p, kw), _prim(R, name, p, kw)


def _xla(fn):
    def f(x):
        return torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))
    return f


@pytest.mark.parametrize("name,p,kw", PRIMS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(PRIMS)])
def test_primitive_torch_pdf_matches_reference_jnp(name, p, kw):
    """The torch branch on a float64 tensor of phases against the
    reference's jnp branch: 1e-13 of the largest value; the numpy branches
    (copies) bitwise."""
    port, ref = _both(name, p, kw)
    got = port(torch.tensor(PHASES, dtype=torch.float64))
    assert got.dtype == torch.float64
    want = np.asarray(ref(jnp.asarray(PHASES)))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-13 * scale
    assert np.array_equal(np.asarray(port(PHASES)), np.asarray(ref(PHASES)))


@pytest.mark.parametrize("name,p", [("LCGaussian", [0.03, 0.4]),
                                    ("LCGaussian", [0.005, 0.999]),
                                    ("LCGaussian2", [0.02, 0.035, 0.6])])
def test_gaussian_pdfs_bitwise_with_xlas_exp(name, p, monkeypatch):
    """With XLA's exponential in place of torch's (SLEEF's on this CPU),
    the Gaussian shapes' torch branches are the reference's jnp ones
    bitwise: the same operations in the same order."""
    port, ref = _both(name, p, {})
    want = np.asarray(ref(jnp.asarray(PHASES)))
    monkeypatch.setattr(torch, "exp", _xla(jnp.exp))
    got = port(torch.tensor(PHASES, dtype=torch.float64))
    assert np.array_equal(got.numpy(), want)


def test_norm_angles_are_the_references():
    from pint_torch.templates import NormAngles as P
    from pint_tpu.templates import NormAngles as R

    a, b = P([0.2, 0.5, 0.1]), R([0.2, 0.5, 0.1])
    assert np.array_equal(a(), b()) and np.array_equal(a.p, b.p)
    a.set_total(0.5)
    b.set_total(0.5)
    assert np.array_equal(a(), b())
    assert np.array_equal(a.gradient(), b.gradient())
    a.set_single_norm(1, 0.3)
    b.set_single_norm(1, 0.3)
    assert np.array_equal(a.p, b.p)
    with pytest.raises(ValueError):
        P([0.7, 0.5])


def _templates():
    from pint_torch import templates as P
    from pint_tpu import templates as R

    def make(mod):
        return mod.LCTemplate([mod.LCGaussian([0.04, 0.15]),
                               mod.LCGaussian([0.06, 0.59]),
                               mod.LCVonMises([0.1, 0.8])],
                              [0.3, 0.25, 0.1])
    return make(P), make(R)


def test_template_mixture_on_numpy_and_tensors():
    """The mixture bg + sum n_i prim_i: numpy phases bitwise the
    reference's, a (walkers, photons) tensor within 1e-13 of its jnp
    evaluation and float64; the suppressed-background form too."""
    port, ref = _templates()
    assert np.array_equal(port(PHASES), np.asarray(ref(PHASES)))
    x = np.stack([PHASES, (PHASES + 0.3) % 1.0])
    got = port(torch.tensor(x, dtype=torch.float64))
    want = np.asarray(ref(jnp.asarray(x)))
    assert got.dtype == torch.float64 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()
    got = port(torch.tensor(PHASES, dtype=torch.float64), suppress_bg=True)
    want = np.asarray(ref(jnp.asarray(PHASES), suppress_bg=True))
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()
    assert port.integrate() == ref.integrate()
    assert np.array_equal(port.get_parameters(), ref.get_parameters())
    assert port.get_parameter_names() == ref.get_parameter_names()


@pytest.mark.parametrize("which", ["mixture", "two_sided", "skew",
                                   "rejection", "fourier"])
def test_random_draws_bitwise(which):
    """Draws from the same numpy generator are the reference's bitwise:
    the multinomial split, each primitive's analytic draw, the rejection
    fallback and the whole-template rejection of Fourier shapes."""
    from pint_torch import templates as P
    from pint_torch.templates import lcprimitives as PP
    from pint_tpu import templates as R
    from pint_tpu.templates import lcprimitives as RP

    def make(mod, prims):
        if which == "mixture":
            return mod.LCTemplate([mod.LCGaussian([0.04, 0.15]),
                                   mod.LCVonMises([0.06, 0.59]),
                                   mod.LCLorentzian([0.02, 0.3]),
                                   mod.LCTopHat([0.1, 0.8])],
                                  [0.3, 0.2, 0.1, 0.1])
        if which == "two_sided":
            return mod.LCTemplate([prims.LCGaussian2([0.02, 0.04, 0.3]),
                                   prims.LCLorentzian2([0.01, 0.03, 0.7])],
                                  [0.4, 0.3])
        if which == "skew":
            return mod.LCTemplate([prims.LCSkewGaussian([0.03, 2.0, 0.4])],
                                  [0.7])
        if which == "rejection":
            return mod.LCTemplate([prims.LCKing([0.03, 5.0, 0.5])], [0.6])
        return mod.LCTemplate([prims.LCHarmonic([0.2], order=2)], [0.3])

    a, b = make(P, PP), make(R, RP)
    got = a.random(3000, rng=np.random.default_rng(5))
    want = b.random(3000, rng=np.random.default_rng(5))
    assert np.array_equal(got, want)
    f = lambda loc, scale, size: np.random.default_rng(2).normal(  # noqa
        loc, scale, size)
    assert np.array_equal(
        PP.two_comp_mc(500, 0.02, 0.05, 0.4, f, np.random.default_rng(3)),
        RP.two_comp_mc(500, 0.02, 0.05, 0.4, f, np.random.default_rng(3)))


def test_gauss_template_file_round_trips(tmp_path):
    """The pygaussfit-style file: the reference test's text reads the same
    template in both packages, and write_profile -> prim_io round trips
    to the same values."""
    from pint_torch import templates as P
    from pint_tpu import templates as R

    src = tmp_path / "gauss.txt"
    src.write_text("const = 0.4\nphas1 = 0.30 0.01\nfwhm1 = 0.047 0.002\n"
                   "ampl1 = 0.6 0.05\nphas2 = 0.74 0.01\nfwhm2 = 0.09 0.002\n"
                   "ampl2 = 0.3 0.05\n")
    a = P.gauss_template_from_file(str(src))
    b = R.gauss_template_from_file(str(src))
    assert np.array_equal(a.get_parameters(), b.get_parameters())
    assert np.array_equal(a(PHASES), np.asarray(b(PHASES)))
    out_a, out_b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_profile(str(out_a))
    b.write_profile(str(out_b))
    assert out_a.read_text() == out_b.read_text()
    pa, na = P.prim_io(str(out_a))
    pb, nb = R.prim_io(str(out_b))
    assert na == nb and all(np.array_equal(x.p, y.p)
                            for x, y in zip(pa, pb))
    with pytest.raises(ValueError):
        (tmp_path / "bad.txt").write_text("const = 1\n")
        P.prim_io(str(tmp_path / "bad.txt"))


def test_lcfitter_fits_bitwise():
    """``LCFitter`` is a host copy: the same photons give the same
    Nelder-Mead fit, errors, position fit and statistics bitwise."""
    from pint_torch.templates import LCFitter as PF
    from pint_tpu.templates import LCFitter as RF

    port, ref = _templates()
    ph = ref.random(2000, rng=np.random.default_rng(11))
    w = np.random.default_rng(12).beta(0.5, 1.5, len(ph))
    fa, fb = PF(port, ph, weights=w), RF(ref, ph, weights=w)
    assert fa.loglikelihood() == fb.loglikelihood()
    assert fa.fit(maxiter=300) == fb.fit(maxiter=300)
    assert np.array_equal(port.get_parameters(), ref.get_parameters())
    assert np.array_equal(fa.errors, fb.errors)
    assert fa.fit_position() == fb.fit_position()
    assert fa.chi() == fb.chi() and fa.aic() == fb.aic()
    assert fa.binned_loglikelihood() == fb.binned_loglikelihood()


def test_make_err_plot_names_its_item():
    from pint_torch.templates import make_err_plot

    port, _ = _templates()
    with pytest.raises(NotImplementedError, match="item 12"):
        make_err_plot(port)


@pytest.mark.parametrize("name,p,kw", [e for e in PRIMS
                                       if e[0] != "LCTopHat"],
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(PRIMS) if n != "LCTopHat"])
def test_check_gradient_jacfwd_matches_jax(name, p, kw):
    """``torch.func.jacfwd`` of the torch branch against ``jax.jacfwd`` of
    the reference's jnp branch in every parameter: 1e-10 of each
    parameter's largest partial; ``check_gradient`` agrees with the
    reference's verdict."""
    from pint_torch.templates.lcprimitives import check_gradient as PC
    from pint_tpu.templates.lcprimitives import check_gradient as RC

    port, ref = _both(name, p, kw)
    ph = np.random.default_rng(0).random(100)
    got = torch.func.jacfwd(lambda q: port._pdf(
        torch.tensor(ph, dtype=torch.float64), q))(
        torch.tensor(port.p, dtype=torch.float64)).numpy()
    want = np.asarray(jax.jacfwd(lambda q: ref._pdf(jnp.asarray(ph), q))(
        jnp.asarray(ref.p)))
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want) <= 1e-10 * np.maximum(scale, 1e-300)).all()
    assert PC(port) == RC(ref)


EVENTSTATS = [("z2m", lambda ph, w: ((ph,), {"m": 4})),
              ("z2m", lambda ph, w: ((ph,), {"m": 3, "weights": w})),
              ("z2mw", lambda ph, w: ((ph, w), {"m": 3})),
              ("hm", lambda ph, w: ((ph,), {})),
              ("hmw", lambda ph, w: ((ph, w), {})),
              ("cosm", lambda ph, w: ((ph,), {"m": 3})),
              ("best_m", lambda ph, w: ((ph,), {"m": 30})),
              ("best_m", lambda ph, w: ((ph,), {"weights": w, "m": 30})),
              ("em_four", lambda ph, w: ((ph,), {"m": 4, "weights": w})),
              ("sf_z2m", lambda ph, w: ((17.5,), {"m": 2})),
              ("sf_hm", lambda ph, w: ((23.0,), {})),
              ("h2sig", lambda ph, w: ((23.0,), {})),
              ("sig2sigma", lambda ph, w: ((1e-7,), {})),
              ("sigma2sig", lambda ph, w: ((4.5,), {})),
              ("sf_stackedh", lambda ph, w: ((3, 40.0), {})),
              ("sf_h20_dj1989", lambda ph, w: ((23.0,), {})),
              ("sf_h20_dj2010", lambda ph, w: ((23.0,), {})),
              ("sig2h20", lambda ph, w: ((1e-6,), {})),
              ("sigma_trials", lambda ph, w: ((5.0, 100.0), {})),
              ("sigma_trials", lambda ph, w: ((25.0, 100.0), {})),
              ("to_array", lambda ph, w: ((3.5,), {})),
              ("from_array", lambda ph, w: ((np.array([3.5]),), {}))]


@pytest.mark.parametrize("name,args", EVENTSTATS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(EVENTSTATS)])
def test_eventstats_bitwise(name, args):
    """Every statistic, survival function and sigma conversion of the
    host copy equals the reference's bitwise."""
    from pint_torch import eventstats as P
    from pint_tpu import eventstats as R

    port, _ = _templates()
    ph = port.random(5000, rng=np.random.default_rng(21))
    w = np.random.default_rng(22).beta(0.5, 1.5, len(ph))
    a, kw = args(ph, w)
    got, want = getattr(P, name)(*a, **kw), getattr(R, name)(*a, **kw)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    if name == "em_four":
        dom = np.linspace(0, 1, 33)
        assert np.array_equal(P.em_lc(got, dom), R.em_lc(want, dom))
    if name == "sigma_trials":  # and through vec, as the reference offers
        x = np.array([2.0, 5.0, 30.0])
        assert np.array_equal(P.vec(P.sigma_trials)(x, 10.0),
                              R.vec(R.sigma_trials)(x, 10.0))


@pytest.mark.parametrize("nharm", [0, 12])
def test_fftfit_full_matches_reference(nharm):
    """``fftfit_full`` with torch's FFTs on the host device asked for:
    the shift within 1e-12 cycles of the reference's, the scale and both
    errors 1e-12 rel; the default device is the card."""
    from pint_torch import NoGPUError
    from pint_torch.fftfit import fftfit_basic, fftfit_full
    from pint_tpu.fftfit import fftfit_full as ref_fftfit

    port, _ = _templates()
    grid = (np.arange(256) + 0.5) / 256
    tpl = port(grid)
    ph = port.random(20000, rng=np.random.default_rng(31))
    prof, _ = np.histogram((ph + 0.137) % 1.0, bins=256, range=(0.0, 1.0))
    got = fftfit_full(tpl, prof.astype(np.float64), nharm, device="cpu")
    want = ref_fftfit(tpl, prof.astype(np.float64), nharm)
    d = (got[0] - want[0] + 0.5) % 1.0 - 0.5
    assert abs(d) <= 1e-12 and abs(got[0] - 0.137) < 0.01
    for g, w in zip(got[1:], want[1:]):
        assert abs(g - w) <= 1e-12 * abs(w)
    assert fftfit_basic(tpl, prof.astype(np.float64), device="cpu") \
        == fftfit_full(tpl, prof.astype(np.float64), device="cpu")[0]
    with pytest.raises(ValueError):
        fftfit_full(tpl, prof[:-1].astype(np.float64), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(NoGPUError):
            fftfit_full(tpl, prof.astype(np.float64))
