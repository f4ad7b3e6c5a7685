"""The ELL1 slice's models on the CPU: K4's plain twin against the
reference ELL1/ELL1k engines, its reverse-sweep partials against
``jax.jacfwd``, the ecliptic astrometry and its obliquity table.

Inputs are made from seeded numpy generators and handed to both packages.
The twin's arithmetic is the reference's eager arithmetic operation for
operation: with the reference's own sine, cosine and logarithm swapped in
(XLA's, which equal glibc's) the delay is bitwise the reference's.  With
torch's CPU functions -- SLEEF's, which differ from XLA's in the last bit
on ~0.2% of arguments -- it stays within 1e-15 s on delays of ~2 s
(measured up to 4.4e-16 s).  On the card the kernel and the twin call the
same libdevice functions, and ``chip_smoke.py`` holds them bitwise.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pint_torch.kernels import ell1_binary as K4
from pint_torch.models.binary import engines as T

pytestmark = pytest.mark.torch

F64 = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _orbits(seed: int, B: int = 3, N: int = 400):
    """J1909-3744-like rows with |EPS| to 1e-2 and every secular term set;
    half the TOAs within 5 s of a whole orbit (the phase's 0/2 pi wrap)."""
    rng = np.random.default_rng(seed)
    P = np.array([[1.533449474 * (1 + 1e-3 * rng.normal()),
                   rng.uniform(-1e-12, 1e-12), rng.uniform(-1e-13, 1e-13),
                   1.8979911 * (1 + 1e-3 * rng.normal()),
                   rng.uniform(-1e-14, 1e-14), rng.uniform(-1e-2, 1e-2),
                   rng.uniform(-1e-2, 1e-2), rng.uniform(-1e-16, 1e-16),
                   rng.uniform(-1e-16, 1e-16), rng.uniform(0.0, 5.0),
                   rng.uniform(-1e-3, 1e-3), 0.2067 * (1 + 0.1 * rng.normal()),
                   rng.uniform(0.5, 0.999)] for _ in range(B)])
    t = np.concatenate([
        rng.uniform(-3e8, 3e8, (B, N // 2)),
        np.round(rng.uniform(-2e3, 2e3, (B, N - N // 2))) * P[:, :1] * 86400.0
        + rng.uniform(-5.0, 5.0, (B, N - N // 2))], axis=1)
    return t, P


def _reference_delay(t, P, ell1k):
    from pint_tpu.models.binary import engines as eng

    fn = eng.ell1k_delay if ell1k else eng.ell1_delay
    return np.stack([np.asarray(fn({n: jnp.asarray(P[b, i])
                                    for i, n in enumerate(T.ELL1_PARAMS)},
                                   jnp.asarray(t[b])))
                     for b in range(len(P))])


def _xla(fn):
    def f(x):
        return torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))
    return f


@pytest.mark.parametrize("ell1k", [False, True], ids=["ELL1", "ELL1k"])
def test_ell1_twin_is_the_reference_arithmetic_bitwise(ell1k, monkeypatch):
    """With XLA's sine, cosine and logarithm in place of torch's, the twin's
    delay is bitwise the reference engine's (``engines.py:440,450``) on
    random orbits across the phase wrap."""
    t, P = _orbits(41 + ell1k)
    want = _reference_delay(t, P, ell1k)
    monkeypatch.setattr(torch, "sin", _xla(jnp.sin))
    monkeypatch.setattr(torch, "cos", _xla(jnp.cos))
    monkeypatch.setattr(torch, "log", _xla(jnp.log))
    d, _ = K4.ell1_binary_reference(_t(t), _t(P), ell1k, partials=False)
    np.testing.assert_array_equal(d.numpy(), want)
    p = {n: _t(P[:, i:i + 1]) for i, n in enumerate(T.ELL1_PARAMS)}
    d2 = T.ell1k_delay(p, _t(t)) if ell1k else T.ell1_delay(p, _t(t))
    np.testing.assert_array_equal(d2.numpy(), want)
    from pint_tpu.models.binary import engines as eng

    dI, phi, pbp = T.ell1_inverse_delay(p, _t(t), ell1k)
    for b in range(len(P)):
        ref = eng.ell1_inverse_delay(
            {n: jnp.asarray(P[b, i]) for i, n in enumerate(T.ELL1_PARAMS)},
            jnp.asarray(t[b]), ell1k=ell1k)
        for got, want_b in zip((dI[b], phi[b], pbp[b].expand(t.shape[1])),
                               ref):
            np.testing.assert_array_equal(
                got.numpy(), np.broadcast_to(np.asarray(want_b), got.shape))


@pytest.mark.parametrize("ell1k", [False, True], ids=["ELL1", "ELL1k"])
def test_ell1_twin_matches_reference_within_a_last_bit(ell1k):
    """With torch's own CPU functions the twin stays within 1e-15 s of the
    reference (the last bit of SLEEF's sine against XLA's)."""
    t, P = _orbits(43 + ell1k)
    want = _reference_delay(t, P, ell1k)
    d, _ = K4.ell1_binary_reference(_t(t), _t(P), ell1k, partials=False)
    assert np.abs(d.numpy() - want).max() <= 1e-15


@pytest.mark.parametrize("ell1k", [False, True], ids=["ELL1", "ELL1k"])
def test_ell1_reverse_sweep_matches_reference_jacfwd(ell1k):
    """The 14 partials of the twin's reverse sweep against ``jax.jacfwd``
    of the reference engine in ttasc and the 13 parameters: each within
    1e-10 of its column's largest (measured below 1e-14); the parameters
    the variant does not read get exact zeros."""
    from pint_tpu.models.binary import engines as eng

    t, P = _orbits(47 + ell1k)
    _, Pt = K4.ell1_binary_reference(_t(t), _t(P), ell1k)
    fn = eng.ell1k_delay if ell1k else eng.ell1_delay

    def one(x):
        return fn({n: x[1 + i] for i, n in enumerate(T.ELL1_PARAMS)}, x[0])

    jac = jax.jit(jax.vmap(jax.jacfwd(one)))
    for b in range(len(P)):
        x = np.concatenate([t[b][:, None],
                            np.broadcast_to(P[b], (t.shape[1], 13))], axis=1)
        J = np.asarray(jac(jnp.asarray(x)))
        err = np.abs(Pt[b].numpy() - J).max(axis=0)
        assert (err <= 1e-10 * np.abs(J).max(axis=0)).all(), err
    unread = (10, 11) if not ell1k else (8, 9)
    assert bool((Pt[..., list(unread)] == 0).all())


def test_ell1_nan_delay_poisons_all_14_partials():
    """SINI sin(phi) > 1 makes the Shapiro log NaN: the delay is NaN there
    and so is each of its 14 partials, the unread ones too; elsewhere
    every partial is finite."""
    t, P = _orbits(53)
    P[:, 12] = 1.5
    for ell1k in (False, True):
        d, Pt = K4.ell1_binary_reference(_t(t), _t(P), ell1k)
        bad = torch.isnan(d)
        assert bool(bad.any()) and not bool(bad.all())
        assert bool(torch.isnan(Pt[bad]).all())
        assert bool(torch.isfinite(Pt[~bad]).all())


def test_obliquity_table_is_the_references():
    from pint_tpu import OBL_IERS2010_ARCSEC, OBL_IERS2010_RAD
    from pint_tpu.pulsar_ecliptic import OBL as OBL_REF

    from pint_torch import pulsar_ecliptic as pe

    assert pe.OBL_IERS2010_ARCSEC == OBL_IERS2010_ARCSEC
    assert pe.OBL_IERS2010_RAD == OBL_IERS2010_RAD
    assert pe.OBL == OBL_REF


def test_ecliptic_astrometry_matches_reference():
    """``AstrometryEcliptic.ssb_to_psb_xyz`` (ELONG/ELAT/PMELONG/PMELAT
    with POSEPOCH, rotated to equatorial) on (B, 1) free values over a
    decade of epochs: within 1e-15 of the reference's unit vectors
    (``astrometry.py:262``)."""
    from pint_tpu.models.astrometry import AstrometryEcliptic as Ref

    from pint_torch.dd import DD
    from pint_torch.models.astrometry import AstrometryEcliptic

    rng = np.random.default_rng(61)
    B, N = 3, 200
    elong = rng.uniform(0, 2 * np.pi, B)
    elat = rng.uniform(-1.2, 1.2, B)
    pml = rng.uniform(-50, 50, B)
    pmb = rng.uniform(-50, 50, B)
    ep = rng.uniform(53000.0, 57000.0, N)
    comp = AstrometryEcliptic({"has_posepoch": True})
    pv = {"ELONG": _t(elong[:, None]), "ELAT": _t(elat[:, None]),
          "PMELONG": _t(pml[:, None]), "PMELAT": _t(pmb[:, None]),
          "POSEPOCH": DD(55000.0, 0.0)}
    got = comp.ssb_to_psb_xyz(pv, _t(ep)).numpy()
    ref = Ref()
    ref.POSEPOCH.value = 55000.0
    for b in range(B):
        want = np.asarray(ref.ssb_to_psb_xyz(
            {"ELONG": jnp.float64(elong[b]), "ELAT": jnp.float64(elat[b]),
             "PMELONG": jnp.float64(pml[b]), "PMELAT": jnp.float64(pmb[b]),
             "POSEPOCH": jnp.float64(55000.0)}, jnp.asarray(ep)))
        assert np.abs(got[b] - want).max() <= 1e-15
