"""ELL1H on the CPU: K4's plain twin in its three orthometric forms against
the reference's ``ell1h_delay`` (``engines.py:456-495``), and its
reverse-sweep partials against ``jax.jacfwd`` of it.

The forms: exact (STIGMA set and not 0), the harmonic sum of stigma =
STIGMA, and the harmonic sum of stigma = H4/H3, at NHARMS = 3, 7 and 12,
on seeded random orbits across the orbital phase's wrap, with rows at
H3 = 0.  Inputs are made with numpy and handed to both packages.  With
XLA's sine, cosine and logarithm swapped in for torch's the delay is
bitwise the reference's; the twin's powers of stigma repeat
``lax.integer_pow``'s products (x^3 = x x^2, x^4 = (x^2)^2).
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
#: (mode, use_h4) of the three forms
FORMS = {"exact": (T.ELL1H_EXACT, False),
         "harmonic-stigma": (T.ELL1H_HARMONIC, False),
         "harmonic-h4": (T.ELL1H_HARMONIC, True)}


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _orbits(seed: int, use_h4: bool, B: int = 4, N: int = 300):
    """J1909-3744-like ELL1H rows (ELL1H_PARAMS): stigma 0.3-0.97, H3 from
    M2 ~ 0.2; with ``use_h4`` H4 = H3 stigma and STIGMA unset (0), the
    last row at H3 = 0; half the TOAs within 5 s of a whole orbit."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        sig = rng.uniform(0.3, 0.97)
        h3 = 4.925490947000518e-6 * 0.2067 * (1 + 0.1 * rng.normal()) \
            * sig**3
        rows.append([1.533449474 * (1 + 1e-3 * rng.normal()),
                     rng.uniform(-1e-12, 1e-12), rng.uniform(-1e-13, 1e-13),
                     1.8979911 * (1 + 1e-3 * rng.normal()),
                     rng.uniform(-1e-14, 1e-14), rng.uniform(-1e-2, 1e-2),
                     rng.uniform(-1e-2, 1e-2), rng.uniform(-1e-16, 1e-16),
                     rng.uniform(-1e-16, 1e-16), rng.uniform(0.0, 5.0),
                     rng.uniform(-1e-3, 1e-3), h3,
                     h3 * sig if use_h4 else 0.0, 0.0 if use_h4 else sig])
    P = np.array(rows)
    if use_h4:
        P[-1, 11] = 0.0
    t = np.concatenate([
        rng.uniform(-3e8, 3e8, (B, N // 2)),
        np.round(rng.uniform(-2e3, 2e3, (B, N - N // 2))) * P[:, :1] * 86400.0
        + rng.uniform(-5.0, 5.0, (B, N - N // 2))], axis=1)
    return t, P


def _pv(row, xp):
    return {n: xp(row[i]) for i, n in enumerate(T.ELL1H_PARAMS)
            if n not in ("OMDOT", "LNEDOT")}


def _ref(form, nharms):
    from pint_tpu.models.binary import engines as eng

    mode, use_h4 = FORMS[form]

    def fn(pv, t):
        if not use_h4:
            pv = {k: v for k, v in pv.items() if k != "H4"}
        return eng.ell1h_delay(pv, t, nharms=nharms,
                               exact=mode == T.ELL1H_EXACT, use_h4=use_h4)
    return fn


def _xla(fn):
    def f(x):
        return torch.from_numpy(np.array(fn(jnp.asarray(x.numpy()))))
    return f


@pytest.mark.parametrize("nharms", [3, 7, 12])
@pytest.mark.parametrize("form", list(FORMS))
def test_ell1h_twin_is_the_reference_arithmetic_bitwise(form, nharms,
                                                        monkeypatch):
    """With XLA's sine, cosine and logarithm, the twin's delay is bitwise
    the reference engine's, eager, row by row (H3 = 0 included)."""
    mode, use_h4 = FORMS[form]
    t, P = _orbits(71 + nharms, use_h4)
    fn = _ref(form, nharms)
    want = np.stack([np.asarray(fn(_pv(P[b], jnp.asarray),
                                   jnp.asarray(t[b])))
                     for b in range(len(P))])
    monkeypatch.setattr(torch, "sin", _xla(jnp.sin))
    monkeypatch.setattr(torch, "cos", _xla(jnp.cos))
    monkeypatch.setattr(torch, "log", _xla(jnp.log))
    d, _ = K4.ell1_binary_reference(_t(t), _t(P), mode, False, nharms,
                                    use_h4)
    np.testing.assert_array_equal(d.numpy(), want)
    p = {n: _t(P[:, i:i + 1]) for i, n in enumerate(T.ELL1H_PARAMS)}
    d2 = T.ell1h_delay(p, _t(t), nharms, mode == T.ELL1H_EXACT, use_h4)
    np.testing.assert_array_equal(d2.numpy(), want)


@pytest.mark.parametrize("nharms", [3, 7, 12])
@pytest.mark.parametrize("form", list(FORMS))
def test_ell1h_reverse_sweep_matches_reference_jacfwd(form, nharms):
    """The 15 partials (ttasc, then ELL1H_PARAMS) of the twin's reverse
    sweep against ``jax.jacfwd`` of the reference engine: each within
    1e-10 of its column's largest; the parameters the form does not read
    (OMDOT, LNEDOT, and H4 or STIGMA) get exact zeros, and at H3 = 0 the
    H4 form's H4 partial is 0 as the reference's ``where`` makes it."""
    mode, use_h4 = FORMS[form]
    t, P = _orbits(83 + nharms, use_h4)
    _, Pt = K4.ell1_binary_reference(_t(t), _t(P), mode, True, nharms,
                                     use_h4)
    assert Pt.shape == (len(P), t.shape[1], 15)
    fn = _ref(form, nharms)
    names = [n for n in T.ELL1H_PARAMS]

    def one(x):
        return fn({n: x[1 + i] for i, n in enumerate(names)
                   if n not in ("OMDOT", "LNEDOT")}, x[0])

    jac = jax.jit(jax.vmap(jax.jacfwd(one)))
    for b in range(len(P)):
        x = np.concatenate([t[b][:, None],
                            np.broadcast_to(P[b], (t.shape[1], 14))], axis=1)
        J = np.asarray(jac(jnp.asarray(x)))
        err = np.abs(Pt[b].numpy() - J).max(axis=0)
        assert (err <= 1e-10 * np.abs(J).max(axis=0)).all(), err
    unread = [10, 11, 14 if use_h4 else 13]
    assert bool((Pt[..., unread] == 0).all())
    if use_h4:
        assert bool((Pt[-1, :, 13] == 0).all())
        # harmonic 3 alone does not depend on stigma
        assert bool((Pt[:-1, :, 13] != 0).any()) == (nharms > 3)


def test_ell1h_nan_delay_poisons_all_15_partials():
    """A stigma past 1 in the exact form can make log(1 + stigma^2 - 2
    stigma sin(phi)) NaN only where that is negative, which it never is;
    a NaN ttasc poisons its delay and every one of its partials in each
    form, and leaves the rest finite."""
    for form, (mode, use_h4) in FORMS.items():
        t, P = _orbits(97, use_h4)
        t[1, 7] = np.nan
        d, Pt = K4.ell1_binary_reference(_t(t), _t(P), mode, True, 7, use_h4)
        bad = torch.isnan(d)
        assert int(bad.sum()) == 1 and bool(bad[1, 7])
        assert bool(torch.isnan(Pt[bad]).all())
        assert bool(torch.isfinite(Pt[~bad]).all())


def test_ell1h_primal_matches_partials_path_and_refuses_a_wrong_row():
    t, P = _orbits(101, False)
    for mode in (T.ELL1H_EXACT, T.ELL1H_HARMONIC):
        d0, none = K4.ell1_binary_reference(_t(t), _t(P), mode, False)
        d1, _ = K4.ell1_binary_reference(_t(t), _t(P), mode, True)
        assert none is None and torch.equal(d0, d1)
        assert torch.equal(K4.ell1_binary(_t(t), _t(P), mode), d0)
    with pytest.raises(ValueError):
        K4.ell1_binary(_t(t), _t(P[:, :13]), T.ELL1H_EXACT)
    with pytest.raises(ValueError):
        K4.ell1_binary(_t(t), _t(P), 7)


def test_ell1h_component_validates_and_picks_the_references_form(
        monkeypatch):
    """``BinaryELL1H.validate`` wants H3 and refuses H4 with STIGMA
    (reference ``components.py:686-691``); the form follows the values as
    the reference's does: exact with a non-zero STIGMA, harmonics with
    STIGMA = 0 or with H4 alone (stigma = H4/H3)."""
    from pint_torch.bridge import ELL1H_PATH, load_snapshot

    m, b = load_snapshot(ELL1H_PATH, device="cpu")
    calls = []
    orig = K4.ell1_binary

    def spy(tt, params, mode, nharms=7, use_h4=False, orb=None):
        calls.append((mode, nharms, use_h4))
        return orig(tt, params, mode, nharms, use_h4, orb)

    monkeypatch.setattr(K4, "ell1_binary", spy)
    for h3, h4, stig, want in ((8e-7, None, 0.94, (T.ELL1H_EXACT, 7, False)),
                               (8e-7, None, 0.0,
                                (T.ELL1H_HARMONIC, 7, False)),
                               (8e-7, 7e-7, None,
                                (T.ELL1H_HARMONIC, 7, True))):
        m2 = m.copy()
        m2["H3"].value, m2["H4"].value, m2["STIGMA"].value = h3, h4, stig
        m2.validate()
        calls.clear()
        m2.delay(b)
        assert calls == [want]
    for h3, h4, stig in ((None, None, 0.9), (8e-7, 7e-7, 0.9)):
        m2 = m.copy()
        m2["H3"].value, m2["H4"].value, m2["STIGMA"].value = h3, h4, stig
        with pytest.raises(ValueError):
            m2.validate()
