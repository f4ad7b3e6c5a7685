"""Double-double arithmetic of the port against the reference package.

Random inputs from a seeded numpy generator go through ``pint_tpu.dd``
(eager JAX on the CPU) and ``pint_torch.dd``; the error-free transforms,
the DD operations, the folded product ``mul_mod1`` and ``day2sec_exact``
must agree bitwise, and so must the JVPs of the two custom-derivative
functions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import jvp

from pint_tpu import dd as jdd
from pint_torch import dd as tdd
from pint_torch.phase import Phase, phase_from_dd

pytestmark = pytest.mark.torch

N = 4096


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20260729)


def _pairs(rng):
    hi = rng.uniform(-1e10, 1e10, N) * 10.0 ** rng.integers(-6, 3, N)
    lo = hi * rng.uniform(-1e-17, 1e-17, N)
    return hi, lo


@pytest.mark.parametrize("op", ["two_sum", "quick_two_sum", "two_prod"])
def test_error_free_transforms_bitwise(rng, op):
    a = rng.uniform(-1e8, 1e8, N)
    b = rng.uniform(-1e3, 1e3, N) * 10.0 ** rng.integers(-8, 0, N)
    s_j, e_j = getattr(jdd, op)(jnp.asarray(a), jnp.asarray(b))
    s_t, e_t = getattr(tdd, op)(_t(a), _t(b))
    _eq(s_t, s_j)
    _eq(e_t, e_j)


@pytest.mark.parametrize("op", ["dd_add", "dd_sub", "dd_mul", "dd_div"])
def test_dd_ops_bitwise(rng, op):
    xh, xl = _pairs(rng)
    yh, yl = _pairs(rng)
    rj = getattr(jdd, op)(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)),
                          jdd.DD(jnp.asarray(yh), jnp.asarray(yl)))
    rt = getattr(tdd, op)(tdd.DD(_t(xh), _t(xl)), tdd.DD(_t(yh), _t(yl)))
    _eq(rt.hi, rj.hi)
    _eq(rt.lo, rj.lo)
    # DD op float
    rj = getattr(jdd, op)(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)),
                          jnp.asarray(yh))
    rt = getattr(tdd, op)(tdd.DD(_t(xh), _t(xl)), _t(yh))
    _eq(rt.hi, rj.hi)
    _eq(rt.lo, rj.lo)


def test_dd_sum_round_split_and_horner_bitwise(rng):
    xh, xl = _pairs(rng)
    xh = xh[:64] * 1e-6
    xl = xl[:64] * 1e-6
    sj = jdd.dd_sum(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)))
    st = tdd.dd_sum(tdd.DD(_t(xh), _t(xl)))
    assert (float(st.hi), float(st.lo)) == (float(sj.hi), float(sj.lo))
    kj, fj = jdd.dd_round_split(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)))
    kt, ft = tdd.dd_round_split(tdd.DD(_t(xh), _t(xl)))
    _eq(kt, kj)
    _eq(ft, fj)
    x = rng.uniform(-3e8, 3e8, N)
    coeffs = [0.123, 173.6879, -1.7e-15, 3e-25]
    hj = jdd.taylor_horner_dd(jdd.DD(jnp.asarray(x), jnp.zeros(N)), coeffs)
    ht = tdd.taylor_horner_dd(tdd.DD(_t(x), torch.zeros(N,
                                                        dtype=torch.float64)),
                              coeffs)
    _eq(ht.hi, hj.hi)
    _eq(ht.lo, hj.lo)


def test_mul_mod1_bitwise_in_bounds(rng):
    """|F0| < 2**12 Hz, |t| < 2**35 s: the folded product's integer parts
    are equal and its fractions equal bitwise (measured gap: 0 ulp)."""
    c = rng.uniform(-2.0**12, 2.0**12, N)
    t = rng.uniform(-2.0**35, 2.0**35, N)
    kj, fj = jdd.mul_mod1(jnp.asarray(c), jnp.asarray(t))
    kt, ft = tdd.mul_mod1(_t(c), _t(t))
    _eq(kt, kj)
    _eq(ft, fj)
    assert float(ft.abs().max()) <= 0.5


def test_day2sec_exact_bitwise(rng):
    d = rng.uniform(-2.0**15, 2.0**15, N)
    e1j, e2j = jdd.day2sec_exact(jnp.asarray(d))
    e1t, e2t = tdd.day2sec_exact(_t(d))
    _eq(e1t, e1j)
    _eq(e2t, e2j)


def test_mul_mod1_jvp_matches_jax(rng):
    c = rng.uniform(1.0, 2.0**12, N)
    t = rng.uniform(-2.0**35, 2.0**35, N)
    dc = rng.standard_normal(N)
    dt = rng.standard_normal(N)
    (_, _), (_, dfj) = jax.jvp(jdd.mul_mod1, (jnp.asarray(c), jnp.asarray(t)),
                               (jnp.asarray(dc), jnp.asarray(dt)))
    _, (_, dft) = jvp(tdd.mul_mod1, (_t(c), _t(t)), (_t(dc), _t(dt)))
    _eq(dft, dfj)


def test_day2sec_jvp_matches_jax(rng):
    d = rng.uniform(-2.0**15, 2.0**15, N)
    dd_ = rng.standard_normal(N)
    _, (t1j, t2j) = jax.jvp(jdd.day2sec_exact, (jnp.asarray(d),),
                            (jnp.asarray(dd_),))
    _, (t1t, t2t) = jvp(tdd.day2sec_exact, (_t(d),), (_t(dd_),))
    _eq(t1t, t1j)
    _eq(t2t, t2j)


def test_phase_renormalizes_like_the_reference(rng):
    from pint_tpu.phase import Phase as JPhase

    i = np.round(rng.uniform(-1e10, 1e10, N))
    f = rng.uniform(-3.0, 3.0, N)
    pj = JPhase.make(jnp.asarray(i), jnp.asarray(f))
    pt = Phase.make(_t(i), _t(f))
    _eq(pt.int_, pj.int_)
    _eq(pt.frac, pj.frac)
    s = pt + Phase.make(_t(i), _t(-f))
    sj = pj + JPhase.make(jnp.asarray(i), jnp.asarray(-f))
    _eq(s.int_, sj.int_)
    _eq(s.frac, sj.frac)
    xh, xl = _pairs(rng)
    pd = phase_from_dd(tdd.DD(_t(xh), _t(xl)))
    from pint_tpu.phase import phase_from_dd as jphase_from_dd

    pdj = jphase_from_dd(jdd.DD(jnp.asarray(xh), jnp.asarray(xl)))
    _eq(pd.int_, pdj.int_)
    _eq(pd.frac, pdj.frac)
