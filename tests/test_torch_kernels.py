"""The hand kernels' autodiff wiring and plain twins, on the CPU.

A CUDA kernel has no interpret mode, so here each kernel's
:class:`torch.autograd.Function` runs with its plain PyTorch twin behind it
(CPU tensors dispatch to the twin).  Under ``torch.func.jacfwd`` with a
batch B > 1 its Jacobian must match ``jacfwd`` of the plain primal
function, which proves the ``setup_context``/``jvp``/``vmap`` wiring the
kernels use on the card.  The twins are held against the reference
package's functions; the kernels themselves are checked against the twins
on the card by ``chip_smoke.py`` (the test suite needs JAX, which the
machine with the card does not have).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import torch
from torch.func import jacfwd, vmap

from pint_torch.kernels import dd_binary as K2
from pint_torch.kernels import ell1_binary as K4
from pint_torch.kernels import schur_cholesky_solve as K3
from pint_torch.kernels import spin_phase as K1

pytestmark = pytest.mark.torch

F64 = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.fixture(scope="module")
def k1_inputs():
    rng = np.random.default_rng(11)
    B, N, S = 3, 50, 3
    th = np.round(rng.uniform(-2.0**34, 2.0**34, N))
    tl = rng.uniform(-1e-6, 1e-6, N)
    pe = np.stack([55000.0 + rng.uniform(-100, 100, B),
                   rng.uniform(-1e-12, 1e-12, B)], axis=1)
    dl = rng.uniform(-500.0, 500.0, (B, N))
    F = np.stack([rng.uniform(100.0, 700.0, B), -rng.uniform(0, 1e-14, B),
                  rng.uniform(-1e-25, 1e-25, B)], axis=1)
    return _t(th), _t(tl), 55000.0, _t(pe), _t(dl), _t(F)


@pytest.fixture(scope="module")
def k2_inputs():
    rng = np.random.default_rng(12)
    B, N = 3, 40
    base = dict(PB=12.327, PBDOT=1e-12, XPBDOT=2e-13, A1=9.23, A1DOT=1e-14,
                ECC=0.3, EDOT=1e-16, OM=276.5, OMDOT=0.01, M2=0.27,
                SINI=0.9991, GAMMA=1e-5, DR=1e-6, DTH=2e-6, A0=1e-7, B0=2e-7)
    params = np.array([[base[k] * (1 + 1e-3 * rng.standard_normal())
                        for k in K2.DD_PARAMS] for _ in range(B)])
    tt0 = rng.uniform(-2e8, 2e8, (B, N))
    return _t(tt0), _t(params)


def _k1_frac(th, tl, tdb0):
    def f(pe, dl, F):
        return K1.spin_phase(th, tl, tdb0, pe, dl, F)[1]

    def plain(pe, dl, F):
        return K1.spin_phase_reference(th, tl, tdb0, pe, dl, F,
                                       partials=False)[1]

    return f, plain


@pytest.mark.parametrize("argnum", [0, 1, 2])
def test_spin_phase_function_under_jacfwd(k1_inputs, argnum):
    th, tl, tdb0, pe, dl, F = k1_inputs
    f, plain = _k1_frac(th, tl, tdb0)
    got = jacfwd(f, argnums=argnum)(pe, dl, F)
    want = jacfwd(plain, argnums=argnum)(pe, dl, F)
    if argnum == 0:  # only PEPOCH's high word carries a partial
        got, want = got[..., 0], want[..., 0]
    assert _rel(got, want) <= 1e-12


def test_spin_phase_primal_matches_partials_path(k1_inputs):
    th, tl, tdb0, pe, dl, F = k1_inputs
    k0, f0, _ = K1.spin_phase_reference(th, tl, tdb0, pe, dl, F,
                                        partials=False)
    k1, f1, P = K1.spin_phase_reference(th, tl, tdb0, pe, dl, F)
    assert torch.equal(k0, k1) and torch.equal(f0, f1)
    assert P.shape == (3, 50, F.shape[1] + 2)


def test_spin_phase_vmap_folds_into_the_batch(k1_inputs):
    th, tl, tdb0, pe, dl, F = k1_inputs
    V = 4
    dls = torch.stack([dl + i for i in range(V)])
    Fs = torch.stack([F * (1 + 1e-9 * i) for i in range(V)])

    def f(dl_, F_):
        return K1.SpinPhaseFn.apply(th, tl, pe, dl_, F_, tdb0, True)[1]

    got = vmap(f)(dls, Fs)
    want = torch.stack([K1.spin_phase_reference(th, tl, tdb0, pe, dls[i],
                                                Fs[i])[1] for i in range(V)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 2, 3, 6])
def test_spin_phase_twin_matches_reference_spindown(k1_inputs, S):
    """The twin against the reference composition of mul_mod1 and
    day2sec_exact (spindown.py:70-123), bitwise (measured gap 0), with
    S = 1 to 6 spin terms: the orders of the kernel's templates that the
    card check runs."""
    from pint_tpu import dd as jdd

    th, tl, tdb0, pe, dl, F = k1_inputs
    rng = np.random.default_rng(100 + S)
    F = torch.cat([F[:, :1], _t(rng.uniform(-1.0, 1.0, (F.shape[0], S - 1))
                               * 10.0 ** (-3.0 - 11.0 * np.arange(1, S)))],
                  dim=1)
    k, f, _ = K1.spin_phase_reference(th, tl, tdb0, pe, dl, F)
    for b in range(dl.shape[0]):
        F0 = jnp.float64(float(F[b, 0]))
        folds = [jnp.asarray(th.numpy())]
        tail = jnp.asarray(tl.numpy()) - jnp.asarray(dl[b].numpy())
        e1, e2 = jdd.day2sec_exact(jnp.float64(float(pe[b, 0])) - tdb0)
        folds += [-e1, -e2]
        tail = tail - float(pe[b, 1]) * 86400.0
        kk = jnp.zeros(th.shape[0])
        ff = jnp.zeros(th.shape[0])
        for t in folds:
            ki, fi = jdd.mul_mod1(F0, jnp.broadcast_to(t, th.shape))
            kk, ff = kk + ki, ff + fi
        dt64 = sum(folds) + tail
        ff = ff + F0 * tail
        acc = jnp.zeros(th.shape[0])
        for i in range(F.shape[1] - 1, 0, -1):
            acc = acc * dt64 + float(F[b, i]) / math.factorial(i + 1)
        ff = ff + acc * dt64 * dt64
        k2 = jnp.round(ff)
        np.testing.assert_array_equal(k[b].numpy(), np.asarray(kk + k2))
        np.testing.assert_array_equal(f[b].numpy(), np.asarray(ff - k2))


@pytest.mark.parametrize("argnum", [0, 1])
def test_dd_binary_function_under_jacfwd(k2_inputs, argnum):
    tt0, params = k2_inputs
    got = jacfwd(lambda t, p: K2.dd_binary(t, p), argnums=argnum)(tt0, params)
    want = jacfwd(lambda t, p: K2.dd_binary_reference(t, p, False)[0],
                  argnums=argnum)(tt0, params)
    assert _rel(got, want) <= 1e-12


def test_dd_binary_vmap_folds_into_the_batch(k2_inputs):
    tt0, params = k2_inputs
    tts = torch.stack([tt0 + 1e4 * i for i in range(3)])
    got = vmap(lambda t: K2.DDBinaryFn.apply(t, params)[0])(tts)
    want = torch.stack([K2.dd_binary_reference(tts[i], params)[0]
                        for i in range(3)])
    assert torch.equal(got, want)


def test_dd_binary_twin_matches_reference_engine(k2_inputs):
    """Delay bitwise and partials within 1e-12 of the reference engine's
    jacfwd (engines.py:216 dd_delay; measured 0 and ~2e-16)."""
    from pint_tpu.models.binary import engines as eng

    tt0, params = k2_inputs
    d, P = K2.dd_binary_reference(tt0, params)

    def fj(t, pr):
        return eng.dd_delay({k: pr[i] for i, k in enumerate(K2.DD_PARAMS)}, t)

    jac_p = jax.jit(jax.jacfwd(fj, argnums=1))
    jac_t = jax.jit(lambda t, pr: jax.jvp(
        fj, (t, pr), (jnp.ones_like(t), jnp.zeros_like(pr)))[1])
    for b in range(tt0.shape[0]):
        t = jnp.asarray(tt0[b].numpy())
        pr = jnp.asarray(params[b].numpy())
        np.testing.assert_array_equal(d[b].numpy(), np.asarray(fj(t, pr)))
        Jp = np.asarray(jac_p(t, pr))
        Jt = np.asarray(jac_t(t, pr))
        assert np.abs(P[b, :, 1:].numpy() - Jp).max() \
            <= 1e-12 * np.abs(Jp).max()
        assert np.abs(P[b, :, 0].numpy() - Jt).max() \
            <= 1e-12 * np.abs(Jt).max()


def test_dd_binary_nan_propagates_through_the_shapiro_log(k2_inputs):
    """SINI > 1 turns the Shapiro brace negative somewhere: the delay is NaN
    there and so is every one of its 17 partials; elsewhere all stay
    finite."""
    tt0, params = k2_inputs
    p = params.clone()
    p[:, 10] = 1.5
    d, P = K2.dd_binary_reference(tt0, p)
    bad = torch.isnan(d)
    assert bool(bad.any()) and not bool(bad.all())
    assert bool(torch.isnan(P[bad]).all())
    assert bool(torch.isfinite(P[~bad]).all())


def _k2_orbit(ecc: float, tspan: float, seed: int):
    rng = np.random.default_rng(seed)
    B, N = 2, 60
    base = dict(PB=5.741, PBDOT=-3e-12, XPBDOT=1e-13, A1=3.37, A1DOT=2e-14,
                ECC=ecc, EDOT=1e-17, OM=87.0, OMDOT=0.02, M2=0.3, SINI=0.97,
                GAMMA=2e-5, DR=3e-6, DTH=-1e-6, A0=2e-7, B0=-1e-7)
    params = np.array([[base[k] * (1 + 1e-4 * rng.standard_normal())
                        for k in K2.DD_PARAMS] for _ in range(B)])
    tt0 = rng.uniform(-tspan, tspan, (B, N))
    return _t(tt0), _t(params)


@pytest.mark.parametrize("tspan", [3e5, 4e7, 3e8])
@pytest.mark.parametrize("ecc", [1e-5, 0.3, 0.9])
def test_dd_binary_reverse_sweep_matches_reference_jacfwd(ecc, tspan):
    """The twin's reverse sweep (Kepler differentiated at its root) against
    jacfwd of the reference engine through its 15 Newton steps, at
    near-circular to eccentric orbits and tt0 from days to a decade: each
    partial within 1e-12 of its column's max.  The delay is the reference's
    eager arithmetic, bitwise at e <= 0.3; at e = 0.9 torch's and XLA's CPU
    sines differ in the last bit on a few TOAs and 1/(1 - e cos E) ~ 10
    carries that into the delay (measured up to 8.9e-16 s on ~6 s; the
    forward-mode twin this one replaced differed there too), hence 2e-15 s
    there."""
    from pint_tpu.models.binary import engines as eng

    tt0, params = _k2_orbit(ecc, tspan, seed=int(ecc * 1e5) + int(tspan))
    d, P = K2.dd_binary_reference(tt0, params)

    def fj(t, pr):
        return eng.dd_delay({k: pr[i] for i, k in enumerate(K2.DD_PARAMS)}, t)

    jac_p = jax.jit(jax.jacfwd(fj, argnums=1))
    jac_t = jax.jit(lambda t, pr: jax.jvp(
        fj, (t, pr), (jnp.ones_like(t), jnp.zeros_like(pr)))[1])
    for b in range(tt0.shape[0]):
        t = jnp.asarray(tt0[b].numpy())
        pr = jnp.asarray(params[b].numpy())
        dj = np.asarray(fj(t, pr))
        if ecc <= 0.3:
            np.testing.assert_array_equal(d[b].numpy(), dj)
        assert np.abs(d[b].numpy() - dj).max() <= 2e-15
        J = np.concatenate([np.asarray(jac_t(t, pr))[:, None],
                            np.asarray(jac_p(t, pr))], axis=1)
        err = np.abs(P[b].numpy() - J).max(axis=0)
        assert (err <= 1e-12 * np.abs(J).max(axis=0)).all(), err


@pytest.mark.parametrize("ecc", [2.17e-5, 1e-3, 0.1, 0.3, 0.6, 0.9, 0.95])
def test_kepler_exit_rule_is_bitwise_the_fixed_count_solve(ecc):
    """The kernel's exit rule (stop once the Newton iterate repeats) ends on
    the bits of the twin's 15-step solve_kepler at every eccentricity, and
    near the reference's solve_kepler through JAX: torch's and XLA's CPU
    sines may differ in the last bit, which the root carries over as
    e / (1 - e cos E) <= 1 / (1 - e) of it, so within 1e-15 up to e = 0.3
    and 1e-15 / (1 - e) beyond (measured: 0 to e = 1e-3, one ulp of E to
    0.3, up to 8.9e-15 at 0.95).  Both exits occur: fixed points at every
    e, 2-cycles from e = 1e-3 on; from e = 0.6 some elements run all 15
    steps."""
    from pint_tpu.models.binary import engines as eng
    from pint_torch.models.binary.engines import solve_kepler

    rng = np.random.default_rng(int(ecc * 1e6) + 5)
    M = _t(rng.uniform(0.0, 2.0 * np.pi, 1 << 16))
    e = torch.full_like(M, ecc)
    E, steps, kind = K2.kepler_exit(M, e)
    assert torch.equal(E.view(torch.int64),
                       solve_kepler(M, e).view(torch.int64))
    Ej = np.asarray(eng.solve_kepler(jnp.asarray(M.numpy()),
                                     jnp.asarray(e.numpy())))
    tol = 1e-15 if ecc <= 0.3 else 1e-15 / (1.0 - ecc)
    assert np.abs(E.numpy() - Ej).max() <= tol
    counts = torch.bincount(kind, minlength=3).tolist()
    assert counts[1] > 0
    assert counts[2] > 0 or ecc < 1e-3
    assert (counts[0] > 0) == (ecc >= 0.6)
    assert bool((steps[kind == 0] == 15).all())
    assert 1 <= int(steps.min()) and int(steps.max()) <= 15


def test_kepler_steps_follows_the_twins_mean_anomaly(k2_inputs):
    """kepler_steps runs the exit rule on the twin's own mean anomaly and
    eccentricity: its E is bitwise the twin's 15-step solve on K2's
    inputs."""
    from pint_torch.models.binary.engines import kepler_inputs, solve_kepler

    tt0, params = k2_inputs
    E, steps, kind = K2.kepler_steps(tt0, params)
    p = {k: params[:, i:i + 1] for i, k in enumerate(K2.DD_PARAMS)}
    _, M, e = kepler_inputs(p, tt0, {})
    assert E.shape == steps.shape == kind.shape == tt0.shape
    assert torch.equal(E.view(torch.int64),
                       solve_kepler(M, e).view(torch.int64))
    assert bool((kind > 0).any())


def _jax_schur_solve(Ar, rhs, ridge):
    """grid.py:737-765 as the reference runs it (CPU branch)."""
    nt = Ar.shape[-1]
    an = jnp.sqrt(jnp.maximum(jnp.diag(Ar), 1e-300))
    Arn = Ar / jnp.outer(an, an) + ridge * jnp.eye(nt, dtype=jnp.float64)
    L = jnp.linalg.cholesky(Arn)
    x = jsl.cho_solve((L, True), rhs / an) / an
    ok = jnp.all(jnp.isfinite(x))
    x = jnp.where(ok, x, jnp.nan)
    dL = jnp.diagonal(L)
    cond = (jnp.max(dL) / jnp.maximum(jnp.min(dL), 1e-300)) ** 2
    return x, ok, cond


def test_schur_solve_twin_matches_reference_cholesky():
    rng = np.random.default_rng(13)
    B, nt = 6, 24
    X = rng.standard_normal((B, nt, 3 * nt))
    scale = 10.0 ** rng.uniform(-6, 6, (B, nt))
    Ar = (X @ X.transpose(0, 2, 1)) * scale[:, :, None] * scale[:, None, :]
    rhs = rng.standard_normal((B, nt)) * scale
    Ar[4] = -np.eye(nt)                    # not positive definite
    Ar[5, 2, 3] = Ar[5, 3, 2] = np.nan     # poisoned
    x, ok, cond = K3.schur_cholesky_solve(_t(Ar), _t(rhs), 1e-12)
    assert set(K3.launch_counts.values()) == {0}  # CPU: no kernel
    _check_schur(Ar, rhs, x, ok, cond)


def _check_schur(Ar, rhs, x, ok, cond, ill=()):
    """Each point against the reference solve: ok flags equal; x within
    1e-10 of its max and cond within 1e-10, or for the ``ill`` points both
    within the forward-error bound 1e-15 cond(Arn) (the two factorizations
    sum in different orders); a failed point all NaN with NaN cond."""
    for b in range(Ar.shape[0]):
        xj, okj, cj = _jax_schur_solve(jnp.asarray(Ar[b]),
                                       jnp.asarray(rhs[b]), 1e-12)
        assert bool(ok[b]) == bool(okj)
        if bool(okj):
            tol = 1e-10
            if b in ill:
                an = np.sqrt(np.diag(Ar[b]))
                arn = Ar[b] / np.outer(an, an) + 1e-12 * np.eye(len(an))
                tol = 1e-15 * np.linalg.cond(arn)
            assert np.abs(x[b].numpy() - np.asarray(xj)).max() \
                <= tol * np.abs(np.asarray(xj)).max()
            assert abs(float(cond[b]) / float(cj) - 1) <= tol
        else:
            assert bool(torch.isnan(x[b]).all())
            assert math.isnan(float(cond[b])) == math.isnan(float(cj))


@pytest.mark.parametrize("nt", [129, 232])
def test_schur_solve_twin_beyond_128_rows(nt):
    """K3 takes any nt (the 128-row limit of the first kernel is gone): the
    twin against the reference Cholesky at nt past both the old limit and
    the kernel's shared-memory regime, with an ill-conditioned point
    (eigenvalues 1 to 1e-13), a non-positive-definite point and a NaN
    point."""
    rng = np.random.default_rng(nt)
    B = 5
    X = rng.standard_normal((B, nt, 2 * nt))
    scale = 10.0 ** rng.uniform(-4, 4, (B, nt))
    Ar = (X @ X.transpose(0, 2, 1)) * scale[:, :, None] * scale[:, None, :]
    q, _ = np.linalg.qr(rng.standard_normal((nt, nt)))
    Ar[1] = (q * np.logspace(0, -13, nt)) @ q.T
    Ar[3] = -np.eye(nt)
    Ar[4, 7, 2] = Ar[4, 2, 7] = np.nan
    rhs = rng.standard_normal((B, nt)) * scale
    x, ok, cond = K3.schur_cholesky_solve(_t(Ar), _t(rhs), 1e-12)
    assert x.shape == (B, nt)
    assert [bool(v) for v in ok] == [True, True, True, False, False]
    _check_schur(Ar, rhs, x, ok, cond, ill=(1,))


@pytest.fixture(scope="module")
def k4_inputs():
    rng = np.random.default_rng(14)
    B, N = 3, 40
    base = dict(PB=1.5334, PBDOT=1e-12, XPBDOT=2e-13, A1=1.898, A1DOT=1e-14,
                EPS1=3e-3, EPS2=-5e-3, EPS1DOT=1e-16, EPS2DOT=-2e-16,
                OMDOT=1.7, LNEDOT=2e-4, M2=0.21, SINI=0.998)
    params = np.array([[base[k] * (1 + 1e-3 * rng.standard_normal())
                        for k in K4.ELL1_PARAMS] for _ in range(B)])
    ttasc = rng.uniform(-2e8, 2e8, (B, N))
    return _t(ttasc), _t(params)


@pytest.mark.parametrize("ell1k", [False, True], ids=["ELL1", "ELL1k"])
@pytest.mark.parametrize("argnum", [0, 1])
def test_ell1_binary_function_under_jacfwd(k4_inputs, argnum, ell1k):
    """K4's autograd Function (local partials into ``jvp``) under
    ``jacfwd`` with B > 1 against ``jacfwd`` of the plain primal."""
    tt, params = k4_inputs
    got = jacfwd(lambda t, p: K4.ell1_binary(t, p, ell1k),
                 argnums=argnum)(tt, params)
    want = jacfwd(lambda t, p: K4.ell1_binary_reference(t, p, ell1k,
                                                        False)[0],
                  argnums=argnum)(tt, params)
    assert _rel(got, want) <= 1e-12


def test_ell1_binary_vmap_folds_into_the_batch(k4_inputs):
    tt, params = k4_inputs
    tts = torch.stack([tt + 1e4 * i for i in range(3)])
    got = vmap(lambda t: K4.ELL1BinaryFn.apply(t, params, False)[0])(tts)
    want = torch.stack([K4.ell1_binary_reference(tts[i], params)[0]
                        for i in range(3)])
    assert torch.equal(got, want)


def test_ell1_binary_primal_matches_partials_path(k4_inputs):
    tt, params = k4_inputs
    for ell1k in (False, True):
        d0, none = K4.ell1_binary_reference(tt, params, ell1k, False)
        d1, P = K4.ell1_binary_reference(tt, params, ell1k, True)
        assert none is None and torch.equal(d0, d1)
        assert P.shape == (3, 40, 14)
