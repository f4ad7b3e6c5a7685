"""The three hand kernels' autodiff wiring and plain twins, on the CPU.

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


def test_spin_phase_twin_matches_reference_spindown(k1_inputs):
    """The twin against the reference composition of mul_mod1 and
    day2sec_exact (spindown.py:70-123), bitwise (measured gap 0)."""
    from pint_tpu import dd as jdd

    th, tl, tdb0, pe, dl, F = k1_inputs
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
    tt0, params = k2_inputs
    p = params.clone()
    p[:, 10] = 1.5  # SINI > 1: the Shapiro brace goes negative somewhere
    d, _ = K2.dd_binary_reference(tt0, p)
    assert bool(torch.isnan(d).any())


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
    assert K3.launch_counts == {"schur_cholesky_solve": 0}  # CPU: no kernel
    for b in range(B):
        xj, okj, cj = _jax_schur_solve(jnp.asarray(Ar[b]),
                                       jnp.asarray(rhs[b]), 1e-12)
        assert bool(ok[b]) == bool(okj)
        if bool(okj):
            assert np.abs(x[b].numpy() - np.asarray(xj)).max() \
                <= 1e-10 * np.abs(np.asarray(xj)).max()
            assert abs(float(cond[b]) / float(cj) - 1) <= 1e-10
        else:
            assert bool(torch.isnan(x[b]).all())
            assert math.isnan(float(cond[b])) == math.isnan(float(cj))
