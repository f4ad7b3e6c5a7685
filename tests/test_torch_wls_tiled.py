"""The order of K5's tiled algorithm, modelled step by step in numpy and
held against the reference's ``jnp.linalg.lstsq`` of the normalized
matrix (``pint_tpu/grid.py:309-321``) at the kernel's bars.

``csrc/wls_lstsq.cu`` runs only on the card; this model repeats its steps
on the CPU so that a tiling mistake shows before any chip time is spent:
a point's N rows in tiles of the source's ``TILE`` rows (the last
zero-padded), folded into a running triangle of ``[Aw | rw]`` by
Householder reflectors
that touch row j of R and the tile rows only (unnormalized: their tile
parts are the tile's columns as they stand), NB at a time in compact WY
form (``W = diag(alpha) R_rows + U^T T``, ``W = Tw^T W``, ``T = T - U
W``, ``R_rows = R_rows - diag(alpha) W``); the column sums of squares
taken per tile; R's columns scaled by 1 / norms after the QR; the
one-sided Jacobi on R^T in round-robin order with the kernel's tolerance
and sweep cap, J^T c rotated along; then the mask and x.  Bars, as
``chip_smoke.py`` holds the kernel to its twin: x within 1e-9 of max|x|,
singular values within 1e-12 of s_max, the same rank, a zero column's x
exactly 0, a NaN in one tile poisoning the whole point.  The model
runs at k = 233 too, a dense-DMX width, where the card's shared memory
sends the kernel to its untiled global path.
"""

import os
import re
import sys

import numpy as np
import pytest

import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from pint_torch.kernels import wls_lstsq as K5  # noqa: E402

pytestmark = pytest.mark.torch

EPS = np.finfo(np.float64).eps
SRC = (os.path.join(os.path.dirname(K5.__file__), "csrc", "wls_lstsq.cu"))


def _const(name):
    """A ``constexpr int`` of the kernel source, which the model repeats."""
    with open(SRC) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read())
                   .group(1))


TILE, MAX_SWEEPS = _const("TILE"), _const("MAX_SWEEPS")


def _panel(T, R, j0, nb, k):
    """Reflectors j0..j0+nb-1 on the panel's columns (the kernel's
    ``panel_factor``): H = I - tau u u^T, u = [alpha e_j; t] with t the
    tile's column j left in place; returns the panel's Tw and alphas."""
    Tw, al = np.zeros((nb, nb)), np.zeros(nb)
    for jj in range(nb):
        j = j0 + jj
        e = T[:, j0:j0 + nb].T @ T[:, j]      # the fused reduction
        x0 = R[j, j]
        tau, beta, alpha = 0.0, x0, 0.0
        if j < k and e[jj] > 0.0:
            nrm = np.sqrt(x0 * x0 + e[jj])
            ax = abs(x0) + nrm
            beta, alpha = (-nrm, ax) if x0 >= 0.0 else (nrm, -ax)
            tau = 1.0 / (nrm * ax)
        R[j, j] = beta
        for l in range(jj + 1, nb):
            f = tau * (alpha * R[j, j0 + l] + e[l])
            T[:, j0 + l] -= f * T[:, j]
            R[j, j0 + l] -= f * alpha
        Tw[:jj, jj] = -tau * (Tw[:jj, :jj] @ e[:jj])
        Tw[jj, jj] = tau
        al[jj] = alpha
    return Tw, al


def _fold(T, R, k, nb):
    """Fold the tile T (its rows, kp columns) into R (the kernel's
    ``fold_tile``): per panel the WY block I - V Tw V^T, V = [diag(al); U],
    on the trailing columns."""
    kp = R.shape[1]
    for j0 in range(0, k, nb):
        Tw, al = _panel(T, R, j0, nb, k)
        c = slice(j0 + nb, kp if nb == 8 else k + 1)
        U = T[:, j0:j0 + nb]
        W = al[:, None] * R[j0:j0 + nb, c] + U.T @ T[:, c]
        W = Tw.T @ W
        R[j0:j0 + nb, c] -= al[:, None] * W
        T[:, c] -= U @ W


def _tiled_lstsq(Aw, rw, nb=8):
    """The kernels' steps for one point: ``(x, sv, norms, sweeps)``."""
    N, k = Aw.shape
    kp = (k + 8) // 8 * 8
    aug = np.concatenate([Aw, rw[:, None]], axis=1)
    R, sums, bad = np.zeros((kp, kp)), np.zeros(k), False
    for t0 in range(0, N, TILE):           # wls_tsqr_fold
        T = np.zeros((TILE, kp))
        tile = aug[t0:t0 + TILE]
        T[:len(tile), :k + 1] = tile
        bad |= not np.isfinite(tile).all()
        sums += (T[:, :k] ** 2).sum(axis=0)
        _fold(T, R, k, nb)
    norms = np.sqrt(sums)                  # wls_tsqr_svd
    norms = np.where(norms == 0, 1.0, norms)
    if bad:
        return np.full(k, np.nan), np.full(k, np.nan), norms, 0
    c = R[:k, k].copy()
    M = (R[:k, :k] / norms).T              # Jacobi on R^T: R's rows
    y = c.copy()                           # J^T c, rotated with M's columns
    kk = k + (k & 1)
    tol = EPS * np.sqrt(k)
    m = np.arange(kk // 2)
    converged, sweep = False, 0
    while sweep < MAX_SWEEPS and not converged:
        sweep += 1
        rotated = False
        for r in range(kk - 1):
            pa = np.where(m == 0, 0, 1 + (m - 1 + r) % (kk - 1))
            pb = 1 + (kk - 2 - m + r) % (kk - 1)
            keep = (pa < k) & (pb < k)
            pa, pb = pa[keep], pb[keep]
            u, v = M[:, pa], M[:, pb]
            al, bt, ga = (u * u).sum(0), (v * v).sum(0), (u * v).sum(0)
            rot = ga * ga > tol * tol * al * bt
            if not rot.any():
                continue
            rotated = True
            pa, pb, al, bt, ga = pa[rot], pb[rot], al[rot], bt[rot], ga[rot]
            d = bt - al
            t = np.where(d >= 0, 2.0 * ga, -2.0 * ga) / (
                np.abs(d) + np.sqrt(d * d + 4.0 * ga * ga))
            cs = 1.0 / np.sqrt(1.0 + t * t)
            sn = cs * t
            u, v = M[:, pa].copy(), M[:, pb].copy()
            M[:, pa] = cs * u - sn * v
            M[:, pb] = sn * u + cs * v
            u, v = y[pa].copy(), y[pb].copy()
            y[pa] = cs * u - sn * v
            y[pb] = sn * u + cs * v
        converged = not rotated
    sigma = np.sqrt((M * M).sum(0))      # M J = W: R D^-1 = J W^T
    coef = y
    cut = EPS * max(N, k) * sigma.max()
    keep = (sigma > 0) & (sigma >= cut)
    coef = np.where(keep, coef / np.where(keep, sigma, 1.0) ** 2, 0.0)
    x = M @ coef
    sv = -np.sort(-sigma)
    if not converged:
        x, sv = np.full(k, np.nan), np.full(k, np.nan)
    return x, sv, norms, sweep


def _system(rng, n, k, cond_n, colscale):
    q1, _ = np.linalg.qr(rng.normal(size=(n, k)))
    q2, _ = np.linalg.qr(rng.normal(size=(k, k)))
    A = (q1 * np.logspace(0, -np.log10(cond_n), k)) @ q2.T
    return A * np.logspace(0, colscale, k)[rng.permutation(k)]


def _reference(Aw, rw):
    norms = jnp.linalg.norm(Aw, axis=0)
    norms = jnp.where(norms == 0, 1.0, norms)
    x, _, _, sv = jnp.linalg.lstsq(Aw / norms, rw)
    return np.asarray(x), np.asarray(sv), np.asarray(norms)


@pytest.mark.parametrize("N,k,nb,nan_row", [
    (4005, 88, 8, -3),    # the path's shape: 32 tiles, the last of 37 rows,
    (4005, 88, 1, 0),     # the NaN there; the unblocked fold (nb=1), NaN in
    (1000, 233, 8, 500),  # the first; a dense-DMX width, odd k
    (301, 111, 8, -1),    # the tiled path's largest k, odd: 128, 128, 45
    (129, 24, 8, 128),    # a ragged tile of one row, the NaN in it
    (128, 9, 8, 64),      # exactly one tile, odd k past one WY block
    (50, 7, 8, 0),        # one partial tile, odd k under one WY block
    (700, 40, 1, -1),     # the unblocked fold over several tiles
])
def test_tiled_model_matches_reference_lstsq(N, k, nb, nan_row):
    rng = np.random.default_rng(N + k + nb)
    points = [_system(rng, N, k, 1e4, 6),    # raw condition ~1e10
              _system(rng, N, k, 1e2, 8),
              rng.normal(size=(N, k)),       # a zero column
              rng.normal(size=(N, k))]       # a NaN in one tile
    points[2][:, 5 % k] = 0.0
    points[3][nan_row, k // 2] = np.nan
    cut = EPS * max(N, k)
    for i, A in enumerate(points):
        rw = rng.normal(size=N)
        x, sv, norms, sweeps = _tiled_lstsq(A, rw, nb)
        xr, svr, nr = _reference(jnp.asarray(A), jnp.asarray(rw))
        if i == 3:
            assert np.isnan(x).all() and np.isnan(sv).all()
            assert np.isnan(svr).any()
            continue
        np.testing.assert_allclose(norms, nr, rtol=1e-13)
        assert 0 < sweeps < MAX_SWEEPS
        assert np.abs(x - xr).max() <= 1e-9 * np.abs(xr).max()
        assert np.abs(sv - svr).max() <= 1e-12 * svr[0]
        assert ((sv > 0) & (sv >= cut * sv[0])).sum() \
            == ((svr > 0) & (svr >= cut * svr[0])).sum()
        if i == 2:
            assert x[5 % k] == 0.0
            assert ((sv > 0) & (sv >= cut * sv[0])).sum() == k - 1


@pytest.mark.parametrize("N,k,nan_row", [(700, 24, 400), (128, 9, 127),
                                         (300, 111, 299)])
def test_stage_twins_compose_to_the_twin(N, k, nan_row):
    """The plain versions of the two tiled kernels, ``fold_reference`` and
    ``svd_reference`` (what ``chip_smoke.py`` holds each kernel to on the
    card), give the K5 twin's ``(x, sv, norms)`` at its bars, with a zero
    column and a NaN in one row."""
    import torch

    rng = np.random.default_rng(N + k)
    Aw = np.stack([_system(rng, N, k, 1e4, 6), rng.normal(size=(N, k)),
                   rng.normal(size=(N, k))])
    Aw[1, :, 5] = 0.0
    Aw[2, nan_row, 7] = np.nan
    rw = rng.normal(size=(3, N))
    At, rt = torch.tensor(Aw), torch.tensor(rw)
    ws = K5.fold_reference(At, rt)
    assert ws.shape == (3, k * (k + 1) + k + 1)
    assert ws[:, -1].tolist() == [0.0, 0.0, 1.0]
    x, sv, norms = (t.numpy() for t in K5.svd_reference(ws, N, k))
    xr, sr, nr = (t.numpy() for t in K5.wls_lstsq_reference(At, rt))
    np.testing.assert_allclose(norms[:2], nr[:2], rtol=1e-14)
    assert np.isnan(x[2]).all() and np.isnan(sv[2]).all()
    for i in range(2):
        assert np.abs(x[i] - xr[i]).max() <= 1e-9 * np.abs(xr[i]).max()
        assert np.abs(sv[i] - sr[i]).max() <= 1e-12 * sr[i][0]
    assert abs(x[1, 5]) <= 1e-10 * np.abs(x[1]).max()
