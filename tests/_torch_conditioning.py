"""How far the GLS uncertainties of a small stand-in move with rounding.

The port and the reference compute the same Gram products in different
summation orders (torch's CPU matmul against XLA's), so their fitted
uncertainties can differ by the system's condition number times the
rounding of those products.  This script measures that witness for a
stand-in shape: it builds the stand-in through the reference, runs the
reference's and the port's ``Fitter.auto`` fit from the snapshot, and
prints

- the port-vs-reference gap in the uncertainties (max |u/u_ref - 1|);
- at the port's fitted point, the condition number of the timing block
  of the GLS system (the Schur complement of the noise block, scaled to
  a unit diagonal), as the fitter forms it;
- how far the same uncertainties move within the port when only the
  summation order of the Gram products changes (the TOAs reversed), and
  when the Schur complement is factored in reversed parameter order.

Run from the repo root (CPU only)::

    python tests/_torch_conditioning.py ddk:80x4 ddk:80x2 dd:80x2
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (HERE, os.path.dirname(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import _torch_standin as standin  # noqa: E402

#: the stand-in of each model name, before its epoch and sub-band counts
BASE = {"ddk": standin.SMALL_DDK_SETTINGS,
        "dd": dict(standin.SMALL_SETTINGS, err_scale=0.25)}


def schur_errs(M, r, Nvec, phiinv, ntm, norm, reverse_toas=False,
               reverse_params=False):
    """The timing parameters' uncertainties as ``_schur_gls_solve`` forms
    them, with the TOAs' order (the Gram products' summation order) or
    the Schur complement's parameter order reversed; and the condition
    number of the unit-diagonal Schur complement."""
    import torch

    if reverse_toas:
        M, r, Nvec = M.flip(0), r.flip(0), Nvec.flip(0)
    W = 1.0 / Nvec
    M_t, M_u = M[:, :ntm], M[:, ntm:]
    WM_u = W[:, None] * M_u
    D = M_u.T @ WM_u + torch.diag(phiinv[ntm:])
    L_D = torch.linalg.cholesky(D)
    A = M_t.T @ (W[:, None] * M_t) + torch.diag(phiinv[:ntm])
    Y = torch.linalg.solve_triangular(L_D, (M_t.T @ WM_u).T, upper=False)
    S = A - Y.T @ Y
    d = torch.sqrt(torch.diagonal(S))
    ev = torch.linalg.eigvalsh(S / d[:, None] / d[None, :])
    kappa = float(ev.max() / ev.min())
    idx = torch.arange(ntm - 1, -1, -1) if reverse_params \
        else torch.arange(ntm)
    Sp = S[idx][:, idx]
    L = torch.linalg.cholesky(Sp)
    xvar = torch.cholesky_solve(torch.eye(ntm, dtype=S.dtype), L)
    var = torch.empty(ntm, dtype=S.dtype)
    var[idx] = torch.diagonal(xvar)
    return (torch.sqrt(var) / norm[:ntm]).numpy(), kappa


def witness(model_name: str, n_epochs: int, n_subbands: int) -> dict:
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import Fitter
    from pint_torch.gls_fitter import build_augmented_system

    s = dict(BASE[model_name], n_epochs=n_epochs, n_subbands=n_subbands)
    model, toas = standin.make_standin(s, full=False)
    snap = standin.export_snapshot(model, toas, s, grid=False)
    meta, arrays = read_snapshot(snap)
    rr = meta["reference"]
    m, b = load_snapshot(snap, device="cpu")
    f = Fitter.auto(b, m)
    f.fit_toas()
    design = rr["postfit_params"]
    unc = np.array([f.model[p].uncertainty for p in design])
    ref = arrays["ref/auto_uncertainties"]
    gap = np.abs(unc / ref - 1)
    M, params, norm, phiinv, Nvec, _ = build_augmented_system(f.model, b)
    r = f.resids.time_resids
    ntm = len(params)
    base, kappa = schur_errs(M, r, Nvec, phiinv, ntm, norm)
    toa_rev, _ = schur_errs(M, r, Nvec, phiinv, ntm, norm,
                            reverse_toas=True)
    par_rev, _ = schur_errs(M, r, Nvec, phiinv, ntm, norm,
                            reverse_params=True)
    return dict(stand_in=f"{model_name}:{n_epochs}x{n_subbands}",
                ntoas=int(b.ntoas), ntm=ntm, fitter=type(f).__name__,
                port_vs_reference=float(gap.max()),
                worst=design[int(gap.argmax())] if len(design) else None,
                kappa=kappa,
                toas_reversed=float(np.abs(toa_rev / base - 1).max()),
                params_reversed=float(np.abs(par_rev / base - 1).max()))


if __name__ == "__main__":
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for arg in sys.argv[1:] or ["ddk:80x4", "ddk:80x2", "dd:80x2"]:
        name, shape = arg.split(":")
        ne, ns = (int(v) for v in shape.split("x"))
        print(json.dumps(witness(name, ne, ns)), flush=True)
