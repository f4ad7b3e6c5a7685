#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pint_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda)::

    python3 chip_smoke.py

Phases, one line each:

1. device -- the card's name and power limit (nvidia-smi) and its
   properties;
2. build -- the three hand kernels, one nvcc per source, started together;
3. main path -- the full-width B1855+09-shaped stand-in
   (``pint_torch/data/b1855_standin.npz``): load onto the card, residuals,
   design matrix, ``GLSFitter.fit_toas(maxiter=2)``, then the 16x16
   M2 x SINI GLS chi2 grid (``niter=1``, ``chunk=256``) twice, cold and
   warm.  Kernel launch counts are zeroed just before and read just after;
   every kernel must have launched;
4. bars -- the main path's outputs against the reference package's
   outputs stored in the snapshot;
5. kernels -- each CUDA kernel (the primal and dual instantiations of K1
   and K2 apart) against its plain PyTorch twin on the card, on the inputs
   the main path gave it (captured there) plus seeded random inputs, with
   CUDA-event times of kernel, twin and, for K3, the library Cholesky.
   Launch counts, times and errors in the ``kernels`` line are per
   instantiation.

The line before the last is one JSON object with every kernel's record,
then the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed phase or bar exits non-zero
without the ok line; so does a machine without a GPU, or a directory that
holds this script without the ``pint_torch`` package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the float64 rate
#: of the CUDA cores (the kernels use no tensor cores)
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12

#: float64 operations per element of ``dd_binary.cu``'s ``dd_delay_math``,
#: counted from the source with a sine, cosine, arctangent, logarithm or
#: square root counted as 20 and any other operation as 1: 1144 for the
#: primal, 735 of them in the 15 Newton steps.  The dual instantiation adds
#: 446 for each of its 17 lanes (a Dual product or quotient 3, a sum 1, an
#: elementary function 1 to 4).
K2_PRIMAL_OPS = 1144
K2_LANE_OPS = 446


def _k1_ops(S: int, has_pe: bool, partials: bool) -> int:
    """float64 operations per element of ``spin_phase.cu``'s
    ``spin_phase_math``, counted from the source.  Each fold costs 31 on
    plain doubles: 28 in ``mul_mod1_impl`` (two scaled splits of 4, three
    folded products of 5, the last product 2 and its carry 3) and 3 to
    gather it.  The dual instantiation keeps the folds on doubles and adds,
    for each of its S + 2 lanes, 5 per fold (the custom JVP t*dc + c*dt and
    the two gathers), 3 per Dual product and 1 per sum.  The Horner loop's
    factorials are not counted."""
    nf = 3 if has_pe else 1
    primal = 31 * nf + 7      # folds; tail; dt + tail, F0*tail into f; round
    lanes = 5 * nf + 6
    if has_pe:
        primal += 11          # PEPOCH - tdb0, day2sec, negations, PEPOCH lo
        lanes += 3
    if S > 1:
        primal += 3 * (S - 1) + 3     # Horner, then acc*dt*dt into f
        lanes += 5 * (S - 1) + 7
    return primal + (S + 2) * lanes if partials else primal


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Spy on each kernel module's ``_launch``: keeps a copy of the largest
    call's inputs per (kernel, partials) so the comparisons run at the main
    path's shapes.  Counting stays in the original ``_launch``."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = {}
        self._orig = {}

    def install(self):
        for name, mod in self.kernels.items():
            orig = mod._launch
            self._orig[name] = orig

            def spy(*args, _orig=orig, _name=name):
                self._record(_name, args)
                return _orig(*args)

            mod._launch = spy

    def remove(self):
        for name, mod in self.kernels.items():
            mod._launch = self._orig[name]

    def _record(self, name, args):
        import torch

        partials = args[-1] if name != "schur_cholesky_solve" else None
        size = sum(a.numel() for a in args if torch.is_tensor(a))
        key = (name, partials)
        if key not in self.calls or self.calls[key][0] < size:
            self.calls[key] = (size, tuple(a.clone() if torch.is_tensor(a)
                                           else a for a in args))

    def args(self, name, partials=None):
        return self.calls[(name, partials)][1]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F64_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def main() -> int:
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not (HERE / "pint_torch" / "__init__.py").is_file():
        _fail(f"the pint_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE))
    import numpy as np

    from pint_torch import kernels
    from pint_torch.bridge import STANDIN_PATH, load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.kernels import dd_binary as K2
    from pint_torch.kernels import schur_cholesky_solve as K3
    from pint_torch.kernels import spin_phase as K1
    from pint_torch.residuals import Residuals

    dev = torch.device("cuda")
    card = _card()
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    tag = f"[{card}]"
    print(f"phase device: {card}; {name}, {props.multi_processor_count} SMs, "
          f"{props.total_memory / 2**30:.1f} GiB, cc {props.major}."
          f"{props.minor}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    build_s = kernels.build_all()
    print(f"phase build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(build_s)} kernels in parallel "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in build_s.items())})",
          flush=True)

    # ---- main path ---------------------------------------------------------
    meta, ref = read_snapshot(STANDIN_PATH)
    cap = Capture(kernels.modules())
    cap.install()
    kernels.reset_counts()
    stages = {}

    def stage(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[label] = time.perf_counter() - t
        return out

    model, batch = stage("load", lambda: load_snapshot(STANDIN_PATH,
                                                       device="cuda"))
    resid = stage("residuals", lambda: Residuals(batch, model).time_resids)
    M, names = stage("designmatrix", lambda: model.designmatrix(batch))
    stage("designmatrix_warm", lambda: model.designmatrix(batch))
    fitter = GLSFitter(batch, model)
    chi2_fit = stage("fit", lambda: fitter.fit_toas(maxiter=2))
    axes = (ref["ref/grid_m2"], ref["ref/grid_sini"])
    stage("grid_cold", lambda: grid_chisq(fitter, ("M2", "SINI"), axes,
                                          niter=1, chunk=256))
    surface, _ = stage("grid_warm", lambda: grid_chisq(
        fitter, ("M2", "SINI"), axes, niter=1, chunk=256))
    counts = kernels.launch_counts()
    cap.remove()
    npts = surface.size
    print(f"phase main path: N={batch.ntoas} TOAs, {len(model.free_params)} "
          f"free, nt={1 + len(fitter.model.free_params) - 2}; "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items())
          + f"; warm grid {npts / stages['grid_warm']:.2f} fits/s; "
          f"launches {counts} {tag}", flush=True)
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")

    # ---- bars against the reference package's outputs ----------------------
    rref = meta["reference"]
    d_res = float(np.abs(resid.cpu().numpy() - ref["ref/time_resids"]).max())
    Mr = ref["ref/designmatrix"]
    d_M = float((np.abs(M.cpu().numpy() - Mr).max(0)
                 / np.maximum(np.abs(Mr).max(0), 1e-300)).max())
    vals = np.array([fitter.model.value(p) for p in rref["postfit_params"]])
    uncs = np.array([fitter.model[p].uncertainty
                     for p in rref["postfit_params"]])
    d_val = float(np.abs((vals - ref["ref/postfit_values"])
                         / ref["ref/postfit_uncertainties"]).max())
    d_unc = float(np.abs(uncs / ref["ref/postfit_uncertainties"] - 1).max())
    d_chi2 = abs(chi2_fit / rref["postfit_chi2"] - 1)
    d_grid = float(np.abs(surface / ref["ref/grid_chi2"] - 1).max())
    argmin = [int(i) for i in np.unravel_index(int(np.nanargmin(surface)),
                                               surface.shape)]
    rungs = fitter.last_grid_diagnostics["ladder_rung"]
    print(f"phase bars: residuals max|d| {d_res:.3e} s (<= 1e-10); design "
          f"matrix max col-rel {d_M:.3e}; post-fit chi2 {chi2_fit:.6f} rel "
          f"{d_chi2:.3e} (<= 1e-6); values max {d_val:.3e} sigma (<= 1e-2); "
          f"uncertainties rel {d_unc:.3e}; grid max rel {d_grid:.3e} "
          f"(<= 1e-6); argmin {argmin} vs {rref['grid_argmin']}; rungs "
          f"{sorted(set(rungs.ravel().tolist()))}", flush=True)
    for ok, what in ((d_res <= 1e-10, "residuals"), (d_chi2 <= 1e-6, "chi2"),
                     (d_val <= 1e-2, "post-fit values"),
                     (d_grid <= 1e-6, "grid surface"),
                     (argmin == rref["grid_argmin"], "grid argmin")):
        if not ok:
            raise RuntimeError(f"bar failed: {what}")

    # ---- kernels against their plain twins ----------------------------------
    # Every CUDA kernel -- the primal and dual instantiations of K1 and K2
    # apart -- runs on the main path's largest call of it (captured there)
    # and on seeded random inputs, against its twin on the same tensors.
    gen = torch.Generator(device=dev).manual_seed(20260729)
    records = []

    def rt(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, generator=gen, dtype=torch.float64,
                          device=dev) * (hi - lo) + lo

    def p_rel(Pk, Pr):
        return float(((Pk - Pr).abs().amax(dim=(0, 1))
                      / Pr.abs().amax(dim=(0, 1)).clamp(min=1e-300)).max())

    def record(kernel, source, replaces, err, ms, plain, bound, library=None):
        records.append(dict(name=kernel, route="cuda",
                            source=f"pint_torch/kernels/csrc/{source}",
                            replaces=replaces, launches=counts[kernel],
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bound[0], bound_by=bound[1],
                            library_ms=library))

    # K1: random inputs within the fold's static bounds |F0| < 2**12 and
    # |t| < 2**35 s
    tdb0 = cap.args("spin_phase", True)[2]
    Bn, Nn = 64, 20000
    rand1 = (torch.round(rt(Nn, lo=-2.0**34, hi=2.0**34)),
             rt(Nn, lo=-1e-6, hi=1e-6), tdb0,
             torch.stack([tdb0 + rt(Bn, lo=-3000.0, hi=3000.0),
                          rt(Bn, lo=-1e-11, hi=1e-11)], dim=1),
             rt(Bn, Nn, lo=-600.0, hi=600.0),
             torch.stack([rt(Bn, lo=1.0, hi=4000.0),
                          rt(Bn, lo=-1e-13, hi=0.0)], dim=1), True)
    for partials in (False, True):
        kernel = K1.KERNELS[partials]
        a1 = cap.args("spin_phase", partials)
        th, tl, _, pe, dl, F, has_pe, _ = a1

        def twin1():
            return K1.spin_phase_reference(th, tl, tdb0, pe, dl, F, has_pe,
                                           partials)

        kk, fk, Pk = K1._launch(*a1)
        kr, fr, Pr = twin1()
        k_eq = bool(torch.equal(kk, kr))
        err = float((fk - fr).abs().max())
        prel = p_rel(Pk, Pr) if partials else 0.0
        kk, fk, _ = K1._launch(*rand1, partials)
        kr, fr, _ = K1.spin_phase_reference(*rand1, partials)
        k_eq = k_eq and bool(torch.equal(kk, kr))
        err_r = float((fk - fr).abs().max())
        B1, N1, S1 = dl.shape[0], dl.shape[1], F.shape[1]
        ms = _time_ms(lambda: K1._launch(*a1), 50)
        plain = _time_ms(twin1, 5)
        lanes = S1 + 2 if partials else 0
        bound = _bound(16 * N1 + 8 * B1 * (2 + S1)
                       + 8 * B1 * N1 * (1 + 2 + lanes),
                       B1 * N1 * _k1_ops(S1, has_pe, partials))
        print(f"phase kernel {kernel}: B={B1} N={N1} S={S1} k equal {k_eq}; "
              f"max|df| {err:.3e} (random {err_r:.3e}) cycles (<= 1e-12); "
              + (f"partials max rel {prel:.3e} (<= 1e-10); " if partials
                 else "")
              + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) {tag}", flush=True)
        if not (k_eq and err <= 1e-12 and err_r <= 1e-12 and prel <= 1e-10):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "spin_phase.cu", K1.REPLACES, max(err, err_r), ms,
               plain, bound)

    # K2: random orbits (ECC up to 0.7, any OM, SINI 0.5-0.999)
    tt0_main = cap.args("dd_binary", True)[0]
    rparams = cap.args("dd_binary", True)[1][:1].expand(32, -1).clone()
    rparams[:, 5] = rt(32, lo=0.0, hi=0.7)
    rparams[:, 7] = rt(32, lo=0.0, hi=360.0)
    rparams[:, 10] = rt(32, lo=0.5, hi=0.999)
    rtt = rt(32, tt0_main.shape[1], lo=-3e8, hi=3e8)
    for partials in (False, True):
        kernel = K2.KERNELS[partials]
        a2 = cap.args("dd_binary", partials)
        tt0, params, _ = a2

        def twin2():
            return K2.dd_binary_reference(tt0, params, partials)

        dk, Pk = K2._launch(*a2)
        dr, Pr = twin2()
        err = float((dk - dr).abs().max())
        prel = p_rel(Pk, Pr) if partials else 0.0
        dk, Pk = K2._launch(rtt, rparams, partials)
        dr, Pr = K2.dd_binary_reference(rtt, rparams, partials)
        err_r = float((dk - dr).abs().max())
        if partials:
            prel = max(prel, p_rel(Pk, Pr))
        B2, N2 = tt0.shape
        ms = _time_ms(lambda: K2._launch(*a2), 20)
        plain = _time_ms(twin2, 3)
        lanes = K2.NPARTIAL if partials else 0
        bound = _bound(8 * B2 * N2 + 8 * B2 * 16 + 8 * B2 * N2 * (1 + lanes),
                       B2 * N2 * (K2_PRIMAL_OPS + lanes * K2_LANE_OPS))
        print(f"phase kernel {kernel}: B={B2} N={N2}; max|d delay| "
              f"{err:.3e} (random {err_r:.3e}) s (<= 1e-14); "
              + (f"partials max rel {prel:.3e} (<= 1e-10); " if partials
                 else "")
              + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) {tag}", flush=True)
        if not (err <= 1e-14 and err_r <= 1e-14 and prel <= 1e-10):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "dd_binary.cu", K2.REPLACES, max(err, err_r), ms,
               plain, bound)

    # K3 on the grid's Schur systems plus an ill-conditioned and a NaN point
    Ar, rhs, ridge = cap.args("schur_cholesky_solve")
    B3, nt = rhs.shape
    q, _ = torch.linalg.qr(rt(nt, nt))
    ill = (q * torch.logspace(0, -13, nt, dtype=torch.float64,
                              device=dev)) @ q.T
    nanpt = Ar[0].clone()
    nanpt[3, 5] = nanpt[5, 3] = float("nan")
    Ar_x = torch.cat([Ar, ill[None], nanpt[None]])
    rhs_x = torch.cat([rhs, rt(1, nt), rhs[:1]])
    xk, okk, ck = K3._launch(Ar_x, rhs_x, ridge)
    xr, okr, cr = K3.schur_cholesky_solve_reference(Ar_x.clone(),
                                                    rhs_x.clone(), ridge)
    same_ok = bool(torch.equal(okk, okr))
    both = okk & okr
    scale = xr[both].abs().amax(dim=1).clamp(min=1e-300)
    rel3 = float(((xk[both] - xr[both]).abs().amax(dim=1) / scale).max())
    err3 = float((xk[both] - xr[both]).abs().max())
    nan_same = bool(torch.equal(torch.isnan(xk), torch.isnan(xr)))
    ms3 = _time_ms(lambda: K3._launch(Ar, rhs, ridge), 20)
    plain3 = _time_ms(lambda: K3.schur_cholesky_solve_reference(
        Ar.clone(), rhs.clone(), ridge), 3)
    d = torch.diagonal(Ar, dim1=-2, dim2=-1)
    an = torch.sqrt(torch.clamp(d, min=1e-300))
    Arn = Ar / (an[:, :, None] * an[:, None, :]) \
        + ridge * torch.eye(nt, dtype=torch.float64, device=dev)
    bn = (rhs / an)[:, :, None]

    def library():
        L, _ = torch.linalg.cholesky_ex(Arn)
        return torch.cholesky_solve(bn, L)

    lib3 = _time_ms(library, 20)
    bnd3 = _bound(8 * B3 * (nt * nt + nt) + B3 * (8 * nt + 9),
                  B3 * (nt**3 / 3 + 4 * nt * nt))
    print(f"phase kernel schur_cholesky_solve: B={B3} nt={nt} (+1 "
          f"ill-conditioned, +1 NaN point); ok flags equal {same_ok}, NaN "
          f"equal {nan_same}; x max rel {rel3:.3e} (<= 1e-9), max|dx| "
          f"{err3:.3e}; kernel {ms3:.4f} ms, plain {plain3:.4f} ms, library "
          f"cholesky_ex+cholesky_solve {lib3:.4f} ms, bound {bnd3[0]:.4f} ms "
          f"({bnd3[1]}) {tag}", flush=True)
    if not (same_ok and nan_same and rel3 <= 1e-9 and not bool(okk[-1])):
        raise RuntimeError("schur_cholesky_solve disagrees with its plain "
                           "version")
    record("schur_cholesky_solve", "schur_cholesky_solve.cu", K3.REPLACES,
           err3, ms3, plain3, bnd3, lib3)

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
