#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pint_torch``) on one GPU and check it.

Run from the root of a checkout, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda)::

    python3 chip_smoke.py

Phases, one line each:

1. device -- the card's name and power limit (nvidia-smi) and its
   properties;
2. build -- the three hand kernels, one nvcc per source, started together;
   the ptxas report of each ``__global__`` (registers, stack frame, spill
   bytes; K1's per S = 1..6), read from the build logs: K1's primal
   templates must hold no stack frame and neither primal may spill;
3. main path b1855 -- the full-width B1855+09-shaped stand-in
   (``pint_torch/data/b1855_standin.npz``, nt = 88 at the grid): load onto
   the card, residuals, design matrix, ``GLSFitter.fit_toas(maxiter=2)``,
   then the 16x16 M2 x SINI GLS chi2 grid (``niter=1``, ``chunk=256``)
   twice, cold and warm.  Kernel launch counts are zeroed just before and
   read just after; every kernel of the path must have launched (K3 in its
   shared-memory instantiation);
4. bars b1855 -- that path's outputs against the reference package's
   outputs stored in the snapshot;
5. main path dmx15 and bars dmx15 -- the same for the dense-DMX stand-in
   (``pint_torch/data/b1855_dmx15_standin.npz``: 216 DMX windows, nt = 232,
   K3 in its global-memory instantiation), counts zeroed and read around
   it alone;
6. kernels -- each CUDA kernel (the primal and dual instantiations of K1
   and K2, K3's shared-memory instantiation at nt = 88 and its global one
   at nt = 232) against its plain PyTorch twin on the card, on the inputs
   its path gave it (captured there) plus seeded random inputs: K1 at
   S = 1, 2, 3 and 6 spin terms, k and f bitwise; K2 on random orbits with
   ECC 0-0.9 and in bands at ~2e-5, 0.1, 0.6 and 0.95 (the Kepler solve's
   exits -- fixed point, 2-cycle, all 15 steps -- counted per band by the
   twin's ``kepler_steps``, each must occur), delay bitwise, and two
   SINI > 1 rows whose NaN delays poison every partial; K3 with an
   ill-conditioned and a NaN point.  K2's Newton steps on the path's
   inputs (per element, and the most in each warp) set its operation
   count, and its bound is printed at those counts and at 15 steps.
   CUDA-event times of kernel, twin and, for K3, the library Cholesky,
   with the launches queued behind a spin kernel so that the events time
   the device and not the host's launch rate.  Launch counts, times and
   errors in the ``kernels`` line are per instantiation, launches from the
   path whose shapes the record was measured at.

The whole run's wall time is printed before the JSON lines.  The line
before the last is one JSON object with every kernel's record, then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failed phase or bar exits non-zero without the ok line; so does a
machine without a GPU, or a directory that holds this script without the
``pint_torch`` package.
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

#: float64 operations per element of ``dd_binary.cu``, counted from the
#: source with a sine, cosine, arctangent, logarithm or square root counted
#: as 20 and any other operation as 1: ``dd_forward`` (both
#: instantiations) 403 outside Kepler's equation plus 49 per Newton step
#: (1138 at the reference's fixed 15 steps; the kernel stops once the
#: iterate repeats, and the two integer comparisons of its exit test are
#: not counted); ``dd_reverse`` (the dual instantiation's partials) 242
#: more.
K2_FORWARD_OPS = 403
K2_NEWTON_OPS = 49
K2_REVERSE_OPS = 242


def _k2_ops(steps: float, partials: bool) -> float:
    """float64 operations per element of ``dd_binary.cu`` at a mean of
    ``steps`` Newton steps per element."""
    return (K2_FORWARD_OPS + K2_NEWTON_OPS * steps
            + (K2_REVERSE_OPS if partials else 0))


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
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel that holds the stream until the host has
    queued them all, so that a kernel shorter than its launch's host cost
    is timed back to back and not at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 1000)  # ~2 GHz clock
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


def _drive(label, path, kernels, tag):
    """One main path on one snapshot: counts zeroed just before, read just
    after; returns (counts, capture, outputs)."""
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.residuals import Residuals

    meta, ref = read_snapshot(path)
    cap = Capture(kernels.modules())
    cap.install()
    kernels.reset_counts()
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return out

    model, batch = stage("load", lambda: load_snapshot(path, device="cuda"))
    resid = stage("residuals", lambda: Residuals(batch, model).time_resids)
    M, _ = stage("designmatrix", lambda: model.designmatrix(batch))
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
    nt = 1 + len(fitter.model.free_params) - 2
    print(f"phase main path {label}: N={batch.ntoas} TOAs, "
          f"{len(model.free_params)} free, nt={nt}; "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items())
          + f"; warm grid {surface.size / stages['grid_warm']:.2f} fits/s; "
          f"launches {counts} {tag}", flush=True)
    return counts, cap, dict(meta=meta, ref=ref, resid=resid, M=M,
                             fitter=fitter, chi2=chi2_fit, surface=surface)


def _bars(label, out):
    """The path's outputs against the reference outputs in its snapshot;
    raises on a failed bar."""
    import numpy as np

    meta, ref, fitter = out["meta"], out["ref"], out["fitter"]
    rref = meta["reference"]
    d_res = float(np.abs(out["resid"].cpu().numpy()
                         - ref["ref/time_resids"]).max())
    Mr = ref["ref/designmatrix"]
    d_M = float((np.abs(out["M"].cpu().numpy() - Mr).max(0)
                 / np.maximum(np.abs(Mr).max(0), 1e-300)).max())
    vals = np.array([fitter.model.value(p) for p in rref["postfit_params"]])
    uncs = np.array([fitter.model[p].uncertainty
                     for p in rref["postfit_params"]])
    d_val = float(np.abs((vals - ref["ref/postfit_values"])
                         / ref["ref/postfit_uncertainties"]).max())
    d_unc = float(np.abs(uncs / ref["ref/postfit_uncertainties"] - 1).max())
    d_chi2 = abs(out["chi2"] / rref["postfit_chi2"] - 1)
    surface = out["surface"]
    d_grid = float(np.abs(surface / ref["ref/grid_chi2"] - 1).max())
    argmin = [int(i) for i in np.unravel_index(int(np.nanargmin(surface)),
                                               surface.shape)]
    rungs = fitter.last_grid_diagnostics["ladder_rung"]
    print(f"phase bars {label}: residuals max|d| {d_res:.3e} s (<= 1e-10); "
          f"design matrix max col-rel {d_M:.3e}; post-fit chi2 "
          f"{out['chi2']:.6f} rel {d_chi2:.3e} (<= 1e-6); values max "
          f"{d_val:.3e} sigma (<= 1e-2); uncertainties rel {d_unc:.3e}; grid "
          f"max rel {d_grid:.3e} (<= 1e-6); argmin {argmin} vs "
          f"{rref['grid_argmin']}; rungs "
          f"{sorted(set(rungs.ravel().tolist()))}", flush=True)
    for ok, what in ((d_res <= 1e-10, "residuals"), (d_chi2 <= 1e-6, "chi2"),
                     (d_val <= 1e-2, "post-fit values"),
                     (d_grid <= 1e-6, "grid surface"),
                     (argmin == rref["grid_argmin"], "grid argmin")):
        if not ok:
            raise RuntimeError(f"bar failed ({label}): {what}")


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a GPU")
    if not (HERE / "pint_torch" / "__init__.py").is_file():
        _fail(f"the pint_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE))

    from pint_torch import kernels
    from pint_torch.bridge import DMX15_PATH, STANDIN_PATH
    from pint_torch.kernels import _build
    from pint_torch.kernels import dd_binary as K2
    from pint_torch.kernels import schur_cholesky_solve as K3
    from pint_torch.kernels import spin_phase as K1

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
    ptxas = [("spin_phase", f"{K1.KERNELS[p]}<{S}>",
              f"{K1.KERNELS[p]}ILi{S}E")
             for p in (False, True) for S in range(1, 7)]
    ptxas += [("dd_binary", K2.KERNELS[False], K2.KERNELS[False]),
              ("dd_binary", K2.KERNELS[True], K2.KERNELS[True]),
              ("schur_cholesky_solve", K3.KERNELS[False],
               "schur_cholesky_kernelILb1E"),
              ("schur_cholesky_solve", K3.KERNELS[True],
               "schur_cholesky_kernelILb0E")]
    for src, kernel, marker in ptxas:
        log = _build.library_path(src).with_suffix(".log")
        r = _build.ptxas_report(log.read_text() if log.exists() else "",
                                marker)
        print(f"phase ptxas {kernel}: " + (
            f"{r[0]} registers, {r[1]} bytes stack frame, {r[2]} bytes spill "
            f"stores, {r[3]} bytes spill loads" if r else "not in the build "
            "log"), flush=True)
        # K1's primal templates keep no stack frame; neither primal spills
        k1_primal = kernel.startswith(K1.KERNELS[False])
        primal = k1_primal or kernel == K2.KERNELS[False]
        if r is None or (k1_primal and r[1]) or (primal and (r[2] or r[3])):
            raise RuntimeError(f"ptxas: no report for {kernel}, or a stack "
                               "frame or spills that it must not have")

    # ---- main paths: each with its counts zeroed just before it ------------
    paths = {}
    path_kernels = {
        "b1855": (*K1.KERNELS.values(), *K2.KERNELS.values(),
                  K3.KERNELS[False]),
        "dmx15": (*K1.KERNELS.values(), *K2.KERNELS.values(),
                  K3.KERNELS[True])}
    for label, path in (("b1855", STANDIN_PATH), ("dmx15", DMX15_PATH)):
        counts, cap, out = _drive(label, path, kernels, tag)
        missing = [k for k in path_kernels[label] if counts[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {label} main "
                               f"path: {missing}")
        _bars(label, out)
        paths[label] = (counts, cap)
        del out

    # ---- kernels against their plain twins ----------------------------------
    # Every CUDA kernel -- the primal and dual instantiations of K1 and K2,
    # K3's two -- runs on its path's largest call of it (captured there)
    # and on seeded random inputs, against its twin on the same tensors.
    gen = torch.Generator(device=dev).manual_seed(20260729)
    records = []
    counts, cap = paths["b1855"]

    def rt(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, generator=gen, dtype=torch.float64,
                          device=dev) * (hi - lo) + lo

    def p_rel(Pk, Pr):
        return float(((Pk - Pr).abs().amax(dim=(0, 1))
                      / Pr.abs().amax(dim=(0, 1)).clamp(min=1e-300)).max())

    def record(kernel, source, replaces, err, ms, plain, bound, library=None,
               path="b1855"):
        records.append(dict(name=kernel, route="cuda",
                            source=f"pint_torch/kernels/csrc/{source}",
                            replaces=replaces,
                            launches=paths[path][0][kernel],
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bound[0], bound_by=bound[1],
                            library_ms=library, path=path))

    # K1: its path's inputs, then seeded random inputs within the fold's
    # static bounds |F0| < 2**12 and |t| < 2**35 s at S = 1, 2, 3 and 6 spin
    # terms, so that every template runs; k and f bitwise
    tdb0 = cap.args("spin_phase", True)[2]
    Bn, Nn = 64, 20000

    def rand1(S):
        F = [rt(Bn, lo=1.0, hi=4000.0), rt(Bn, lo=-1e-13, hi=0.0)]
        F += [rt(Bn) * 10.0 ** (-3 - 11 * i) for i in range(2, S)]
        return (torch.round(rt(Nn, lo=-2.0**34, hi=2.0**34)),
                rt(Nn, lo=-1e-6, hi=1e-6), tdb0,
                torch.stack([tdb0 + rt(Bn, lo=-3000.0, hi=3000.0),
                             rt(Bn, lo=-1e-11, hi=1e-11)], dim=1),
                rt(Bn, Nn, lo=-600.0, hi=600.0),
                torch.stack(F[:S], dim=1), True)

    rand1s = {S: rand1(S) for S in (1, 2, 3, 6)}
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
        err_r = {}
        for S, args in rand1s.items():
            kk, fk, Pk = K1._launch(*args, partials)
            kr, fr, Pr = K1.spin_phase_reference(*args, partials)
            k_eq = k_eq and bool(torch.equal(kk, kr))
            err_r[S] = float((fk - fr).abs().max())
            if partials:
                prel = max(prel, p_rel(Pk, Pr))
        B1, N1, S1 = dl.shape[0], dl.shape[1], F.shape[1]
        ms = _time_ms(lambda: K1._launch(*a1), 50)
        plain = _time_ms(twin1, 5)
        lanes = S1 + 2 if partials else 0
        bound = _bound(16 * N1 + 8 * B1 * (2 + S1)
                       + 8 * B1 * N1 * (1 + 2 + lanes),
                       B1 * N1 * _k1_ops(S1, has_pe, partials))
        print(f"phase kernel {kernel}: B={B1} N={N1} S={S1} k equal {k_eq}; "
              f"max|df| {err:.3e}, random S=1,2,3,6 "
              f"{', '.join(f'{v:.3e}' for v in err_r.values())} cycles "
              f"(= 0); "
              + (f"partials max rel {prel:.3e} (<= 1e-10); " if partials
                 else "")
              + f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) {tag}", flush=True)
        err = max(err, *err_r.values())
        if not (k_eq and err == 0.0 and prel <= 1e-10):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "spin_phase.cu", K1.REPLACES, err, ms, plain, bound)

    # K2: random orbits -- ECC 0 to 0.9 and bands at ~2e-5, 0.1, 0.6 and
    # 0.95, any OM, SINI 0.5-0.999, so that both exits of the Kepler solve
    # (fixed point, 2-cycle) and the full 15 steps run on the card -- plus
    # two rows with SINI > 1 whose NaN delays must poison every partial;
    # the delay bitwise everywhere
    tt0_main = cap.args("dd_binary", True)[0]
    bands = ((0.0, 0.9), (1.5e-5, 2.5e-5), (0.09, 0.11), (0.59, 0.61),
             (0.94, 0.96))
    nb = 32
    rparams = cap.args("dd_binary", True)[1][:1].expand(
        nb * len(bands), -1).clone()
    for i, (lo, hi) in enumerate(bands):
        rparams[i * nb:(i + 1) * nb, 5] = rt(nb, lo=lo, hi=hi)
    rparams[:, 7] = rt(len(rparams), lo=0.0, hi=360.0)
    rparams[:, 8] = rt(len(rparams), lo=0.0, hi=0.05)
    rparams[:, 10] = rt(len(rparams), lo=0.5, hi=0.999)
    rparams[-2:, 10] = 1.5
    rtt = rt(len(rparams), tt0_main.shape[1], lo=-3e8, hi=3e8)
    _, _, kind = K2.kepler_steps(rtt, rparams)
    exits = [torch.bincount(kind[i * nb:(i + 1) * nb].flatten(),
                            minlength=3).tolist() for i in range(len(bands))]
    print("phase kepler exits on the random orbits, per ECC band "
          + ", ".join(f"{lo:g}-{hi:g} {dict(zip(K2.KEPLER_EXITS, n))}"
                      for (lo, hi), n in zip(bands, exits)), flush=True)
    if not all(sum(n[k] for n in exits) for k in range(3)):
        raise RuntimeError("the random orbits miss an exit of the Kepler "
                           "solve")

    def warp_max_mean(steps, rows: bool) -> float:
        """Mean over warps of the most Newton steps in a warp: 32
        consecutive TOAs of one row (the primal's 2-D grid) or of the
        flattened (B, N) (the dual's 1-D grid)."""
        x = steps if rows else steps.reshape(1, -1)
        pad = (-x.shape[1]) % 32
        x = torch.nn.functional.pad(x, (0, pad))
        return float(x.reshape(x.shape[0], -1, 32).amax(-1).double().mean())

    for partials in (False, True):
        kernel = K2.KERNELS[partials]
        a2 = cap.args("dd_binary", partials)
        tt0, params, _ = a2

        def twin2():
            return K2.dd_binary_reference(tt0, params, partials)

        dk, Pk = K2._launch(*a2)
        dr, Pr = twin2()
        err = float((dk - dr).abs().max())
        same = bool(torch.equal(dk, dr))
        prel = p_rel(Pk, Pr) if partials else 0.0
        dk, Pk = K2._launch(rtt, rparams, partials)
        dr, Pr = K2.dd_binary_reference(rtt, rparams, partials)
        nan_k, nan_r = torch.isnan(dk), torch.isnan(dr)
        nan_ok = bool(torch.equal(nan_k, nan_r)) and bool(nan_k.any())
        fin = ~nan_r
        err_r = float((dk[fin] - dr[fin]).abs().max())
        same = same and bool(torch.equal(dk[fin], dr[fin]))
        if partials:
            nan_ok = nan_ok and bool(torch.isnan(Pk[nan_k]).all())
            prel = max(prel, p_rel(Pk[:-2], Pr[:-2]))
        B2, N2 = tt0.shape
        _, steps, _ = K2.kepler_steps(tt0, params)
        st_elem = float(steps.double().mean())
        st_warp = warp_max_mean(steps, rows=not partials)
        ms = _time_ms(lambda: K2._launch(*a2), 20)
        plain = _time_ms(twin2, 3)
        nbytes = 8 * B2 * N2 + 8 * B2 * 16 \
            + 8 * B2 * N2 * (1 + (K2.NPARTIAL if partials else 0))
        bound = _bound(nbytes, B2 * N2 * _k2_ops(st_elem, partials))
        b_warp = _bound(nbytes, B2 * N2 * _k2_ops(st_warp, partials))
        b_15 = _bound(nbytes, B2 * N2 * _k2_ops(15, partials))
        print(f"phase kernel {kernel}: B={B2} N={N2}; delay bitwise {same}, "
              f"max|d delay| {err:.3e} (random {err_r:.3e}) s (= 0); "
              f"NaN rows (SINI > 1) equal and poisoning {nan_ok}; "
              + (f"partials max rel {prel:.3e} (<= 1e-10); " if partials
                 else "")
              + f"Newton steps per element {st_elem:.4f}, per warp (most "
              f"in the warp) {st_warp:.4f}, of 15; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
              f"{_k2_ops(st_elem, partials):.1f} ops/element at the steps "
              f"each element needs); at the warps' steps {b_warp[0]:.4f} ms "
              f"({b_warp[1]}, {_k2_ops(st_warp, partials):.1f}); at 15 "
              f"steps {b_15[0]:.4f} ms ({b_15[1]}, "
              f"{_k2_ops(15, partials):.0f}) {tag}", flush=True)
        if not (same and prel <= 1e-10 and nan_ok):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "dd_binary.cu", K2.REPLACES, max(err, err_r), ms,
               plain, bound)

    # K3 at each path's Schur systems plus an ill-conditioned and a NaN point
    for path, regime in (("b1855", False), ("dmx15", True)):
        kernel = K3.KERNELS[regime]
        Ar, rhs, ridge = paths[path][1].args("schur_cholesky_solve")
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
            Ar.clone(), rhs.clone(), ridge), 2)
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
        print(f"phase kernel {kernel}: B={B3} nt={nt} (+1 ill-conditioned, "
              f"+1 NaN point); ok flags equal {same_ok}, NaN equal "
              f"{nan_same}; x max rel {rel3:.3e} (<= 1e-9), max|dx| "
              f"{err3:.3e}; kernel {ms3:.4f} ms, plain {plain3:.4f} ms, "
              f"library cholesky_ex+cholesky_solve {lib3:.4f} ms, bound "
              f"{bnd3[0]:.4f} ms ({bnd3[1]}) {tag}", flush=True)
        if not (same_ok and nan_same and rel3 <= 1e-9 and not bool(okk[-1])):
            raise RuntimeError(f"{kernel} disagrees with its plain version")
        record(kernel, "schur_cholesky_solve.cu", K3.REPLACES, err3, ms3,
               plain3, bnd3, lib3, path=path)

    print(f"phase wall: {time.perf_counter() - t_start:.2f} s for the whole "
          f"run {tag}", flush=True)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
