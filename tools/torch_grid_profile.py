#!/usr/bin/env python3
"""Where the port's time goes on the GPU, for the committed stand-ins.

Loads a committed stand-in onto the card (``b1855``:
``pint_torch/data/b1855_standin.npz``; ``dmx15``: its dense-DMX sibling
``b1855_dmx15_standin.npz``; ``ell1``: the J1909-3744-shaped WLS stand-in
``j1909_ell1_standin.npz``; ``ell1h``: its BinaryELL1H sibling
``j1909_ell1h_standin.npz``; ``ngc``, ``ngc_phoff``: the NGC6440E-shaped
ones ``ngc6440e_standin.npz``, ``ngc6440e_phoff_standin.npz``; ``ddk``: the
J1713+0747-shaped DDK GLS stand-in ``j1713_ddk_standin.npz``; ``ddgr``:
the B1913+16-shaped DDGR WLS stand-in ``b1913_ddgr_standin.npz``;
``bw``, ``bw_waves``: the J0023+0923-shaped black widow on FBX orbits
``j0023_bw_standin.npz`` and with ORBWAVES ``j0023_bw_waves_standin.npz``;
``pta``: J1713+0747 with chromatic and solar-wind terms
``j1713_pta_standin.npz``; ``young``: the Vela-shaped
``vela_young_standin.npz``; ``bt``, ``dds``, ``ddh``, ``small_dd_fbx``,
``small_bt_piecewise``, ``small_pta``, ``small_young``: the small ones;
``b1855_wb``, ``small_wb``: the wideband stand-ins; ``b1855_noise``: the
noise-fit stand-in), runs the fit its model calls for
(``WidebandTOAFitter`` for wideband TOAs, ``GLSFitter`` with correlated
noise, else ``WLSFitter``; ``maxiter`` as the snapshot's reference ran
it) and,
where the snapshot has a grid, one warm-up 16x16 grid of its parameters
(M2 x SINI, H3 x STIGMA, F0 x F1, KIN x KOM, MTOT x M2, FB0 x FB1 or
GLF0D_1 x GLTD_1; ``chunk=256``, ``niter`` as the reference ran it: 1
for the GLS stand-ins, 4 for the WLS ones), then traces one more warm
grid (where there is one; a path without a grid says so and goes on),
one warm design matrix and one more fit -- and, where the snapshot's
reference frees noise parameters for ``Fitter.auto``, a second noise
fit from the snapshot's values (scipy's L-BFGS-B over the likelihood's
value and gradient, the first having built them) and one Hessian of the
likelihood -- with ``torch.profiler``
and prints, per traced region:
the wall time, the summed device time of all CUDA kernels, the device's
busy share (device time over wall time), and the ten kernels with the
most device time.  Run on a machine with a CUDA GPU, from the repository
root::

    python3 tools/torch_grid_profile.py [b1855|dmx15|ell1|ell1h|ngc ...]

(``ngc_phoff``, ``ddk``, ``ddgr``, ``bw``, ``pta``, ``young`` and the
others above too; every stand-in with a grid when none is named).
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _device_events(prof):
    """(kernel name, device microseconds) of every device-side event."""
    out = []
    for e in prof.events():
        dt = getattr(e, "device_type", None)
        if dt is not None and "CUDA" in str(dt):
            out.append((e.name, e.device_time_total
                        if hasattr(e, "device_time_total")
                        else e.cuda_time_total))
    return out


def _report(label, prof, wall_s):
    events = _device_events(prof)
    total_us = sum(us for _, us in events)
    per = {}
    for name, us in events:
        n, t = per.get(name, (0, 0.0))
        per[name] = (n + 1, t + us)
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:10]
    print(f"{label}: wall {wall_s * 1e3:.3f} ms, device {total_us / 1e3:.3f} "
          f"ms in {len(events)} kernels, busy share "
          f"{total_us / 1e6 / wall_s:.3f}")
    for name, (n, us) in top:
        print(f"    {us / 1e3:9.3f} ms  {n:5d}x  {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_grid_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from torch.profiler import ProfilerActivity, profile

    from pint_torch import bridge
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import Fitter, WLSFitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.wideband import WidebandTOAFitter

    snapshots = {"b1855": bridge.STANDIN_PATH, "dmx15": bridge.DMX15_PATH,
                 "ell1": bridge.ELL1_PATH, "ell1h": bridge.ELL1H_PATH,
                 "ngc": bridge.NGC_PATH, "ngc_phoff": bridge.NGC_PHOFF_PATH,
                 "ddk": bridge.DDK_PATH, "ddgr": bridge.DDGR_PATH,
                 "bw": bridge.BW_PATH, "pta": bridge.PTA_PATH,
                 "young": bridge.YOUNG_PATH}
    others = {"bw_waves": bridge.BW_WAVES_PATH, "bt": bridge.BT_SMALL_PATH,
              "dds": bridge.DDS_SMALL_PATH, "ddh": bridge.DDH_SMALL_PATH,
              "small_dd_fbx": bridge.DD_FBX_SMALL_PATH,
              "small_bt_piecewise": bridge.BT_PIECEWISE_SMALL_PATH,
              "small_pta": bridge.PTA_SMALL_PATH,
              "small_young": bridge.YOUNG_SMALL_PATH,
              "b1855_wb": bridge.WB_PATH, "small_wb": bridge.WB_SMALL_PATH,
              "b1855_noise": bridge.NOISE_PATH}
    names = sys.argv[1:] or list(snapshots)
    snapshots.update(others)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    for name in names:
        meta, ref = read_snapshot(snapshots[name])
        settings = meta["reference"]["settings"]
        niter = settings["grid_niter"]
        gnames = tuple(meta["reference"].get("grid_params", ("M2", "SINI")))
        model, batch = load_snapshot(snapshots[name], device="cuda")
        cls = WidebandTOAFitter if batch.wideband \
            else GLSFitter if model.has_correlated_errors else WLSFitter
        fitter = cls(batch, model)
        fitter.fit_toas(maxiter=settings["fit_maxiter"])
        fitter.model.designmatrix(batch)
        regions = [("design matrix warm",
                    lambda: fitter.model.designmatrix(batch)),
                   ("fit warm", lambda: cls(batch, model).fit_toas(
                       maxiter=settings["fit_maxiter"]))]
        free = meta["reference"].get("auto_noise_params")
        if free:
            m_free = model.copy()
            for p in free:
                m_free[p].frozen = False
            auto = Fitter.auto(batch, m_free)
            res = auto.fit_noise()  # from the snapshot's values; builds
            fns = next(v for k, v in auto.model._cache.items()
                       if isinstance(k, tuple) and k[0] == "noisefit_fns")
            x = torch.tensor([auto.model.value(p) for p in fns[2]],
                             dtype=torch.float64, device=batch.device)
            rs = [auto.resids.time_resids] + (
                [auto.resids.dm.resids] if batch.wideband else [])
            regions += [(f"noise fit warm ({len(free)} parameters, "
                         f"L-BFGS-B {res.nit} iterations, {res.nfev} "
                         "evaluations)", auto.fit_noise),
                        ("noise Hessian warm", lambda: fns[1](x, *rs))]
        if "ref/grid_chi2" in ref:
            axes = tuple(ref[f"ref/grid_{g.lower()}"] for g in gnames)
            grid_chisq(fitter, gnames, axes, niter=niter, chunk=256)
            regions.insert(0, (
                f"grid 16x16 {gnames[0]} x {gnames[1]} warm (niter={niter})",
                lambda: grid_chisq(fitter, gnames, axes, niter=niter,
                                   chunk=256)))
        else:
            print(f"{name}: no grid in the snapshot; the design matrix and "
                  "the fit only")
        for label, fn in regions:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _report(f"{name} {label}", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
