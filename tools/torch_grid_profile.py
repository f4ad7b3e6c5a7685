#!/usr/bin/env python3
"""Where the port's time goes on the GPU, for the B1855-shaped stand-in.

Loads ``pint_torch/data/b1855_standin.npz`` onto the card, runs the GLS fit
and one warm-up 16x16 M2 x SINI grid (``niter=1``, ``chunk=256``), then
traces one more warm grid and one warm design matrix with
``torch.profiler`` and prints, per traced region: the wall time, the summed
device time of all CUDA kernels, the device's busy share (device time over
wall time), and the ten kernels with the most device time.  Run on a
machine with a CUDA GPU, from the repository root::

    python3 tools/torch_grid_profile.py
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

    from pint_torch.bridge import STANDIN_PATH, load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    _, ref = read_snapshot(STANDIN_PATH)
    model, batch = load_snapshot(STANDIN_PATH, device="cuda")
    fitter = GLSFitter(batch, model)
    fitter.fit_toas(maxiter=2)
    axes = (ref["ref/grid_m2"], ref["ref/grid_sini"])
    grid_chisq(fitter, ("M2", "SINI"), axes, niter=1, chunk=256)
    fitter.model.designmatrix(batch)
    for label, fn in (
            ("grid 16x16 warm", lambda: grid_chisq(
                fitter, ("M2", "SINI"), axes, niter=1, chunk=256)),
            ("design matrix warm", lambda: fitter.model.designmatrix(batch))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(label, prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
