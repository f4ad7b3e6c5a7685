#!/usr/bin/env python3
"""Build K13 ``polyco_eval`` and K14 ``polyco_fit`` on one CUDA GPU and run
the predict phase of ``chip_smoke.py`` alone: the phase-prediction path P1
(ngc6440e's predictor cache at the barycentre) and P2 (four stand-ins'
predictors at GBT in one batch, then b1855's cache), their bars against the
snapshots' ``ref/predict/``, and both kernels against their plain versions
with their times.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc::

    python3 tools/torch_predict_probe.py

Prints the card, the ptxas report of both kernels, then the phase's lines;
exits non-zero when a bar fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from pint_torch import kernels
    from pint_torch.bridge import (DDGR_PATH, DDK_PATH, ELL1_PATH, NGC_PATH,
                                   STANDIN_PATH)
    from pint_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("no GPU")
    dev = torch.device("cuda")
    tag = f"[{cs._card()}]"
    print(f"probe device: {tag}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"probe build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("polyco_eval", "polyco_fit"):
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(f"probe ptxas {name}: {_build.ptxas_report(log, name)}",
              flush=True)
    t0 = time.perf_counter()
    out = cs._predict_phase({"ngc": NGC_PATH, "b1855": STANDIN_PATH,
                             "ell1": ELL1_PATH, "ddk": DDK_PATH,
                             "ddgr": DDGR_PATH}, kernels, tag)
    for label, (counts, _) in out.items():
        print(f"probe {label} launches: " + ", ".join(
            f"{k} {v}" for k, v in counts.items() if v), flush=True)
    rec = cs._k13_k14_kernels(out["predict_p1"], out["predict_p2"], dev, tag)
    print(f"probe records: {rec} {tag}", flush=True)
    print(f"probe wall: {time.perf_counter() - t0:.2f} s {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
