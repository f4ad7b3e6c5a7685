#!/usr/bin/env python3
"""Build the port's kernels on one CUDA GPU and run the amortized phase of
``chip_smoke.py`` alone: K10 against its plain version at B = 16 (its panel
kernel can keep the diagonal blocks for K12), the amortized phase on
pta67_catalog (K10 and K12), ell1 (K1, K4) and ddgr (K1, K2 DDGR), K12's
kernel checks and the backward checks of those paths' kernels.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc::

    python3 tools/torch_amortized_probe.py [--steps N] [--only ell1,ddgr]

``--steps`` sets the timed steps of each stand-in (default 20), ``--only``
the stand-ins (of pta67_catalog, ell1, ddgr; K10's and K12's checks run
with pta67_catalog).  Prints the card, then the phases' lines; exits
non-zero when a bar fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--only", default="pta67_catalog,ell1,ddgr")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from pint_torch import kernels
    from pint_torch.bridge import CATALOG_PATH, DDGR_PATH, ELL1_PATH
    from pint_torch.kernels import hd_cross_lnlike as K10

    if not torch.cuda.is_available():
        raise SystemExit("no GPU")
    dev = torch.device("cuda")
    tag = f"[{cs._card()}]"
    print(f"probe device: {tag}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"probe build: {time.perf_counter() - t0:.2f} s", flush=True)
    caps, same = {}, True
    only = args.only.split(",")
    t0 = time.perf_counter()
    if "pta67_catalog" in only:
        counts, cap, jl = cs._amortized_phase(
            "pta67_catalog", CATALOG_PATH, "catalog", kernels, tag,
            args.steps)
        caps["amortized_pta67_catalog"] = cap
        la = torch.linspace(-16.0, -13.0, 16, dtype=torch.float64,
                            device=dev)
        ga = torch.full_like(la, 13.0 / 3.0)
        same = torch.equal(
            K10._launch(jl.G, jl.u, la, ga, jl._freqs_t, jl.Tspan),
            K10.hd_cross_lnlike_reference(jl.G, jl.u, la, ga, jl._freqs_t,
                                          jl.Tspan))
        print(f"probe K10 B=16 bitwise its plain version: {same} {tag}",
              flush=True)
        rec = cs._k12_kernels(jl, cap, counts, dev, tag)
        print(f"probe K12 record: {rec} {tag}", flush=True)
    for label, path in (("ell1", ELL1_PATH), ("ddgr", DDGR_PATH)):
        if label in only:
            _, cap, _ = cs._amortized_phase(label, path, "bayes", kernels,
                                            tag, args.steps)
            caps[f"amortized_{label}"] = cap
    cs._backward_kernels(caps, dev, tag, partial=True)
    print(f"probe wall: {time.perf_counter() - t0:.2f} s {tag}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
