#!/usr/bin/env python3
"""Build the port's kernels on one CUDA GPU and run three phases of
``chip_smoke.py`` alone: amortized training on ell1 under the forced
float32 policy (K11's forward and backward) with K11's backward checks,
K8's MIXED mode on a photon stand-in's mixed closed-form template with its
kernel checks, and the narrowband GLS fitters' full-covariance fits on
b1855_noise.

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc::

    python3 tools/torch_reduced_photon_probe.py [--steps N] [--small]

``--steps`` sets the reduced run's timed steps (default 20); ``--small``
runs the photon phase on the small photon stand-in (300 photons) in place
of J0030's 32768.  Prints the card, then the phases' lines; exits
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
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from pint_torch import kernels
    from pint_torch.bridge import (ELL1_PATH, NOISE_PATH, PHOTON_PATH,
                                   PHOTON_SMALL_PATH)

    if not torch.cuda.is_available():
        raise SystemExit("no GPU")
    dev = torch.device("cuda")
    tag = f"[{cs._card()}]"
    print(f"probe device: {tag}", flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"probe build: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    counts, calls = cs._amortized_reduced_phase(ELL1_PATH, kernels, tag,
                                                args.steps)
    cs._k11_bwd_kernels(calls, counts, dev, tag)
    label, path = ("small_photon", PHOTON_SMALL_PATH) if args.small \
        else ("photon_j0030", PHOTON_PATH)
    _, cap = cs._photon_mixed_phase(label, path, kernels, tag)
    cs._k8_mixed_kernels(cap, dev, tag)
    cs._full_cov_phase(NOISE_PATH, kernels, tag)
    print(f"probe wall: {time.perf_counter() - t0:.2f} s {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
