#!/usr/bin/env python3
"""Build the port's kernels and run ``chip_smoke.py``'s tracking phase
alone: pulse numbers and both ``track_mode``s on ngc, the walker rows with
pulse numbers on ell1, ``d_phase_d_toa``, ``ftest``, model editing, the
ECORR subset of b1855, the preflight and the doctor, from the committed
par and tim files, against the reference's run on them
(``ref/tracking/``).  The quickest check of the whole-TOA-set layer on the
card::

    python3 tools/torch_tracking_probe.py

Needs one CUDA GPU; prints the phase's lines and its launch counts, and
fails as the phase fails.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this probe needs a GPU",
              file=sys.stderr)
        return 1
    import chip_smoke
    from pint_torch import kernels

    t = time.perf_counter()
    built = kernels.build_all()
    card = chip_smoke._card()
    print(f"build: {time.perf_counter() - t:.2f} s for {len(built)} kernels; "
          f"{card}", flush=True)
    t = time.perf_counter()
    counts, _, _ = chip_smoke._tracking_phase(kernels, f"[{card}]")
    print(f"tracking launches: "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
          + f"; phase {time.perf_counter() - t:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
