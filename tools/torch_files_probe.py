#!/usr/bin/env python3
"""Build the port's kernels and run ``chip_smoke.py``'s files phase alone:
b1855, ell1 and ngc read from their committed par and tim files by
``pint_torch.models.get_model_and_toas``, each host stage timed, their main
paths on the card and their bars against the reference's run on the same
files (``ref/files/``).  The quickest check of the reading layer on the
card::

    python3 tools/torch_files_probe.py

Needs one CUDA GPU; prints each stand-in's phase lines and the launch
counts, and fails as the phase fails.
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
    from pint_torch.bridge import ELL1_PATH, NGC_PATH, STANDIN_PATH

    t = time.perf_counter()
    built = kernels.build_all()
    print(f"build: {time.perf_counter() - t:.2f} s for {len(built)} kernels; "
          f"{chip_smoke._card()}", flush=True)
    for label, path in (("ngc", NGC_PATH), ("b1855", STANDIN_PATH),
                        ("ell1", ELL1_PATH)):
        counts, _ = chip_smoke._files_phase(label, path, kernels,
                                            f"[{chip_smoke._card()}]")
        print(f"{label} launches: "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v),
              flush=True)
    print(f"done: {time.perf_counter() - t:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
