#!/usr/bin/env python3
"""Build kernel K11 (``compensated_matmul``) alone on the card and hold every
instantiation against its plain PyTorch twin.

Run from the root of a checkout on a machine with one CUDA GPU::

    python3 tools/torch_k11_probe.py

Prints the card's name and power limit, the ptxas report of each
``__global__`` of ``pint_torch/kernels/csrc/compensated_matmul.cu``, then
for each accumulation mode and compute dtype, on ``chip_smoke.py``'s seeded
random operands (``chip_smoke._k11_cases``), the largest difference from
the twin and its ratio to the mode's bar (``chip_smoke._k11_bar``), and the
kernel's time on the largest case and on a grid.gram-shaped product
((16, 4, 4005) x a shared (4005, 535): few output tiles, a long
contraction) beside the twin's and its bound.  Exits non-zero if a
ratio exceeds 1 or NaN/Inf fall elsewhere than the twin's: the quickest
check after editing the source.
"""

from __future__ import annotations

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main() -> int:
    import torch

    import chip_smoke as cs
    from pint_torch.kernels import _build
    from pint_torch.kernels import compensated_matmul as K11

    if not torch.cuda.is_available():
        print("torch_k11_probe: no GPU", file=sys.stderr)
        return 2
    print(f"card: {cs._card()}", flush=True)
    secs = _build.build([K11.NAME])
    log = _build.library_path(K11.NAME).with_suffix(".log").read_text()
    print(f"build: {secs}", flush=True)
    for i, acc in enumerate(K11.ACCUMULATIONS):
        for j, ct in enumerate(("float32", "bfloat16")):
            r = _build.ptxas_report(
                log, f"compensated_matmul_kernelILi{i}ELi{j}E")
            print(f"ptxas {K11.KERNELS[(acc, ct)]}: {r}", flush=True)
    dev = torch.device("cuda")
    cases = cs._k11_cases(dev)
    gen = torch.Generator(device=dev).manual_seed(4005)
    gram = (torch.randn(16, 4, 4005, generator=gen, dtype=torch.float64,
                        device=dev),
            torch.randn(1, 4005, 535, generator=gen, dtype=torch.float64,
                        device=dev).expand(16, 4005, 535))
    worst_all, ok = 0.0, True
    for acc in K11.ACCUMULATIONS:
        for ct in ("float32", "bfloat16"):
            line = []
            for a, b in cases:
                err, ratio, nf = cs._k11_check(K11, a, b, ct, acc)
                torch.cuda.synchronize()
                line.append(f"{tuple(a.shape)}x{tuple(b.shape)} {err:.3e} "
                            f"({ratio:.3f})")
                worst_all = max(worst_all, ratio)
                ok = ok and ratio <= 1.0 and nf
            err, ratio, nf = cs._k11_check(K11, *gram, ct, acc)
            line.append(f"grid.gram shape {err:.3e} ({ratio:.3f})")
            worst_all = max(worst_all, ratio)
            ok = ok and ratio <= 1.0 and nf
            for a, b in (cases[cs.K11_LARGEST_CASE], gram):
                bd = K11.split_bounds(a.shape[-1], 8)
                ms = cs._time_ms(lambda: K11._launch(a, b, ct, acc, bd), 5)
                plain = cs._time_ms(
                    lambda: K11.compensated_matmul_reference(a, b, ct, acc),
                    3)
                bound = cs._k11_bound(a, b, ct, acc)
                line.append(f"at {tuple(a.shape)}x{tuple(b.shape)} kernel "
                            f"{ms:.4f} ms, twin {plain:.4f} ms, bound "
                            f"{bound[0]:.4f} ms ({bound[1]})")
            print(f"{K11.KERNELS[(acc, ct)]}: " + "; ".join(line),
                  flush=True)
    counts = {k: v for k, v in K11.launch_counts.items() if v}
    print(f"launches: {counts}; worst ratio {worst_all:.3f}; "
          f"{'ALL OK' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
