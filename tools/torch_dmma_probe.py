#!/usr/bin/env python3
"""The float64 tensor-core products ``mma.sync`` offers on one CUDA GPU:
m8n8k4 and the sm_90 shapes m16n8k4, m16n8k8 and m16n8k16.

Run from the root of a checkout on a machine with one CUDA GPU and nvcc::

    python3 tools/torch_dmma_probe.py

Builds ``tools/csrc/dmma_rate.cu`` with the kernels' nvcc flags, holds each
shape's product (the fragment layouts written in the source) against
``A @ B`` on seeded 16 x 16 by 16 x 8 operands, then times every shape
over 264 CTAs of 8 warps each issuing 8 independent products a round, and
prints the rate in TFLOP/s (2 m n k flops a product) beside the card's
name and power limit.  Exits non-zero where a product disagrees.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {884: (8, 8, 4), 1684: (16, 8, 4), 1688: (16, 8, 8),
          16816: (16, 8, 16)}


def main() -> int:
    import torch

    from pint_torch.kernels import _build

    if not torch.cuda.is_available():
        print("torch_dmma_probe: no CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out_dir = _build.BUILD_DIR / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "dmma_rate.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(ROOT / "tools" / "csrc" / "dmma_rate.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dmma_check_launch.argtypes = [ci, vp, vp, vp]
    lib.dmma_rate_launch.argtypes = [ci, ci, ci, vp]
    gen = torch.Generator(device="cuda").manual_seed(16)
    A = torch.randn(16, 16, generator=gen, dtype=torch.float64,
                    device="cuda")
    B = torch.randn(16, 8, generator=gen, dtype=torch.float64, device="cuda")
    want = A @ B
    ok = True
    blocks, iters = 264, 4096
    out = torch.empty(blocks * 256, dtype=torch.float64, device="cuda")
    for shape, (m, n, k) in SHAPES.items():
        D = torch.zeros(16, 8, dtype=torch.float64, device="cuda")
        rc = lib.dmma_check_launch(shape, A.data_ptr(), B.data_ptr(),
                                   D.data_ptr())
        torch.cuda.synchronize()
        err = float((D - want).abs().max()) if rc == 0 else float("nan")
        good = rc == 0 and err <= 1e-12
        ok = ok and good
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.dmma_rate_launch(shape, blocks, iters, out.data_ptr())
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = min(times)
        flops = blocks * 8 * iters * 8 * 2 * m * n * k
        print(f"dmma m{m}n{n}k{k}: layout {'ok' if good else 'WRONG'} "
              f"(max abs {err:.3e}, rc {rc}); {ms:.4f} ms, "
              f"{flops / ms / 1e9:.2f} TFLOP/s [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
