#!/usr/bin/env python3
"""Build kernel K11 (``compensated_matmul``) alone on the card and hold every
instantiation against its plain PyTorch twin.

Run from the root of a checkout on a machine with one CUDA GPU::

    python3 tools/torch_k11_probe.py [--variants]

Prints the card's name and power limit, the ptxas report of each
``__global__`` of ``pint_torch/kernels/csrc/compensated_matmul.cu``, then
for each accumulation mode and compute dtype, on ``chip_smoke.py``'s seeded
random operands (``chip_smoke._k11_cases``), the largest difference from
the twin and its ratio to the mode's bar (``chip_smoke._k11_bar``), and the
kernel's time on the largest case, on a grid.gram-shaped product
((16, 4, 4005) x a shared (4005, 535): few output tiles, a long
contraction) and on the serve Gram (X^T X of a (4, 4096, 512) X, the
transposed view as the serve path passes it) beside the twin's and its
bound; the serve Gram's two launches bitwise.  With ``--variants``, the
source built otherwise (``VARIANTS``) is timed beside it on the serve Gram
and a catalog.lnlike-shaped product in every mode.  Exits non-zero if a
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
            marker = (("cm_f32", "cm_bf16")[j] if acc == "native"
                      else f"cm_dmmaILi{i}ELi{j}E")
            r = _build.ptxas_report(log, marker)
            print(f"ptxas {K11.KERNELS[(acc, ct)]}: {r}", flush=True)
    dev = torch.device("cuda")
    cases = cs._k11_cases(dev)
    gen = torch.Generator(device=dev).manual_seed(4005)
    gram = (torch.randn(16, 4, 4005, generator=gen, dtype=torch.float64,
                        device=dev),
            torch.randn(1, 4005, 535, generator=gen, dtype=torch.float64,
                        device=dev).expand(16, 4005, 535))
    # the serve Gram's operands as the serve path hands them: X^T X of a
    # (4, 4096, 512) X, a transposed view against X
    X = torch.randn(4, 4096, 512, generator=gen, dtype=torch.float64,
                    device=dev)
    serve = (X.transpose(1, 2), X)
    # catalog.lnlike's shape: 67 pulsars' (28, 398) x (398, 28)
    cat = (torch.randn(67, 28, 398, generator=gen, dtype=torch.float64,
                       device=dev),
           torch.randn(67, 398, 28, generator=gen, dtype=torch.float64,
                       device=dev))
    worst_all, ok = 0.0, True
    for acc in K11.ACCUMULATIONS:
        for ct in ("float32", "bfloat16"):
            line = []
            for a, b in cases:
                err, ratio, nf, _ = cs._k11_check(K11, a, b, ct, acc)
                torch.cuda.synchronize()
                line.append(f"{tuple(a.shape)}x{tuple(b.shape)} {err:.3e} "
                            f"({ratio:.3f})")
                worst_all = max(worst_all, ratio)
                ok = ok and ratio <= 1.0 and nf
            for label, (a, b) in (("grid.gram", gram), ("serve", serve)):
                err, ratio, nf, _ = cs._k11_check(K11, a, b, ct, acc)
                line.append(f"{label} shape {err:.3e} ({ratio:.3f})")
                worst_all = max(worst_all, ratio)
                ok = ok and ratio <= 1.0 and nf
            bd = K11.split_bounds(4096, 8)
            once = K11._launch(*serve, ct, acc, bd)
            again = K11._launch(*serve, ct, acc, bd)
            same = bool(torch.equal(once, again))
            line.append(f"two launches bitwise {same}")
            ok = ok and same
            for a, b in (cases[cs.K11_LARGEST_CASE], gram, serve, cat):
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
    if "--variants" in sys.argv:
        ok = variants(torch, cs, K11, {"serve Gram": serve,
                                       "catalog.lnlike": cat}) and ok
    return 0 if ok else 1


#: K11 built otherwise (one line changed): a two-stage ring under two_prod,
#: one CTA an SM (no register cap)
VARIANTS = {
    "tp_ns2": [("static constexpr int NS = MODE == TWO_PROD ? 3 : 4;",
                "static constexpr int NS = MODE == TWO_PROD ? 2 : 4;")],
    "min1": [("constexpr int MIN_CTAS = 2;", "constexpr int MIN_CTAS = 1;")]}


def variants(torch, cs, K11, shapes):
    """Each of :data:`VARIANTS` beside the committed source on ``shapes``
    ({label: (a, b)}) in every mode, within the bar, in two rounds (the
    second in reverse order)."""
    import ctypes
    import subprocess

    from pint_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    committed = _build.load(K11.NAME)
    libs = {"committed": committed}
    for name, pairs in VARIANTS.items():
        src = (_build.CSRC / f"{K11.NAME}.cu").read_text()
        for old, new in pairs:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not once")
            src = src.replace(old, new)
        cu = out_dir / f"{K11.NAME}-{name}.cu"
        so = out_dir / f"{K11.NAME}-{name}.so"
        cu.write_text(src)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], check=True,
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        for marker in ("cm_f32", "cm_bf16", "cm_dmmaILi1ELi0E",
                       "cm_dmmaILi2ELi0E", "cm_dmmaILi3ELi0E"):
            print(f"ptxas {name} {marker}: "
                  f"{_build.ptxas_report(log, marker)}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.compensated_matmul_error_string.argtypes = [ctypes.c_int]
        lib.compensated_matmul_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    ok, times = True, {}
    order = list(libs)
    for rnd in (order, order[::-1]):
        for name in rnd:
            _build._loaded[K11.NAME] = libs[name]
            for label, (a, b) in shapes.items():
                bd = K11.split_bounds(a.shape[-1], 8)
                for acc in K11.ACCUMULATIONS:
                    for ct in ("float32", "bfloat16"):
                        _, ratio, nf, same = cs._k11_check(K11, a, b, ct,
                                                           acc)
                        ok = ok and ratio <= 1.0 and nf and same
                        times.setdefault((name, label, acc, ct), []).append(
                            cs._time_ms(lambda: K11._launch(a, b, ct, acc,
                                                            bd), 5))
    _build._loaded[K11.NAME] = committed
    for (name, label, acc, ct), ts in times.items():
        print(f"variant {name} {K11.KERNELS[(acc, ct)]} {label}: "
              f"{ts[0]:.4f} / {ts[1]:.4f} ms (rounds 1 / 2)", flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
