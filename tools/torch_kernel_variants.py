#!/usr/bin/env python3
"""Time design variants of the port's K2 and K3 kernels on the GPU.

Each variant is the committed kernel source with one textual change: it is
built with the kernels' own nvcc flags into ``pint_torch/_build/variants/``,
its ptxas report (registers, spill bytes) is printed, and it is timed with
CUDA events against the committed source on the same inputs, in
alternating rounds, with its outputs checked bitwise against the committed
kernel's.
The variants record the design choices of the two kernels:

* K2 ``dd_binary_dual`` at the main path's shape (B=256, N=4005):
  ``strided-stores`` writes each thread's 17 partials straight to the
  output instead of through shared memory; ``bounds-128x4`` and
  ``bounds-128x5`` cap the registers with ``__launch_bounds__`` (more
  resident warps, at the price of spills);
* K3 at nt = 88, 140 and 232 (B=256): ``fused-scale`` scales column j+1
  inside column j's update step (one barrier per column instead of two,
  but the divisions fall to one lane per warp); ``warp-solve`` runs the
  forward and back substitutions in one warp with ``__syncwarp``.

Run on a machine with a CUDA GPU and nvcc, from the repository root::

    python3 tools/torch_kernel_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "pint_torch" / "kernels" / "csrc"

K2_STRIDED = ("""    for (int i = 0; i < NPARTIAL; ++i) rows[threadIdx.x * NPARTIAL + i] = P[i];
  }
  __syncthreads();
  const long n = (total - first < THREADS ? total - first : THREADS) * NPARTIAL;
  double* out = partials + first * NPARTIAL;
  for (long e = threadIdx.x; e < n; e += THREADS) out[e] = rows[e];""",
              """    for (int i = 0; i < NPARTIAL; ++i) partials[idx * NPARTIAL + i] = P[i];
  }""")
K2_DUAL = "__global__ void dd_binary_dual("

K3_COLUMN = """    for (int j = p0; j < p1; ++j) {
      const int jj = j - p0;
      const double s = pv(j, jj);
      const double ljj = sqrt(s);
      if (tid == 0) {
        if (!(s > 0.0)) bad = 1;
        dL[j] = ljj;
      }
      for (int i = j + 1 + tid; i < nt; i += THREADS)
        pv(i, jj) = pv(i, jj) / ljj;
      __syncthreads();
      const int c = j + 1 + lane;
      if (c < p1) {
        const double lc = pv(c, jj);
        for (int i = j + 1 + warp; i < nt; i += NWARPS)
          if (i >= c) pv(i, c - p0) = pv(i, c - p0) - pv(i, jj) * lc;
      }
      __syncthreads();
    }"""
K3_FUSED = """    {
      const double s = pv(p0, 0);
      const double l = sqrt(s);
      if (tid == 0) {
        if (!(s > 0.0)) bad = 1;
        dL[p0] = l;
      }
      for (int i = p0 + 1 + tid; i < nt; i += THREADS)
        pv(i, 0) = pv(i, 0) / l;
      __syncthreads();
    }
    for (int j = p0; j + 1 < p1; ++j) {
      const int jj = j - p0;
      const int c = j + 1 + lane;
      if (c < p1) {
        const double lc = pv(c, jj);
        if (lane == 0) {
          const double s = pv(c, jj + 1) - lc * lc;
          const double l = sqrt(s);
          if (warp == 0) {
            if (!(s > 0.0)) bad = 1;
            dL[c] = l;
          }
          for (int i = c + 1 + warp; i < nt; i += NWARPS)
            pv(i, jj + 1) = (pv(i, jj + 1) - pv(i, jj) * lc) / l;
        } else {
          for (int i = j + 1 + warp; i < nt; i += NWARPS)
            if (i >= c) pv(i, c - p0) = pv(i, c - p0) - pv(i, jj) * lc;
        }
      }
      __syncthreads();
    }"""
K3_SOLVES = """  for (int k = 0; k < nt; ++k) {
    const double zk = y[k] / dL[k];
    if (tid == 0) z[k] = zk;
    for (int i = k + 1 + tid; i < nt; i += THREADS)
      y[i] = y[i] - A[(long)i * ld + k] * zk;
    __syncthreads();
  }
  // back substitution L^T w = z (z working, y final)
  for (int k = nt - 1; k >= 0; --k) {
    const double wk = z[k] / dL[k];
    if (tid == 0) y[k] = wk;
    for (int i = tid; i < k; i += THREADS)
      z[i] = z[i] - A[(long)k * ld + i] * wk;
    __syncthreads();
  }"""
K3_WARP_SOLVES = """  if (warp == 0) {
    for (int k = 0; k < nt; ++k) {
      const double zk = y[k] / dL[k];
      if (lane == 0) z[k] = zk;
      for (int i = k + 1 + lane; i < nt; i += 32)
        y[i] = y[i] - A[(long)i * ld + k] * zk;
      __syncwarp();
    }
    for (int k = nt - 1; k >= 0; --k) {
      const double wk = z[k] / dL[k];
      if (lane == 0) y[k] = wk;
      for (int i = lane; i < k; i += 32)
        z[i] = z[i] - A[(long)k * ld + i] * wk;
      __syncwarp();
    }
  }
  __syncthreads();"""


def _patch(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant no longer applies to the source: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _variants():
    k2 = (CSRC / "dd_binary.cu").read_text()
    k3 = (CSRC / "schur_cholesky_solve.cu").read_text()
    bounds = [(K2_DUAL, f"__global__ void __launch_bounds__(128, {n}) "
               "dd_binary_dual(") for n in (4, 5)]
    return {
        "dd_binary": {
            "committed": k2,
            "strided-stores": _patch(k2, K2_STRIDED),
            "bounds-128x4": _patch(k2, bounds[0]),
            "bounds-128x5": _patch(k2, bounds[1]),
        },
        "schur_cholesky_solve": {
            "committed": k3,
            "fused-scale": _patch(k3, (K3_COLUMN, K3_FUSED)),
            "warp-solve": _patch(k3, (K3_SOLVES, K3_WARP_SOLVES)),
        },
    }


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from pint_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    work = _build.BUILD_DIR / "variants"
    work.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for kernel, variants in _variants().items():
        for name, src in variants.items():
            cu = work / f"{kernel}-{name}.cu"
            cu.write_text(src)
            procs[(kernel, name)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {kernel} {name}:\n{log}")
        libs[(kernel, name)] = ctypes.CDLL(
            str(work / f"{kernel}-{name}.so"))
        markers = {"dd_binary": ["dd_binary_dual"],
                   "schur_cholesky_solve": ["kernelILb1E", "kernelILb0E"]}
        for marker in markers[kernel]:
            r = _build.ptxas_report(log, marker)
            print(f"ptxas {kernel} {name} {marker}: " + (
                f"{r[0]} registers, {r[1]} bytes stack frame, {r[2]} bytes "
                f"spill stores, {r[3]} bytes spill loads" if r
                else "no report"), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def rt(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, generator=gen, dtype=torch.float64,
                          device=dev) * (hi - lo) + lo

    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    # K2 dual on B1855-like orbits at the main path's shape
    row = torch.tensor([12.327, 1e-12, 2e-13, 9.23, 1e-14, 2e-5, 1e-16, 276.5,
                        0.0, 0.27, 0.9991, 0.0, 0.0, 0.0, 0.0, 0.0],
                       dtype=torch.float64, device=dev)
    params = row.expand(256, -1).clone()
    params[:, 9] = rt(256, lo=0.2, hi=0.35)
    params[:, 10] = rt(256, lo=0.998, hi=0.9999)
    tt0 = rt(1, 4005, lo=-3e8, hi=3e8).expand(256, -1).contiguous()
    ref = None
    names = [n for k, n in libs if k == "dd_binary"]
    for rnd in range(2):
        for name in names:
            fn = libs[("dd_binary", name)].dd_binary_launch
            fn.argtypes = [vp, vp, ci, ci, vp, vp, vp]
            fn.restype = ci
            delay = torch.empty(256, 4005, dtype=torch.float64, device=dev)
            P = torch.empty(256, 4005, 17, dtype=torch.float64, device=dev)

            def run():
                return fn(ptr(tt0), ptr(params), 256, 4005, ptr(delay),
                          ptr(P), stream)

            if run() != 0:
                raise SystemExit(f"dd_binary {name}: launch failed")
            torch.cuda.synchronize()
            if ref is None:
                ref = (delay.clone(), P.clone())
            same = torch.equal(delay, ref[0]) and torch.equal(P, ref[1])
            print(f"round {rnd} dd_binary_dual {name}: {_time_ms(run):.4f} "
                  f"ms, bitwise as committed {same} [{card}]", flush=True)

    # K3 on random SPD systems with an ill-conditioned and a NaN point
    names = [n for k, n in libs if k == "schur_cholesky_solve"]
    for nt in (88, 140, 232):
        B = 256
        X = rt(B, nt, 2 * nt)
        Ar = X @ X.transpose(1, 2)
        q, _ = torch.linalg.qr(rt(nt, nt))
        Ar[1] = (q * torch.logspace(0, -13, nt, dtype=torch.float64,
                                    device=dev)) @ q.T
        Ar[3, 4, 2] = Ar[3, 2, 4] = float("nan")
        rhs = rt(B, nt)
        ref = None
        for rnd in range(2):
            for name in names:
                lib = libs[("schur_cholesky_solve", name)]
                lib.schur_cholesky_solve_workspace.argtypes = [ci]
                lib.schur_cholesky_solve_workspace.restype = ctypes.c_longlong
                fn = lib.schur_cholesky_solve_launch
                fn.argtypes = [vp, vp, ctypes.c_double, ci, ci, vp, vp, vp,
                               vp, vp]
                fn.restype = ci
                per = lib.schur_cholesky_solve_workspace(nt)
                ws = torch.empty(B * per, dtype=torch.float64, device=dev) \
                    if per else None
                x = torch.empty(B, nt, dtype=torch.float64, device=dev)
                ok = torch.empty(B, dtype=torch.bool, device=dev)
                cond = torch.empty(B, dtype=torch.float64, device=dev)

                def run():
                    return fn(ptr(Ar), ptr(rhs), 1e-12, B, nt, ptr(ws),
                              ptr(x), ptr(ok), ptr(cond), stream)

                if run() != 0:
                    raise SystemExit(f"schur_cholesky_solve {name}: launch "
                                     "failed")
                torch.cuda.synchronize()
                out = (torch.nan_to_num(x, nan=7.0), ok.clone(),
                       torch.nan_to_num(cond, nan=7.0))
                if ref is None:
                    ref = out
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                print(f"round {rnd} schur_cholesky_solve nt={nt} {name}: "
                      f"{_time_ms(run):.4f} ms, bitwise as committed {same} "
                      f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
