#!/usr/bin/env python3
"""Time design variants of the port's K1-K7 kernels on the GPU.

Each variant is the committed kernel source with one textual change: it is
built with the kernels' own nvcc flags into ``pint_torch/_build/variants/``,
its ptxas report (registers, stack frame, spill bytes) is printed, and it
is timed with CUDA events against the committed source on the same inputs,
in two rounds (the second in reverse order), with its outputs checked
bitwise against the committed kernel's (K5's, which round differently, to
its twin's bars).  With ``--parent DIR`` (an unpacked earlier tree of the
repository) that tree's sources run beside them as the variant
``parent`` (a parent that built K7 with contraction on is built so).  The
variants record the design choices of the kernels:

* K2 ``dd_binary_primal`` on the B1855 stand-in's main-path inputs
  (captured from its GLS fit and M2 x SINI grid, B=256, N=4005) and on the
  same TOAs with ECC drawn from 0.55-0.65: ``fixed-15`` runs the reference's
  15 Newton steps with no exit; ``exit-period1`` stops on a fixed point
  only, not on a 2-cycle; ``1d-grid`` launches one thread per (point, TOA)
  on a 1-D grid, each thread dividing by N and loading its parameter row;
  ``sin-and-cos`` calls ``sin()`` and ``cos()`` apart where the kernel
  takes each same-argument pair from one ``sincos()``; ``row-first`` loads
  each thread's tt0 after the barrier that publishes the block's parameter
  row instead of before it;
* K2 ``dd_binary_dual`` on the same main-path inputs: ``fixed-15``,
  ``sin-and-cos``, and ``strided-stores``, which writes each thread's 17
  partials straight to the output instead of through shared memory (each
  on the PB-orbit instantiations); and,
  with a ``--parent`` that has K2's modes, ``bt_binary_dual`` and
  ``ddk_binary_dual`` on the same call beside the parent's (which writes
  a column for every row entry, read or not);
* K1 ``spin_phase_primal`` and ``spin_phase_dual`` on the main-path inputs
  (S = 2) and on seeded random inputs with S = 6 at the same shape:
  ``runtime-S`` is a primal compiled once for any S, its row in a
  runtime-indexed array and its Horner coefficients divided per element;
  ``strided-partials`` writes each thread's S + 2 partials straight to the
  output instead of through shared memory; ``row-first`` (both) loads each
  thread's inputs after the barrier that publishes the block's row;
* K3 at nt = 88, 140 and 232 (B=256): ``fused-scale`` scales column j+1
  inside column j's update step (one barrier per column instead of two,
  but the divisions fall to one lane per warp); ``warp-solve`` runs the
  forward and back substitutions in one warp with ``__syncwarp``;
* K4 (``--only K4``) ``ell1_binary_primal`` and ``ell1_binary_dual`` on
  the ELL1 stand-in's main-path inputs, the committed source beside the
  parent's only (a parent from before the orbit inputs takes the older
  launch arguments);
* K5 on the ELL1 stand-in's main-path inputs (captured from its WLS fit
  and ``niter=4`` grid, P=256, N=4005, k=88): ``qr-only`` stops the Jacobi
  before its first sweep (the kernels' time less the Jacobi's: the QR,
  scaling and x; ``parent-qr-only`` the same for the parent kernel),
  ``nb=1`` folds one reflector at a time on the CUDA cores, one warp a
  trailing column (what the tensor-core WY blocking buys), ``m=64x1``
  folds 64-row tiles where the kernel folds 128-row ones (twice the
  panels' chains per point), ``jg=4``, ``jg=16`` give each Jacobi pair 4
  or 16 lanes instead of 8, ``svd-512`` runs the SVD kernel as one block
  of 512 threads an SM instead of two of 256, ``panel-only`` and
  ``trail-only`` skip the fold's trailing updates or its panels (timings
  of the two halves of the fold, outputs not checked), and ``acc=1`` sums
  a slice's U^T T in one chain of dependent mma's instead of four
  independent ones;
* K7 (``--only K7``) ``solar_wind_pl_primal`` and ``_dual`` on the pta
  stand-in's main-path calls (captured from its GLS fit and KIN x KOM
  grid, B=256, N=4005): ``pow`` puts the parent's ``pow(cp, p - 2)``
  back in the node loop (its d/dp term then takes its own logarithm),
  ``sin-and-cos`` calls ``sin()`` and ``cos()`` apart where the kernel
  takes each pair from one ``sincos()``, ``staged`` (dual) writes the
  block's partials through shared memory as one contiguous run instead of
  each thread's three straight to the output, ``lb9`` holds the kernel to
  9 blocks an SM (``__launch_bounds__``, 56 registers), ``threads-64``
  launches blocks of 64 threads; the geometry bitwise as committed but
  for ``pow`` and the parent, whose powers round otherwise (within 1e-13
  of each value);
* K6 (``--only K6``) each form's dual on its path's largest call (FBX on
  the bw stand-in's fit and FB0 x FB1 grid, B=256, N=4005; ORBWAVES on
  an FBX base on bw_waves', on a PB base on small_dd_fbx's fit) and the
  FBX primal: ``loop-stores`` writes the tile with the block's threads in
  a coalesced loop, as K2's dual does, instead of one TMA bulk store;
  ``strided-stores`` runs every width on the direct dual, each thread
  writing its row straight to the output; orbits and pbprime bitwise.
  The partials of K6 and K7 are held within 1e-10 of each column's
  largest.

Run on a machine with a CUDA GPU and nvcc, from the repository root::

    python3 tools/torch_kernel_variants.py [--parent DIR] [--only K1,...,K7]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "pint_torch" / "kernels" / "csrc"

# ---- K2 ---------------------------------------------------------------------
K2_EXIT = """  double E = M + e * sin(M);
  long long before = 0;  // bits of E_{n-1}, from the second step on
  for (int it = 0; it < 15; ++it) {
    double sE, cE;
    sincos(E, &sE, &cE);
    const double dE = (E - e * sE - M) / (1.0 - e * cE);
    const double En = E - clip1(dE);
    const long long bn = __double_as_longlong(En);
    const long long bE = __double_as_longlong(E);
    if (bn == bE) break;
    if (it > 0 && bn == before) {
      if (((14 - it) & 1) == 0) E = En;
      break;
    }
    before = bE;
    E = En;
  }"""
K2_FIXED15 = """  double E = M + e * sin(M);
  for (int it = 0; it < 15; ++it) {
    double sE, cE;
    sincos(E, &sE, &cE);
    const double dE = (E - e * sE - M) / (1.0 - e * cE);
    E = E - clip1(dE);
  }"""
K2_CYCLE = """    if (it > 0 && bn == before) {
      if (((14 - it) & 1) == 0) E = En;
      break;
    }
"""
#: (sine and cosine apart, as in the twin; one sincos() in the kernel)
K2_SINCOS = (
    ("    const double dE = (E - e * sin(E) - M) / (1.0 - e * cos(E));\n"
     "    const double En",
     "    double sE, cE;\n    sincos(E, &sE, &cE);\n"
     "    const double dE = (E - e * sE - M) / (1.0 - e * cE);\n"
     "    const double En"),
    ("  f.sinE = sin(E);\n  f.cosE = cos(E);",
     "  sincos(E, &f.sinE, &f.cosE);"),
    ("  f.sE2 = sin(E / 2.0);\n  f.cE2 = cos(E / 2.0);",
     "  sincos(E / 2.0, &f.sE2, &f.cE2);"),
    ("  f.so = sin(f.omega);\n  f.co = cos(f.omega);",
     "  sincos(f.omega, &f.so, &f.co);"),
    ("  f.sopn = sin(opn);\n  f.copn = cos(opn);",
     "  sincos(opn, &f.sopn, &f.copn);"),
)
K2_PRIMAL_2D = """template <int MODE, bool ORB>
__global__ void dd_binary_primal(const double* __restrict__ tt0,
                                 const double* __restrict__ params,
                                 const double* __restrict__ d_a1,
                                 const double* __restrict__ d_om,
                                 const double* __restrict__ sini,
                                 const double* __restrict__ orb,
                                 const double* __restrict__ pbp, int b0,
                                 int N, double* __restrict__ delay) {
  __shared__ double row[NPAR];
  const long b = (long)b0 + blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const long idx = b * N + n;
  const double t = n < N ? tt0[idx] : 0.0;
  Toa x{0.0, 0.0, 0.0, 0.0, 0.0};
  if constexpr (MODE == DDK || MODE == BTX || ORB) {
    if (n < N) x = load_toa<MODE, ORB>(d_a1, d_om, sini, orb, pbp, idx);
  }
  if (threadIdx.x < NPAR) row[threadIdx.x] = params[b * NPAR + threadIdx.x];
  __syncthreads();
  if (n >= N) return;
  double p[NPAR];
#pragma unroll
  for (int i = 0; i < NPAR; ++i) p[i] = row[i];"""
K2_PRIMAL_1D = """template <int MODE, bool ORB>
__global__ void dd_binary_primal(const double* __restrict__ tt0,
                                 const double* __restrict__ params,
                                 const double* __restrict__ d_a1,
                                 const double* __restrict__ d_om,
                                 const double* __restrict__ sini,
                                 const double* __restrict__ orb,
                                 const double* __restrict__ pbp, int B,
                                 int N, double* __restrict__ delay) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  double p[NPAR];
#pragma unroll
  for (int i = 0; i < NPAR; ++i) p[i] = params[b * NPAR + i];
  const double t = tt0[idx];
  const Toa x = load_toa<MODE, ORB>(d_a1, d_om, sini, orb, pbp, idx);"""
K2_PREFETCH = """  const double t = n < N ? tt0[idx] : 0.0;
  Toa x{0.0, 0.0, 0.0, 0.0, 0.0};
  if constexpr (MODE == DDK || MODE == BTX || ORB) {
    if (n < N) x = load_toa<MODE, ORB>(d_a1, d_om, sini, orb, pbp, idx);
  }
  if (threadIdx.x < NPAR) row[threadIdx.x] = params[b * NPAR + threadIdx.x];
  __syncthreads();
  if (n >= N) return;
"""
K2_ROW_FIRST = """  if (threadIdx.x < NPAR) row[threadIdx.x] = params[b * NPAR + threadIdx.x];
  __syncthreads();
  if (n >= N) return;
  const double t = tt0[idx];
  const Toa x = load_toa<MODE, ORB>(d_a1, d_om, sini, orb, pbp, idx);
"""
K2_LAUNCH_2D = """    const unsigned nx = (unsigned)((N + THREADS - 1) / THREADS);
    for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
      const unsigned ny = (unsigned)(B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y);
      dd_binary_primal<MODE, ORB><<<dim3(nx, ny), THREADS, 0, st>>>(
          tt0, params, d_a1, d_om, sini, orb, pbp, b0, N, delay);
    }"""
K2_LAUNCH_1D = """    const long total = (long)B * N;
    dd_binary_primal<MODE, ORB><<<(unsigned)((total + THREADS - 1) / THREADS),
                                  THREADS, 0, st>>>(tt0, params, d_a1, d_om,
                                                    sini, orb, pbp, B, N,
                                                    delay);"""
K2_STAGED = """    for (int i = 0; i < NPARTIAL; ++i)
      rows[threadIdx.x * NPARTIAL + i] = P[Mode<MODE, ORB>::column(i)];
  }
  __syncthreads();
  const long n = (total - first < THREADS ? total - first : THREADS) * NPARTIAL;
  double* out = partials + first * NPARTIAL;
  for (long e = threadIdx.x; e < n; e += THREADS) out[e] = rows[e];"""
K2_STRIDED = """    for (int i = 0; i < NPARTIAL; ++i)
      partials[idx * NPARTIAL + i] = P[Mode<MODE, ORB>::column(i)];
  }"""

# ---- K1 ---------------------------------------------------------------------
K1_STAGED = """    for (int i = 0; i < K; ++i) stage[threadIdx.x * KP + i] = f.d[i];
  }
  __syncthreads();
  const int m = (N - n0 < THREADS ? N - n0 : THREADS) * K;
  double* out = partials + ((long)b * N + n0) * K;
  for (int e = threadIdx.x; e < m; e += THREADS)
    out[e] = stage[(e / K) * KP + e % K];"""
K1_STRIDED = """    for (int i = 0; i < K; ++i) partials[idx * K + i] = f.d[i];
  }"""
K1_PREFETCH_PRIMAL = """  const double th = in ? t_hi[n] : 0.0, tl = in ? t_lo[n] : 0.0,
               dl = in ? delay[idx] : 0.0;
  load_row<S, false>(F, pe, b, row);
  if (!in) return;
"""
K1_ROW_FIRST_PRIMAL = """  load_row<S, false>(F, pe, b, row);
  if (!in) return;
  const double th = t_hi[n], tl = t_lo[n], dl = delay[idx];
"""
K1_PREFETCH_DUAL = """  const double th = in ? t_hi[n] : 0.0, tl = in ? t_lo[n] : 0.0,
               d = in ? delay[idx] : 0.0;
  load_row<S, true>(F, pe, b, row);
  if (in) {
"""
K1_ROW_FIRST_DUAL = """  load_row<S, true>(F, pe, b, row);
  if (in) {
    const double th = t_hi[n], tl = t_lo[n], d = delay[idx];
"""
K1_LAUNCH_PRIMAL = """      spin_phase_primal<S><<<grid, THREADS, 0, stream>>>(
          t_hi, t_lo, tdb0, pe, delay, F, b0, N, has_pe, k, f);"""
K1_LAUNCH_RUNTIME_S = """      spin_phase_primal_rt<<<grid, THREADS, 0, stream>>>(
          t_hi, t_lo, tdb0, pe, delay, F, b0, N, S, has_pe, k, f);"""
K1_LAUNCH_TEMPLATE = "template <int S>\ncudaError_t launch("
K1_RUNTIME_S = """// runtime-S primal: one kernel for any S, its row in a runtime-indexed
// array and the Horner coefficients divided per element
__device__ __forceinline__ void spin_phase_math_rt(
    double t_hi, double t_lo, double tdb0, double pe_hi, double pe_lo,
    double delay, const double* F, int S, int has_pe, double& k_out,
    double& f_out) {
  double folds[3];
  int nf = 0;
  folds[nf++] = t_hi;
  double tail = t_lo - delay;
  if (has_pe) {
    double e1, e2;
    day2sec(pe_hi - tdb0, e1, e2);
    folds[nf++] = -e1;
    folds[nf++] = -e2;
    tail = tail - pe_lo * DAY_S;
  }
  const double F0 = F[0];
  double k = 0.0, f = 0.0, dt64 = 0.0;
  for (int i = 0; i < nf; ++i) {
    double ki, fi;
    mul_mod1(F0, folds[i], ki, fi);
    k = k + ki;
    f = f + fi;
    dt64 = dt64 + folds[i];
  }
  dt64 = dt64 + tail;
  f = f + F0 * tail;
  if (S > 1) {
    double acc = 0.0;
    double fact = 1.0;
    for (int i = 2; i <= S; ++i) fact *= (double)i;
    for (int i = S - 1; i >= 1; --i) {
      const double c = F[i] / fact;
      acc = acc * dt64 + c;
      fact /= (double)(i + 1);
    }
    f = f + acc * dt64 * dt64;
  }
  const double kk = rne(f);
  k_out = k + kk;
  f_out = f - kk;
}

__global__ void spin_phase_primal_rt(const double* __restrict__ t_hi,
                                     const double* __restrict__ t_lo,
                                     double tdb0,
                                     const double* __restrict__ pe,
                                     const double* __restrict__ delay,
                                     const double* __restrict__ F, int b0,
                                     int N, int S, int has_pe,
                                     double* __restrict__ k_out,
                                     double* __restrict__ f_out) {
  __shared__ double row[SMAX + 2];
  const long b = (long)b0 + blockIdx.y;
  if (threadIdx.x < S) row[threadIdx.x] = F[b * S + threadIdx.x];
  else if (threadIdx.x < S + 2) row[threadIdx.x] = pe[2 * b + threadIdx.x - S];
  __syncthreads();
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const long idx = b * N + n;
  double Fb[SMAX];
  for (int i = 0; i < S; ++i) Fb[i] = row[i];
  double k, f;
  spin_phase_math_rt(t_hi[n], t_lo[n], tdb0, row[S], row[S + 1], delay[idx],
                     Fb, S, has_pe, k, f);
  k_out[idx] = k;
  f_out[idx] = f;
}

"""

# ---- K3 ---------------------------------------------------------------------
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

# ---- K5 ---------------------------------------------------------------------
K5_TILE = "constexpr int TILE = 128; "
K5_JG = "constexpr int JG = 8; "
K5_ACC = "constexpr int ACC = 4; "
K5_SVD = ("constexpr int SVD_THREADS = 256;\n"
          "constexpr int SVD_BLOCKS = 2; ")
K5_TRAIL = "int lane) {\n  const int g = lane >> 2, q = lane & 3;"
K5_PANEL = "const Shape& sh, int lane) {\n  constexpr int RPL = M / 32;"
K5_SWEEPS = "constexpr int MAX_SWEEPS = 30;"
K5_FOLD_TILE = "// Fold the tile T (M rows, columns 0..k, zero beyond) into R."
#: the unblocked fold: NB = 1, a warp reduction a reflector, and one warp
#: a trailing column (columns j + 1..k) in place of the 8-column mma slices
K5_NB1 = (
    ("constexpr int NB = 8; ", "constexpr int NB = 1; "),
    ('static_assert(NB == 8, "a WY block is one 8-column mma slice");\n', ""),
    ("    warp_sum8(e, lane);\n",
     "    for (int c = 0; c < B; ++c) e[c] = warp_sum(e[c]);\n"),
    ("    const int nq = (sh.kp - j0 - NB) / 8;  // 8-column slices right of it",
     "    const int nq = sh.k - j0;  // columns right of it, c the last"),
    ("      trail_slice<M>(T, R, tw, tw + NB * NB, Wb, j0, j0 + NB, sh, lane);",
     "      trail_column<M>(T, R, tw, tw + NB * NB, j0, j0 + 1, sh, lane);"),
    ("        trail_slice<M>(T, R, tw, tw + NB * NB, Wb, j0, j0 + NB + 8 * u, sh,\n"
     "                       lane);",
     "        trail_column<M>(T, R, tw, tw + NB * NB, j0, j0 + 1 + u, sh, lane);"),
    (K5_FOLD_TILE, """// One warp applies reflector j to column l.
template <int M>
__device__ __forceinline__ void trail_column(double* T, double* R,
                                             const double* Tw,
                                             const double* Al, int j, int l,
                                             const Shape& sh, int lane) {
  const double alpha = Al[0];
  double d = lane == 0 ? alpha * R[j * sh.ldr + l] : 0.0;
#pragma unroll
  for (int r = 0; r < M / 32; ++r) {
    const double* row = T + (lane + 32 * r) * sh.ldt;
    d += row[j] * row[l];
  }
  const double f = Tw[0] * warp_sum(d);
#pragma unroll
  for (int r = 0; r < M / 32; ++r) {
    double* row = T + (lane + 32 * r) * sh.ldt;
    row[l] -= f * row[j];
  }
  if (lane == 0) R[j * sh.ldr + l] -= f * alpha;
}

""" + K5_FOLD_TILE),
)

# ---- K6, K7 -----------------------------------------------------------------
K7_EXPLOG = """      const double lc = log(cp);
      const double v = exp(pm2 * lc);
"""
#: the parent's node loop: pow(), its d/dp term taking its own logarithm
K7_POW = (
    (K7_EXPLOG, "      const double v = pow(cp, pm2);\n"),
    ("acc_p = acc_p + wj[j] * (v * lc);",
     "acc_p = acc_p + wj[j] * (v * log(cp));"),
)
#: sin() and cos() apart, where the kernel takes each pair from sincos()
K7_SINCOS = (
    ("      if constexpr (DUAL)\n        sincos(phi, &sp, &cp);\n"
     "      else\n        cp = cos(phi);\n",
     "      if constexpr (DUAL) sp = sin(phi);\n      cp = cos(phi);\n"),
    ("    sincos(th, &st, &ct);\n", "    st = sin(th);\n    ct = cos(th);\n"),
)
#: the dual's partials staged through shared memory, the block's rows
#: written as one contiguous run (K2's dual's way), in place of each
#: thread's three stride-3 stores
K7_STAGED = (
    ("""  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long)B * N) return;
  double* row = DUAL ? P + 3 * idx : nullptr;  // the element's partials
""", """  __shared__ double rows[DUAL ? 3 * THREADS : 1];
  const long first = (long)blockIdx.x * THREADS;
  const long idx = first + threadIdx.x;
  const long total = (long)B * N;
  double* row = rows + (DUAL ? 3 * threadIdx.x : 0);
  if (idx < total) {
"""),
    ("      row[2] = a;\n    }\n  }\n}\n",
     """      row[2] = a;
    }
  }
  }
  if constexpr (DUAL) {
    __syncthreads();
    const long n = (total - first < THREADS ? total - first : THREADS) * 3;
    double* out = P + first * 3;
    for (long e = threadIdx.x; e < n; e += THREADS) out[e] = rows[e];
  }
}
"""),
)
#: the kernel held to 9 blocks of 128 threads an SM (56 registers)
K7_LB9 = ("template <bool DUAL>\n__global__ void solar_wind_pl_kernel(",
          "template <bool DUAL>\n__global__ void __launch_bounds__(THREADS, 9)"
          "\nsolar_wind_pl_kernel(")
#: blocks of 64 threads in place of 128
K7_T64 = ("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")
K6_BULK = (
    """    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_store(P + first * row, tile, (unsigned)(rows * row * 8));
""")
#: the tile written by the block's threads in a coalesced loop, as K2's
#: dual writes its partials, in place of the TMA bulk store
K6_LOOP = """    __syncthreads();
    double* out = P + first * row;
    for (long e = threadIdx.x; e < rows * row; e += blockDim.x)
      out[e] = tile[e];
"""
#: every width on the direct dual: each row straight to the output
K6_DIRECT = ("  if (smem > max_smem()) {", "  if (true) {")

#: ptxas markers printed per kernel source
MARKERS = {
    "dd_binary": ["dd_binary_primalILi0E", "dd_binary_dualILi0E"],
    "ell1_binary": ["ell1_binary_primalILi0E", "ell1_binary_dualILi0E"],
    "spin_phase": ["17spin_phase_primalILi2E", "17spin_phase_primalILi6E",
                   "17spin_phase_primalE", "20spin_phase_primal_rt",
                   "15spin_phase_dualILi2E", "15spin_phase_dualILi6E"],
    "schur_cholesky_solve": ["kernelILb1E", "kernelILb0E"],
    "wls_lstsq": ["wls_tsqr_fold", "wls_tsqr_svd", "wls_lstsq_global",
                  "wls_lstsq_kernel"],
    "solar_wind_pl": ["solar_wind_pl_kernelILb0E",
                      "solar_wind_pl_kernelILb1E"],
    "binary_orbits": ["binary_orbits_dualILi0ELb1E",
                      "binary_orbits_dualILi0ELb0E",
                      "binary_orbits_dualILi2ELb1E",
                      "binary_orbits_dualILi1ELb1E",
                      "binary_orbits_kernelILi0ELb1E"],
}


def _patch(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"variant no longer applies to the source: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _variants(parent):
    k1 = (CSRC / "spin_phase.cu").read_text()
    k2 = (CSRC / "dd_binary.cu").read_text()
    k3 = (CSRC / "schur_cholesky_solve.cu").read_text()
    k5 = (CSRC / "wls_lstsq.cu").read_text()
    k6 = (CSRC / "binary_orbits.cu").read_text()
    k7 = (CSRC / "solar_wind_pl.cu").read_text()
    out = {
        "solar_wind_pl": {
            "committed": k7,
            "pow": _patch(k7, *K7_POW),
            "sin-and-cos": _patch(k7, *K7_SINCOS),
            "staged": _patch(k7, *K7_STAGED),
            "lb9": _patch(k7, K7_LB9),
            "threads-64": _patch(k7, K7_T64),
        },
        "binary_orbits": {
            "committed": k6,
            "loop-stores": _patch(k6, (K6_BULK, K6_LOOP)),
            "strided-stores": _patch(k6, K6_DIRECT),
        },
        "ell1_binary": {"committed": (CSRC / "ell1_binary.cu").read_text()},
        "dd_binary": {
            "committed": k2,
            "fixed-15": _patch(k2, (K2_EXIT, K2_FIXED15)),
            "exit-period1": _patch(k2, (K2_CYCLE, "")),
            "1d-grid": _patch(k2, (K2_PRIMAL_2D, K2_PRIMAL_1D),
                              (K2_LAUNCH_2D, K2_LAUNCH_1D)),
            "sin-and-cos": _patch(k2, *((b, a) for a, b in K2_SINCOS)),
            "row-first": _patch(k2, (K2_PREFETCH, K2_ROW_FIRST)),
            "strided-stores": _patch(k2, (K2_STAGED, K2_STRIDED)),
        },
        "spin_phase": {
            "committed": k1,
            "runtime-S": _patch(k1, (K1_LAUNCH_TEMPLATE,
                                     K1_RUNTIME_S + K1_LAUNCH_TEMPLATE),
                                (K1_LAUNCH_PRIMAL, K1_LAUNCH_RUNTIME_S)),
            "strided-partials": _patch(k1, (K1_STAGED, K1_STRIDED)),
            "row-first": _patch(k1, (K1_PREFETCH_PRIMAL, K1_ROW_FIRST_PRIMAL),
                                (K1_PREFETCH_DUAL, K1_ROW_FIRST_DUAL)),
        },
        "schur_cholesky_solve": {
            "committed": k3,
            "fused-scale": _patch(k3, (K3_COLUMN, K3_FUSED)),
            "warp-solve": _patch(k3, (K3_SOLVES, K3_WARP_SOLVES)),
        },
        "wls_lstsq": {
            "committed": k5,
            "qr-only": _patch(k5, (K5_SWEEPS,
                                   "constexpr int MAX_SWEEPS = 0;")),
            "nb=1": _patch(k5, *K5_NB1),
            "m=64x1": _patch(k5, (K5_TILE, "constexpr int TILE = 64; ")),
            "jg=4": _patch(k5, (K5_JG, "constexpr int JG = 4; ")),
            "jg=16": _patch(k5, (K5_JG, "constexpr int JG = 16; ")),
            "svd-512": _patch(k5, (K5_SVD,
                                   "constexpr int SVD_THREADS = 512;\n"
                                   "constexpr int SVD_BLOCKS = 1; ")),
            "panel-only": _patch(k5, (K5_TRAIL, K5_TRAIL.replace(
                "{\n", "{\n  return;\n"))),
            "trail-only": _patch(k5, (K5_PANEL, K5_PANEL.replace(
                "{\n", "{\n  return;\n"))),
            "acc=1": _patch(k5, (K5_ACC, "constexpr int ACC = 1; ")),
        },
    }
    if parent is not None:
        pc = Path(parent) / "pint_torch" / "kernels" / "csrc"
        for kernel in ("dd_binary", "spin_phase", "wls_lstsq",
                       "ell1_binary", "solar_wind_pl", "binary_orbits"):
            out[kernel]["parent"] = (pc / f"{kernel}.cu").read_text()
        out["wls_lstsq"]["parent-qr-only"] = _patch(
            out["wls_lstsq"]["parent"],
            (K5_SWEEPS, "constexpr int MAX_SWEEPS = 0;"))
    return out


def _time_ms(fn, iters: int = 20) -> float:
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # a spin kernel holds the stream while the host queues the timed
    # launches, so that the events see them back to back (the device's
    # time, not the host's launch rate)
    torch.cuda._sleep(int(2 * enqueue_s * 2e9) + 1000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _main_path_inputs():
    """K1's and K2's largest calls on the B1855 stand-in's main path (GLS
    fit, then the M2 x SINI grid), captured as ``chip_smoke.py`` does."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import Capture
    from pint_torch import kernels
    from pint_torch.bridge import STANDIN_PATH, load_snapshot, read_snapshot
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    _, ref = read_snapshot(STANDIN_PATH)
    cap = Capture({n: m for n, m in kernels.modules().items()
                   if n != "schur_cholesky_solve"})
    cap.install()
    try:
        model, batch = load_snapshot(STANDIN_PATH, device="cuda")
        fitter = GLSFitter(batch, model)
        fitter.fit_toas(maxiter=2)
        grid_chisq(fitter, ("M2", "SINI"),
                   (ref["ref/grid_m2"], ref["ref/grid_sini"]), niter=1,
                   chunk=256)
    finally:
        cap.remove()
    return cap


def _ell1_inputs(full: bool = False):
    """K5's largest call on the ELL1 stand-in's main path (WLS fit, then
    the ``niter=4`` M2 x SINI grid), captured as ``chip_smoke.py`` does;
    with ``full``, the capture of K4's calls as well."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import Capture
    from pint_torch.bridge import ELL1_PATH, load_snapshot, read_snapshot
    from pint_torch.fitter import WLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.kernels import wls_lstsq

    _, ref = read_snapshot(ELL1_PATH)
    from pint_torch.kernels import ell1_binary

    cap = Capture({"wls_lstsq": wls_lstsq, "ell1_binary": ell1_binary})
    cap.install()
    try:
        model, batch = load_snapshot(ELL1_PATH, device="cuda")
        fitter = WLSFitter(batch, model)
        fitter.fit_toas(maxiter=2)
        grid_chisq(fitter, ("M2", "SINI"),
                   (ref["ref/grid_m2"], ref["ref/grid_sini"]), niter=4,
                   chunk=256)
    finally:
        cap.remove()
    return cap if full else cap.args("wls_lstsq")[:2]


def _rounds(names):
    """Two rounds, the second in reverse order."""
    return [(0, n) for n in names] + [(1, n) for n in reversed(names)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier tree whose "
                    "kernel sources run as the variant 'parent'")
    ap.add_argument("--only", default="K1,K2,K3,K5",
                    help="comma-separated subset of K1,K2,K3,K4,K5,K6,K7 "
                    "(K4: its ELL1 primal and dual against --parent's)")
    args = ap.parse_args()
    only = set(args.only.split(","))
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
    wanted = {"K1": "spin_phase", "K2": "dd_binary",
              "K3": "schur_cholesky_solve", "K4": "ell1_binary",
              "K5": "wls_lstsq", "K6": "binary_orbits",
              "K7": "solar_wind_pl"}
    procs, libs = {}, {}
    #: K2 sources from before its modes (a parent tree): the launch takes
    #: no mode and no per-TOA inputs; K2 and K4 sources from before their
    #: orbit inputs take no orbits and pbprime
    k2_untemplated = set()
    no_orbits = set()
    all_variants = _variants(args.parent)
    variants_src = all_variants.get("dd_binary", {})
    #: a parent that built K7 with contraction on (for its pow()) builds
    #: it so here too
    contracted = args.parent is not None and "CONTRACTED = (\"solar_wind_pl" \
        in (Path(args.parent) / "pint_torch" / "kernels" /
            "_build.py").read_text()
    for kernel, variants in all_variants.items():
        if kernel not in {wanted[k] for k in only}:
            continue
        for name, src in variants.items():
            if kernel == "dd_binary" and "int mode" not in src:
                k2_untemplated.add(name)
            if "const double* orb" not in src:
                no_orbits.add((kernel, name))
            cu = work / f"{kernel}-{name}.cu"
            cu.write_text(src)
            flags = _build.NVCC_FLAGS
            if contracted and kernel == "solar_wind_pl" and name == "parent":
                flags = tuple("-fmad=true" if f == "-fmad=false" else f
                              for f in flags)
            procs[(kernel, name)] = subprocess.Popen(
                [_build._nvcc(), *flags, "-I", str(CSRC), "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {kernel} {name}:\n{log}")
        libs[(kernel, name)] = ctypes.CDLL(
            str(work / f"{kernel}-{name}.so"))
        for marker in MARKERS[kernel]:
            r = _build.ptxas_report(log, marker)
            if r is not None:
                print(f"ptxas {kernel} {name} {marker.lstrip('0123456789')}: "
                      f"{r[0]} registers, {r[1]} bytes stack frame, {r[2]} "
                      f"bytes spill stores, {r[3]} bytes spill loads",
                      flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def rt(*shape, lo=-1.0, hi=1.0):
        return torch.rand(*shape, generator=gen, dtype=torch.float64,
                          device=dev) * (hi - lo) + lo

    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    def compare(label, kernel, names, make_run, outputs):
        """Time each variant in two rounds; outputs bitwise against the
        first one run (the committed source)."""
        ref = None
        for rnd, name in _rounds(names):
            run = make_run(libs[(kernel, name)])
            if run() != 0:
                raise SystemExit(f"{kernel} {name}: launch failed")
            torch.cuda.synchronize()
            out = [torch.nan_to_num(o, nan=7.0) if o.is_floating_point()
                   else o.clone() for o in outputs]
            if ref is None:
                ref = out
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"round {rnd} {label} {name}: {_time_ms(run):.4f} ms, "
                  f"bitwise as committed {same} [{card}]", flush=True)

    if only & {"K1", "K2"}:
        cap = _main_path_inputs()

    if "K2" in only:
        tt0, params = cap.args("dd_binary", (0, False))[:2]
        tt0d, paramsd = cap.args("dd_binary", (0, True))[:2]
        hi_e = params.clone()
        hi_e[:, 5] = rt(len(hi_e), lo=0.55, hi=0.65)
        hi_e[:, 7] = rt(len(hi_e), lo=0.0, hi=360.0)
        names = [n for k, n in libs if k == "dd_binary"]
        primal = [n for n in names if n != "strided-stores"]
        dual = [n for n in names
                if n not in ("exit-period1", "1d-grid", "row-first")]
        for label, t, p, part, vs in (
                ("dd_binary_primal b1855", tt0, params, False, primal),
                ("dd_binary_primal ecc0.6", tt0, hi_e, False, primal),
                ("dd_binary_dual b1855", tt0d, paramsd, True, dual)):
            B, N = t.shape
            delay = torch.empty(B, N, dtype=torch.float64, device=dev)
            P = torch.empty(B, N, 17, dtype=torch.float64, device=dev) \
                if part else None

            def make_run(lib, t=t, p=p, B=B, N=N, delay=delay, P=P):
                fn = lib.dd_binary_launch
                fn.restype = ci
                if any(lib is libs[("dd_binary", n)]
                       for n in k2_untemplated):
                    fn.argtypes = [vp, vp, ci, ci, vp, vp, vp]
                    return lambda: fn(ptr(t), ptr(p), B, N, ptr(delay),
                                      ptr(P), stream)
                if any(lib is libs[k] for k in no_orbits):
                    fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp,
                                   vp]
                    return lambda: fn(ptr(t), ptr(p), B, N, 0, None, None,
                                      None, ptr(delay), ptr(P), stream)
                fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp,
                               vp, vp]
                return lambda: fn(ptr(t), ptr(p), B, N, 0, None, None, None,
                                  None, None, ptr(delay), ptr(P), stream)

            compare(f"{label} B={B} N={N}", "dd_binary",
                    ["committed"] + [v for v in vs if v != "committed"],
                    make_run, [delay] + ([P] if part else []))

        # BT's and DDK's duals on the same call (BT reading the DD row, DDK
        # with seeded per-TOA inputs and the row's SINI as its sini),
        # against a parent that has the modes: the delay bitwise, the
        # partials bitwise (a parent that writes a column for every row
        # entry, at the committed columns)
        if ("dd_binary", "parent") in libs and "parent" not in k2_untemplated:
            from pint_torch.kernels import dd_binary as K2

            B, N = tt0d.shape
            toa = (rt(B, N, lo=-1e-7, hi=1e-7), rt(B, N, lo=-1e-6, hi=1e-6),
                   paramsd[:, 10:11].expand(B, N).contiguous())
            for mode in (K2.BT, K2.DDK):
                cols = list(K2.partial_columns(mode))
                x = toa if mode == K2.DDK else (None, None, None)
                runs, outs = {}, {}
                every = "::column(" not in variants_src["parent"]
                for name in ("committed", "parent"):
                    width = len(cols) if name == "committed" or not every \
                        else len(K2.DD_PARAMS) + 1 + (3 if mode == K2.DDK
                                                      else 0)
                    d = torch.empty(B, N, dtype=torch.float64, device=dev)
                    P = torch.empty(B, N, width, dtype=torch.float64,
                                    device=dev)
                    fn = libs[("dd_binary", name)].dd_binary_launch
                    orbs = () if ("dd_binary", name) in no_orbits \
                        else (None, None)
                    fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp] \
                        + [vp] * len(orbs) + [vp, vp, vp]
                    fn.restype = ci
                    runs[name] = (lambda fn=fn, d=d, P=P, orbs=orbs: fn(
                        ptr(tt0d), ptr(paramsd), B, N, mode,
                        *(ptr(v) for v in x), *orbs, ptr(d), ptr(P), stream))
                    if runs[name]() != 0:
                        raise SystemExit(f"dd_binary {name}: launch failed")
                    torch.cuda.synchronize()
                    outs[name] = [torch.nan_to_num(d, nan=7.0),
                                  torch.nan_to_num(
                                      P[..., cols] if name == "parent"
                                      and every else P, nan=7.0)]
                same = all(torch.equal(a, b) for a, b in
                           zip(outs["parent"], outs["committed"]))
                for rnd, name in _rounds(["committed", "parent"]):
                    print(f"round {rnd} {K2.KERNELS[(mode, True)]} b1855 "
                          f"B={B} N={N} {name}: {_time_ms(runs[name]):.4f} "
                          "ms, "
                          f"bitwise as committed "
                          f"{name == 'committed' or same} [{card}]",
                          flush=True)

    if "K1" in only:
        names = [n for k, n in libs if k == "spin_phase"]
        for part in (False, True):
            th, tl, tdb0, pe, dl, F, has_pe, _ = cap.args("spin_phase", part)
            B, N = dl.shape
            F6 = torch.stack([rt(B, lo=1.0, hi=4000.0),
                              rt(B, lo=-1e-13, hi=0.0)]
                             + [rt(B) * 10.0 ** (-3 - 11 * i)
                                for i in range(2, 6)], dim=1)
            vs = [n for n in names
                  if n != ("runtime-S" if part else "strided-partials")]
            for S, FS in ((F.shape[1], F), (6, F6)):
                k = torch.empty(B, N, dtype=torch.float64, device=dev)
                f = torch.empty_like(k)
                P = torch.empty(B, N, S + 2, dtype=torch.float64,
                                device=dev) if part else None

                def make_run(lib, FS=FS, S=S, k=k, f=f, P=P):
                    fn = lib.spin_phase_launch
                    fn.argtypes = [vp, vp, ctypes.c_double, vp, vp, vp, ci,
                                   ci, ci, ci, vp, vp, vp, vp]
                    fn.restype = ci
                    return lambda: fn(ptr(th), ptr(tl), float(tdb0), ptr(pe),
                                      ptr(dl), ptr(FS), B, N, S,
                                      int(bool(has_pe)), ptr(k), ptr(f),
                                      ptr(P), stream)

                label = (f"spin_phase_{'dual' if part else 'primal'} "
                         f"{'b1855' if FS is F else 'random'} S={S} B={B} "
                         f"N={N}")
                compare(label, "spin_phase",
                        ["committed"] + [v for v in vs if v != "committed"],
                        make_run, [k, f] + ([P] if part else []))

    if "K3" in only:
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
            x = torch.empty(B, nt, dtype=torch.float64, device=dev)
            ok = torch.empty(B, dtype=torch.bool, device=dev)
            cond = torch.empty(B, dtype=torch.float64, device=dev)

            def make_run(lib, nt=nt, B=B, Ar=Ar, rhs=rhs, x=x, ok=ok,
                         cond=cond):
                lib.schur_cholesky_solve_workspace.argtypes = [ci]
                lib.schur_cholesky_solve_workspace.restype = ctypes.c_longlong
                fn = lib.schur_cholesky_solve_launch
                fn.argtypes = [vp, vp, ctypes.c_double, ci, ci, vp, vp, vp,
                               vp, vp]
                fn.restype = ci
                per = lib.schur_cholesky_solve_workspace(nt)
                ws = torch.empty(B * per, dtype=torch.float64, device=dev) \
                    if per else None
                return lambda: fn(ptr(Ar), ptr(rhs), 1e-12, B, nt, ptr(ws),
                                  ptr(x), ptr(ok), ptr(cond), stream)

            compare(f"schur_cholesky_solve nt={nt}", "schur_cholesky_solve",
                    names, make_run, [x, ok, cond])

    if "K4" in only:
        k4_variants(libs, no_orbits, card, dev, vp, ci, stream, ptr, compare)

    if "K5" in only:
        k5_variants(libs, card, dev, vp, ci, stream, ptr)

    if only & {"K6", "K7"}:
        k6_k7_variants(libs, only, card, dev, vp, ci, stream, ptr)
    return 0


def k4_variants(libs, no_orbits, card, dev, vp, ci, stream, ptr, compare):
    """K4's ELL1 primal and dual on the ELL1 stand-in's main-path call,
    the committed source beside a parent's (from before the orbit inputs,
    whose launch takes no orbits), outputs bitwise."""
    import torch

    cap = _ell1_inputs(full=True)
    names = [n for k, n in libs if k == "ell1_binary"]
    for partials in (False, True):
        t, p = cap.args("ell1_binary", (0, partials))[:2]
        B, N = t.shape
        delay = torch.empty(B, N, dtype=torch.float64, device=dev)
        P = torch.empty(B, N, 14, dtype=torch.float64, device=dev) \
            if partials else None

        def make_run(lib, t=t, p=p, B=B, N=N, delay=delay, P=P):
            fn = lib.ell1_binary_launch
            fn.restype = ci
            if any(lib is libs[k] for k in no_orbits):
                fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
                return lambda: fn(ptr(t), ptr(p), B, N, 0, 7, 0, ptr(delay),
                                  ptr(P), stream)
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
            return lambda: fn(ptr(t), ptr(p), None, None, B, N, 0, 7, 0,
                              ptr(delay), ptr(P), stream)

        compare(f"ell1_binary_{'dual' if partials else 'primal'} ell1 B={B} "
                f"N={N}", "ell1_binary",
                ["committed"] + [n for n in names if n != "committed"],
                make_run, [delay] + ([P] if partials else []))


def k5_variants(libs, card, dev, vp, ci, stream, ptr):
    """K5's variants on the ELL1 path's call, each checked against the twin
    (x within 1e-9 of max|x| per point, singular values within 1e-12 of
    s_max, the same NaN flags) except the ``qr-only`` ones, and timed."""
    import torch

    from pint_torch.kernels import wls_lstsq as K5

    Aw, rw = _ell1_inputs()
    P, N, k = Aw.shape
    xr, sr, _ = K5.wls_lstsq_reference(Aw, rw)
    x = torch.empty(P, k, dtype=torch.float64, device=dev)
    sv, norms = torch.empty_like(x), torch.empty_like(x)
    sweeps = torch.empty(P, dtype=torch.int32, device=dev)
    runs = []
    for name in [n for kk, n in libs if kk == "wls_lstsq"]:
        lib = libs[("wls_lstsq", name)]
        fn = lib.wls_lstsq_launch
        if name.startswith("parent"):
            fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
            work = torch.empty(P, k, N, dtype=torch.float64, device=dev)
            rwork = torch.empty(P, N, dtype=torch.float64, device=dev)
            runs.append((name, lambda fn=fn, work=work, rwork=rwork: fn(
                ptr(Aw), ptr(rw), P, N, k, ptr(work), ptr(rwork), None,
                ptr(x), ptr(sv), ptr(norms), ptr(sweeps), stream)))
            continue
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, ci, vp]
        lib.wls_lstsq_ws_doubles.argtypes = [ci]
        ws = torch.empty(P * lib.wls_lstsq_ws_doubles(k), dtype=torch.float64,
                         device=dev)
        runs.append((name, lambda fn=fn, ws=ws: fn(
            ptr(Aw), ptr(rw), P, N, k, ptr(ws), ptr(x), ptr(sv), ptr(norms),
            ptr(sweeps), 3, stream)))
    fin = ~torch.isnan(xr).any(dim=1)
    for rnd, (label, run) in _rounds(runs):
        if run() != 0:
            raise SystemExit(f"wls_lstsq {label}: launch failed")
        torch.cuda.synchronize()
        if "only" in label:
            check = "not checked (a part of the work skipped)"
        else:
            nan = bool(torch.equal(torch.isnan(x), torch.isnan(xr))) and \
                bool(torch.equal(torch.isnan(sv), torch.isnan(sr)))
            x_rel = float(((x[fin] - xr[fin]).abs().amax(dim=1)
                           / xr[fin].abs().amax(dim=1)).max())
            s_rel = float(((sv[fin] - sr[fin]).abs().amax(dim=1)
                           / sr[fin, 0]).max())
            ok = nan and x_rel <= 1e-9 and s_rel <= 1e-12
            check = (f"x rel {x_rel:.3e}, sv rel {s_rel:.3e}, NaN flags "
                     f"equal {nan}: {'holds' if ok else 'FAILS'} the bars")
            if not ok:
                raise SystemExit(f"wls_lstsq {label} disagrees with the twin")
        swp = sweeps.double()
        print(f"round {rnd} wls_lstsq P={P} N={N} k={k} {label}: "
              f"{_time_ms(run, 5):.4f} ms; sweeps mean {float(swp.mean()):.4f}"
              f"; {check} [{card}]", flush=True)


def _path_capture(path, modules):
    """The calls of ``modules``' kernels on one stand-in's main path --
    the fit the reference ran (GLS with correlated noise, else WLS, at the
    snapshot's ``maxiter``), then its grid where it has one --, captured
    as ``chip_smoke.py`` does (the largest call of each)."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import Capture, _grid_of
    from pint_torch.bridge import load_snapshot, read_snapshot
    from pint_torch.fitter import WLSFitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    meta, ref = read_snapshot(path)
    settings = meta["reference"]["settings"]
    cap = Capture(modules)
    cap.install()
    try:
        model, batch = load_snapshot(path, device="cuda")
        fitter = (GLSFitter if model.has_correlated_errors
                  else WLSFitter)(batch, model)
        fitter.fit_toas(maxiter=settings["fit_maxiter"])
        grid = _grid_of(meta, ref)
        if grid is not None:
            grid_chisq(fitter, *grid, niter=settings["grid_niter"],
                       chunk=256)
    finally:
        cap.remove()
    return cap


def _col_rel(a, b) -> float:
    """Largest gap of ``a`` to ``b`` over each last-axis column's largest
    |b| (the partials' bar)."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return float(((a - b).abs().amax(dim=0)
                  / b.abs().amax(dim=0).clamp(min=1e-300)).max())


def k6_k7_variants(libs, only, card, dev, vp, ci, stream, ptr):
    """K7 on the pta path's calls and K6's three duals (FBX on bw, waves on
    an FBX base on bw_waves, on a PB base on small_dd_fbx) and FBX primal,
    each variant beside the committed source in two rounds: the geometry,
    orbits and pbprime bitwise as committed (``pow`` and the parent's K7,
    whose powers round otherwise, within 1e-13 of each value), the
    partials within 1e-10 of each column's largest."""
    import torch

    from pint_torch.bridge import (BW_PATH, BW_WAVES_PATH,
                                   DD_FBX_SMALL_PATH, PTA_PATH)
    from pint_torch.kernels import binary_orbits as K6
    from pint_torch.kernels import solar_wind_pl as K7

    def run_all(label, kernel, names, make_run, n_exact, loose=()):
        runs, ref = {}, None
        for name in names:
            run, outs = make_run(libs[(kernel, name)])
            if run() != 0:
                raise SystemExit(f"{kernel} {name}: launch failed")
            torch.cuda.synchronize()
            outs = [o.clone() for o in outs]
            if ref is None:
                ref = outs
            exact = all(torch.equal(a, b)
                        for a, b in zip(outs[:n_exact], ref[:n_exact]))
            gap = max((float(((a - b).abs() / b.abs().clamp(
                min=1e-300)).max()) for a, b in
                zip(outs[:n_exact], ref[:n_exact])), default=0.0)
            prel = max((_col_rel(a, b) for a, b in
                        zip(outs[n_exact:], ref[n_exact:])), default=0.0)
            ok = (exact or (name in loose and gap <= 1e-13)) \
                and prel <= 1e-10
            runs[name] = (run, f"bitwise as committed {exact}, max rel "
                          f"{gap:.3e}, partials max rel {prel:.3e}")
            if not ok:
                raise SystemExit(f"{label} {name} misses its bars: "
                                 f"{runs[name][1]}")
        for rnd, name in _rounds(names):
            run, note = runs[name]
            print(f"round {rnd} {label} {name}: {_time_ms(run):.4f} ms, "
                  f"{note} [{card}]", flush=True)

    if "K7" in only:
        cap = _path_capture(PTA_PATH, {"solar_wind_pl": K7})
        names = [n for k, n in libs if k == "solar_wind_pl"]
        for partials in (False, True):
            r, th, p, ii, win, _ = cap.args("solar_wind_pl", partials)
            B, N = th.shape
            w32 = None if win is None else win.to(torch.int32).contiguous()
            gl = K7._gl(dev)
            geom = torch.empty(B, N, dtype=torch.float64, device=dev)
            P = torch.empty(B, N, 3, dtype=torch.float64, device=dev) \
                if partials else None

            def make_run(lib, r=r, th=th, p=p, ii=ii, w32=w32, B=B, N=N,
                         geom=geom, P=P):
                fn = lib.solar_wind_pl_launch
                fn.argtypes = [vp] * 6 + [ci] * 3 + [vp] * 3
                fn.restype = ci
                return (lambda: fn(ptr(r), ptr(th), ptr(p), ptr(ii),
                                   ptr(w32), ptr(gl), B, N, p.shape[1],
                                   ptr(geom), ptr(P), stream),
                        [geom] + ([P] if partials else []))

            vs = [n for n in names if partials or n != "staged"]
            inside = N if win is None else int((win >= 0).sum())
            run_all(f"{K7.KERNELS[partials]} pta B={B} N={N} ({inside} "
                    "TOAs in a window)", "solar_wind_pl", vs, make_run, 1,
                    loose=("pow", "parent"))

    if "K6" in only:
        names = [n for k, n in libs if k == "binary_orbits"]
        for form, path, label in ((K6.FBX, BW_PATH, "bw"),
                                  (K6.WAVES_FBX, BW_WAVES_PATH, "bw_waves"),
                                  (K6.WAVES_PB, DD_FBX_SMALL_PATH,
                                   "small_dd_fbx")):
            cap = _path_capture(path, {"binary_orbits": K6})
            for partials in ((False, True) if form == K6.FBX else (True,)):
                tt0, coef, _, nfb, nw, off, _ = cap.args(
                    "binary_orbits", (form, partials))
                B, N = tt0.shape
                o = torch.empty(B, N, dtype=torch.float64, device=dev)
                pb = torch.empty_like(o)
                P = torch.empty(B, N, 2, 1 + coef.shape[1],
                                dtype=torch.float64, device=dev) \
                    if partials else None

                def make_run(lib, tt0=tt0, coef=coef, nfb=nfb, nw=nw,
                             off=off, B=B, N=N, o=o, pb=pb, P=P, form=form):
                    fn = lib.binary_orbits_launch
                    fn.argtypes = [vp, vp, ci, ci, ci, ci, ci,
                                   ctypes.c_double, vp, vp, vp, vp]
                    fn.restype = ci
                    return (lambda: fn(ptr(tt0), ptr(coef), B, N, form, nfb,
                                       nw, off, ptr(o), ptr(pb), ptr(P),
                                       stream),
                            [o, pb] + ([P] if partials else []))

                vs = names if partials else \
                    [n for n in names if n in ("committed", "parent")]
                run_all(f"{K6.KERNELS[(form, partials)]} {label} B={B} "
                        f"N={N} nfb={nfb} nwaves={nw}", "binary_orbits", vs,
                        make_run, 2)


if __name__ == "__main__":
    sys.exit(main())
