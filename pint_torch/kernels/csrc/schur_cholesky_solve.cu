// K3 schur_cholesky_solve: the per-point solve of the grid's marginalized
// (Schur-complement) timing system, for any nt.
//
// Replaces the tail of pint_tpu/grid.py:build_grid_gls_chi2_fn.chi2_point
// .gn_step (grid.py:737-765), CPU branch: an = sqrt(max(diag(Ar), 1e-300)),
// Arn = Ar / (an an^T) + ridge I, Cholesky, cho_solve of rhs/an, x/an, the
// ok flag (every entry of x finite; otherwise x is poisoned to NaN) and the
// condition proxy (max diag(L) / max(min diag(L), 1e-300))^2.  A pivot that
// is not positive (or NaN) marks the point failed: x NaN, ok 0, cond NaN --
// what the reference's NaN-filled factor produces.
//
// Design.  One CTA of 256 threads per grid point; a blocked right-looking
// Cholesky over panels of PANEL = 32 columns.  Per panel: each column is
// scaled by its pivot and its rank-1 update is applied to the panel's
// remaining columns (all rows, one lane per column, warps over rows; two
// __syncthreads per column); then every trailing entry (i, c) right of the
// panel takes the panel's 32 products in one pass, s = s - L[i][j] L[c][j]
// in increasing j, with L[c][*] held in the lane's registers.  The forward
// and back solves are parallel over rows, one __syncthreads per step.
// Every entry of L and of the solution therefore sees its products one at
// a time, in increasing k, exactly as in the plain twin's right-looking
// loops (no split sums, no tree reductions, no DMMA), and -fmad=false
// rounds each product alone: kernel and twin agree bitwise.
//
// Two regimes, one source (template kShared):
//  * the lower triangle, with an odd row stride (bank-conflict free) and
//    four vectors (an, y, z, diag L), fits in the 227 KB of a block's
//    dynamic shared memory (nt <= 167): the matrix lives there and the
//    panels are factored in place;
//  * above that the normalized matrix and the vectors live in a per-point
//    workspace in device memory that the wrapper allocates (nt^2 + 4 nt
//    doubles per point; the kernel allocates nothing).  Each panel (rows
//    p0..nt-1, up to 32 columns) is staged in shared memory, factored
//    there and written back; the trailing update reads and writes the
//    workspace (L2-resident for a chunk's worth of points at nt ~ 232).
//    The panel narrows as nt grows (8 (P+1) nt bytes of shared memory), so
//    the launch is refused only past nt ~ 29,000, a 6.7 GB matrix per
//    point; at the grid's chunk of 256 points the card's memory runs out
//    long before (nt ~ 4,400).
//
// Bound on this card: per point it reads nt^2 + nt doubles (62 KB at
// nt = 88) against nt^3/3 + 4 nt^2 ~ 0.26 MFLOP, ~4 f64 operations per
// byte, so the batch is bound by bytes on paper.  In practice the kernel is
// bound by latency: the chain of ~4 nt __syncthreads steps (two per
// factored column, one per solve step), each carrying an f64 division or
// square root; the trailing updates, where the arithmetic is, overlap
// across warps.  In the global regime the solves' loads of L come from L2.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PANEL = 32;
// room left for the kernel's static shared variables
constexpr int STATIC_SMEM = 256;

template <bool kShared>
__global__ void __launch_bounds__(THREADS, 2)
schur_cholesky_kernel(const double* __restrict__ Ar,
                      const double* __restrict__ rhs, double ridge, int nt,
                      int ld, int P, double* __restrict__ ws,
                      double* __restrict__ x, unsigned char* __restrict__ ok,
                      double* __restrict__ cond) {
  extern __shared__ double smem[];
  __shared__ int bad;
  __shared__ int solved;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const double* Ab = Ar + (long)b * nt * nt;
  double* A;      // lower triangle, row stride ld; L overwrites it
  double* stage;  // the staged panel (global regime), row stride P + 1
  if constexpr (kShared) {
    A = smem;
    stage = nullptr;
  } else {
    A = ws + (long)b * ((long)nt * ld + 4L * nt);
    stage = smem;
  }
  double* an = A + (long)nt * ld;  // diag scaling
  double* y = an + nt;             // working / final vectors of the solves
  double* z = y + nt;
  double* dL = z + nt;             // diag(L)
  const int sp = P + 1;
  if (tid == 0) bad = 0;
  for (int i = tid; i < nt; i += THREADS) {
    const double d = Ab[(long)i * nt + i];
    an[i] = sqrt(d < 1e-300 ? 1e-300 : d);  // max that keeps NaN
  }
  __syncthreads();
  for (int i = warp; i < nt; i += NWARPS) {
    const double ai = an[i];
    for (int j = lane; j <= i; j += 32) {
      double v = Ab[(long)i * nt + j] / (ai * an[j]);
      if (i == j) v = v + ridge;
      A[(long)i * ld + j] = v;
    }
    if (lane == 0) y[i] = rhs[(long)b * nt + i] / ai;
  }
  __syncthreads();

  for (int p0 = 0; p0 < nt; p0 += P) {
    const int p1 = min(p0 + P, nt);
    const int w = p1 - p0;
    // panel element (i, jj): row i >= p0, column p0 + jj
    auto pv = [&](int i, int jj) -> double& {
      if constexpr (kShared) return A[(long)i * ld + p0 + jj];
      else return stage[(i - p0) * sp + jj];
    };
    if constexpr (!kShared) {
      for (int i = p0 + warp; i < nt; i += NWARPS)
        if (lane < w && p0 + lane <= i)
          pv(i, lane) = A[(long)i * ld + p0 + lane];
      __syncthreads();
    }
    for (int j = p0; j < p1; ++j) {
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
    }
    if constexpr (!kShared) {
      for (int i = p0 + warp; i < nt; i += NWARPS)
        if (lane < w && p0 + lane <= i)
          A[(long)i * ld + p0 + lane] = pv(i, lane);
    }
    // trailing update: every (i, c) with p1 <= c <= i takes the panel
    if (p1 < nt) {
      for (int c0 = p1; c0 < nt; c0 += 32) {
        const int c = c0 + lane;
        double lc[PANEL];
#pragma unroll
        for (int q = 0; q < PANEL; ++q)
          lc[q] = (q < w && c < nt) ? pv(c, q) : 0.0;
        for (int i = c0 + warp; i < nt; i += NWARPS) {
          if (c <= i) {
            double s = A[(long)i * ld + c];
#pragma unroll
            for (int q = 0; q < PANEL; ++q)
              if (q < w) s = s - pv(i, q) * lc[q];
            A[(long)i * ld + c] = s;
          }
        }
      }
    }
    __syncthreads();
  }

  // forward substitution L z = y (column-oriented; y working, z final)
  for (int k = 0; k < nt; ++k) {
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
  }
  for (int i = tid; i < nt; i += THREADS) y[i] = y[i] / an[i];
  __syncthreads();
  if (tid == 0) {
    int fin = !bad;
    for (int k = 0; k < nt; ++k) fin = fin && isfinite(y[k]);
    double dmax = dL[0], dmin = dL[0];
    int dnan = 0;
    for (int k = 0; k < nt; ++k) {
      const double d = dL[k];
      dnan = dnan || isnan(d);
      dmax = d > dmax ? d : dmax;
      dmin = d < dmin ? d : dmin;
    }
    const double r = dmax / (dmin < 1e-300 ? 1e-300 : dmin);
    ok[b] = (unsigned char)fin;
    cond[b] = (bad || dnan) ? nan("") : r * r;
    solved = fin;
  }
  __syncthreads();
  for (int i = tid; i < nt; i += THREADS)
    x[(long)b * nt + i] = solved ? y[i] : nan("");
}

// The plan for one nt: shared-memory bytes of each regime and the panel
// width of the global one.
struct Plan {
  bool shared;
  int ld;
  int panel;
  size_t smem;
};

cudaError_t make_plan(int nt, Plan* plan) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  optin -= STATIC_SMEM;
  const int ld = nt | 1;
  const size_t in_shared = ((size_t)nt * ld + 4 * (size_t)nt) * sizeof(double);
  if (in_shared <= (size_t)optin) {
    *plan = Plan{true, ld, PANEL, in_shared};
    return cudaSuccess;
  }
  const long fit = (long)optin / ((long)nt * (long)sizeof(double)) - 1;
  if (fit < 1) return cudaErrorInvalidValue;
  const int p = fit < PANEL ? (int)fit : PANEL;
  *plan = Plan{false, nt, p, (size_t)nt * (p + 1) * sizeof(double)};
  return cudaSuccess;
}

}  // namespace

// Doubles of device workspace per point that the launch needs for nt: 0
// when the matrix fits in shared memory; a negative CUDA error code if the
// plan cannot be made.
extern "C" long long schur_cholesky_solve_workspace(int nt) {
  if (nt < 1) return -(long long)cudaErrorInvalidValue;
  Plan plan;
  const cudaError_t e = make_plan(nt, &plan);
  if (e != cudaSuccess) return -(long long)e;
  return plan.shared ? 0 : (long long)nt * nt + 4LL * nt;
}

extern "C" int schur_cholesky_solve_launch(const double* Ar, const double* rhs,
                                           double ridge, int B, int nt,
                                           double* ws, double* x,
                                           unsigned char* ok, double* cond,
                                           void* stream) {
  if (nt < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Plan plan;
  cudaError_t e = make_plan(nt, &plan);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (plan.shared) {
    e = cudaFuncSetAttribute(schur_cholesky_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
    schur_cholesky_kernel<true><<<B, THREADS, plan.smem, st>>>(
        Ar, rhs, ridge, nt, plan.ld, plan.panel, nullptr, x, ok, cond);
  } else {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(schur_cholesky_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan.smem);
    if (e != cudaSuccess) return (int)e;
    schur_cholesky_kernel<false><<<B, THREADS, plan.smem, st>>>(
        Ar, rhs, ridge, nt, plan.ld, plan.panel, ws, x, ok, cond);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* schur_cholesky_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
