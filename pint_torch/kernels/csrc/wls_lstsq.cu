// K5 wls_lstsq: per-point minimum-norm least squares of the normalized
// whitened design matrix, with its singular values.
//
// Replaces jnp.linalg.lstsq in the reference WLS grid's Gauss-Newton step
// (pint_tpu/grid.py:309-321, chi2_point.gn_step): for each point p,
//   norms = ||Aw[:, j]|| (0 -> 1),  An = Aw / norms,
//   x = V diag(mask / s) U^T rw,  mask = s > 0 and s >= eps max(N, k) s_max,
// where An = U diag(s) V^T, and s in descending order.  Torch's CUDA SVD
// batches only matrices up to 32 x 32 and takes the others one library
// call at a time; this kernel takes all P points in one launch.
//
// One block per point, four phases:
//  0. Aw's row-major (N, k) goes into a column-major workspace W (k
//     columns of N) and rw into a second one; a non-finite input anywhere
//     in the point poisons it (x and s NaN, the caller's rung -1).
//  1. Column norms, a warp per column, then each column divided by its
//     norm (zero columns keep norm 1).
//  2. Householder QR of W, a reflector per column: the block reduces the
//     column's norm, then each warp applies the reflector to trailing
//     columns (and to rw) one at a time, a dot product and an update over
//     the N - j rows.  Afterwards R's strict upper triangle is in W's
//     leading rows, its diagonal in `alpha`, and (Q^T rw)[:k] in rw's.
//  3. One-sided Jacobi (Hestenes) SVD of the k x k R: R's columns are
//     rotated in pairs, a warp per pair, in round-robin order (every pair
//     once per sweep, disjoint pairs at once), with V accumulated, until a
//     sweep rotates no pair whose columns' cosine exceeds sqrt(k) eps
//     (LAPACK dgesvj's tolerance; at eps alone the rounding of the dot
//     product itself keeps sweeps going), at most MAX_SWEEPS; a point that
//     still rotates then is poisoned.  Then s_i = ||(R V)_i||, and
//     x = V diag(mask / s^2) (R V)^T (Q^T rw)[:k], the sum of the kept
//     directions.  R and V live in shared memory while 2 k^2 doubles fit
//     (k <= 119), else in a global workspace the wrapper allocates.
//
// The two differ from the reference's LAPACK SVD by rounding, not bitwise;
// chip_smoke.py holds x to 1e-9 of max|x| per point and s to 1e-12 s_max
// against the plain twin (kernels/wls_lstsq.py), with the same rank and
// NaN flags.
//
// Bound on this card.  Per point it must read Aw and rw once (8 N (k + 1)
// bytes) and do ~2 N k^2 operations of QR plus ~9 k^3 per Jacobi sweep:
// bound by operations at the path's shapes.  This first kernel is far
// above that bound: each reflector re-reads the trailing matrix (2.8 MB a
// point at N = 4005, k = 88, beyond the L2 once 132 blocks run), so it is
// bound by those ~k passes over device memory.  A blocked (WY) or
// multi-block (TSQR) factorization is the redesign that removes them.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SWEEPS = 30;
constexpr double EPS = 2.220446049250313e-16;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // every lane holds the same bits: each step adds a pair both ways
}

// Sum over the block, returned to every thread; `scratch` holds WARPS + 1.
__device__ double block_sum(double v, double* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < WARPS ? scratch[lane] : 0.0;
    t = warp_sum(t);
    if (lane == 0) scratch[WARPS] = t;
  }
  __syncthreads();
  const double r = scratch[WARPS];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
    wls_lstsq_kernel(const double* __restrict__ Aw,
                     const double* __restrict__ rw, int N, int k,
                     double* __restrict__ work, double* __restrict__ rwork,
                     double* __restrict__ rv_global, double* __restrict__ x,
                     double* __restrict__ sv, double* __restrict__ norms,
                     int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  __shared__ int rotated;
  double* scratch = smem;               // WARPS + 1
  double* alpha = scratch + WARPS + 1;  // k: R's diagonal
  double* cvec = alpha + k;             // k: (Q^T rw)[:k]
  double* sigma = cvec + k;             // k
  double* coef = sigma + k;             // k
  double* hh = coef + k;                // 1: 2 / v^T v of the reflector
  const long p = blockIdx.x;
  double* R = rv_global != nullptr ? rv_global + p * 2 * k * k : hh + 1;
  double* V = R + (long)k * k;          // both column-major, k x k
  const double* A = Aw + p * N * k;
  const double* b = rw + p * N;
  double* W = work + p * N * k;
  double* c = rwork + p * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 0. transpose into W; copy rw
  int bad = 0;
  const int nk = N * k;
  for (int e = tid; e < nk; e += THREADS) {
    const double a = A[e];
    bad |= !isfinite(a);
    W[(long)(e % k) * N + e / k] = a;
  }
  for (int i = tid; i < N; i += THREADS) {
    const double v = b[i];
    bad |= !isfinite(v);
    c[i] = v;
  }
  bad = __syncthreads_or(bad);
  // 1. column norms, then normalized columns
  for (int j = warp; j < k; j += WARPS) {
    double* col = W + (long)j * N;
    double s = 0.0;
    for (int i = lane; i < N; i += 32) s += col[i] * col[i];
    s = sqrt(warp_sum(s));
    const double nrm = s == 0.0 ? 1.0 : s;
    if (lane == 0) norms[p * k + j] = nrm;
    for (int i = lane; i < N; i += 32) col[i] = col[i] / nrm;
  }
  if (bad) {
    for (int j = tid; j < k; j += THREADS) {
      x[p * k + j] = nan("");
      sv[p * k + j] = nan("");
    }
    if (tid == 0) sweeps_out[p] = 0;
    return;
  }
  __syncthreads();

  // 2. Householder QR; reflector j is stored over column j's rows j..N-1
  for (int j = 0; j < k; ++j) {
    double* vj = W + (long)j * N;
    double s = 0.0;
    for (int i = j + tid; i < N; i += THREADS) s += vj[i] * vj[i];
    s = block_sum(s, scratch);
    if (tid == 0) {
      const double x0 = vj[j];
      const double nrm = sqrt(s);
      double a = 0.0, be = 0.0;
      if (nrm > 0.0) {
        a = x0 >= 0.0 ? -nrm : nrm;
        vj[j] = x0 - a;
        be = 1.0 / (nrm * (nrm + fabs(x0)));  // 2 / v^T v
      }
      alpha[j] = a;
      hh[0] = be;
    }
    __syncthreads();
    const double be = hh[0];
    if (be != 0.0) {
      for (int l = j + 1 + warp; l <= k; l += WARPS) {
        double* col = l < k ? W + (long)l * N : c;
        double d = 0.0;
        for (int i = j + lane; i < N; i += 32) d += vj[i] * col[i];
        d = warp_sum(d) * be;
        for (int i = j + lane; i < N; i += 32) col[i] -= d * vj[i];
      }
    }
    __syncthreads();
  }

  // 3. R and V = I; the Jacobi sweeps
  for (int e = tid; e < k * k; e += THREADS) {
    const int col = e / k, row = e % k;
    R[e] = row < col ? W[(long)col * N + row]
                     : (row == col ? alpha[col] : 0.0);
    V[e] = row == col ? 1.0 : 0.0;
  }
  for (int i = tid; i < k; i += THREADS) cvec[i] = c[i];
  if (tid == 0) rotated = 0;
  __syncthreads();
  const int kk = k + (k & 1);  // an odd k pairs its last column with a bye
  const double tol = EPS * sqrt((double)k);
  bool converged = false;
  int sweep = 0;
  while (sweep < MAX_SWEEPS && !converged) {
    ++sweep;
    for (int r = 0; r < kk - 1; ++r) {
      for (int m = warp; m < kk / 2; m += WARPS) {
        const int pa = m == 0 ? 0 : 1 + (m - 1 + r) % (kk - 1);
        const int pb = 1 + (kk - 2 - m + r) % (kk - 1);
        if (pa >= k || pb >= k) continue;
        double* Ra = R + (long)pa * k;
        double* Rb = R + (long)pb * k;
        double al = 0.0, bt = 0.0, ga = 0.0;
        for (int i = lane; i < k; i += 32) {
          const double u = Ra[i], v = Rb[i];
          al += u * u;
          bt += v * v;
          ga += u * v;
        }
        al = warp_sum(al);
        bt = warp_sum(bt);
        ga = warp_sum(ga);
        if (fabs(ga) > tol * sqrt(al * bt)) {
          const double zeta = (bt - al) / (2.0 * ga);
          const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                           (fabs(zeta) + sqrt(1.0 + zeta * zeta));
          const double cs = 1.0 / sqrt(1.0 + t * t);
          const double sn = cs * t;
          double* Va = V + (long)pa * k;
          double* Vb = V + (long)pb * k;
          for (int i = lane; i < k; i += 32) {
            const double u = Ra[i], v = Rb[i];
            Ra[i] = cs * u - sn * v;
            Rb[i] = sn * u + cs * v;
            const double pu = Va[i], pv = Vb[i];
            Va[i] = cs * pu - sn * pv;
            Vb[i] = sn * pu + cs * pv;
          }
          if (lane == 0) rotated = 1;
        }
      }
      __syncthreads();
    }
    converged = rotated == 0;
    __syncthreads();
    if (tid == 0) rotated = 0;
    __syncthreads();
  }

  // 4. s, the mask, the kept directions' coefficients, x
  for (int j = warp; j < k; j += WARPS) {
    const double* Rj = R + (long)j * k;
    double s = 0.0, d = 0.0;
    for (int i = lane; i < k; i += 32) {
      s += Rj[i] * Rj[i];
      d += Rj[i] * cvec[i];
    }
    s = warp_sum(s);
    d = warp_sum(d);
    if (lane == 0) {
      sigma[j] = sqrt(s);
      coef[j] = d;
    }
  }
  __syncthreads();
  double smax = 0.0;
  for (int i = 0; i < k; ++i) smax = fmax(smax, sigma[i]);
  const double cut = EPS * (double)(N > k ? N : k) * smax;
  for (int j = tid; j < k; j += THREADS) {
    const double s = sigma[j];
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const double t = sigma[i];
      rank += (t > s) || (t == s && i < j);
    }
    sv[p * k + rank] = converged ? s : nan("");
    coef[j] = (s > 0.0 && s >= cut) ? coef[j] / s / s : 0.0;
  }
  __syncthreads();
  for (int l = tid; l < k; l += THREADS) {
    double acc = 0.0;
    for (int i = 0; i < k; ++i) acc += coef[i] * V[(long)i * k + l];
    x[p * k + l] = converged ? acc : nan("");
  }
  if (tid == 0) sweeps_out[p] = sweep;
}

}  // namespace

extern "C" int wls_lstsq_launch(const double* Aw, const double* rw, int P,
                                int N, int k, double* work, double* rwork,
                                double* rv_global, double* x, double* sv,
                                double* norms, int* sweeps, void* stream) {
  if (P == 0) return 0;
  const size_t small = (size_t)(WARPS + 1 + 4 * k + 1);
  const size_t bytes =
      8 * (small + (rv_global == nullptr ? 2 * (size_t)k * k : 0));
  cudaError_t err = cudaFuncSetAttribute(
      wls_lstsq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  wls_lstsq_kernel<<<P, THREADS, bytes, (cudaStream_t)stream>>>(
      Aw, rw, N, k, work, rwork, rv_global, x, sv, norms, sweeps);
  return (int)cudaGetLastError();
}

extern "C" const char* wls_lstsq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
