// K9 chol_rank_update: the rank-k Cholesky up/downdate of a GLS
// normal-equation factor, alone or fused with a streamed block's ingest.
//
// Replaces pint_tpu/streaming/lowrank.py:55 _rank_pass (a lax.scan over the
// rows of V inside which a lax.scan walks the columns) and :115
// ingest_kernel.  For each row x of V (k, K), column j = 0..K-1 (LINPACK's
// dchud / dchdd, lower-triangular):
//   d = L[j,j], xj = x[j]
//   r = sqrt(d*d + sign*xj*xj),  c = r / d,  s = xj / d
//   L[i,j] = (L[i,j] + sign*s*x[i]) / c      for i > j
//   x[i]   = c*x[i] - s*L[i,j]               for i > j (the new L[i,j])
//   L[j,j] = r
// -- the reference's operations one for one.  Built with -fmad=false, so
// each product and sum rounds alone, as the plain version's torch
// operations (kernels/chol_rank_update.py) do: the factor is bitwise the
// plain version's.  A zero row is an exact no-op (sqrt(d*d) == |d| in
// binary floating point, so c = 1 and s = 0); the kernel skips it, which
// gives the same bits.  A downdate of rows that were never in the factor
// drives a diagonal through zero: the sqrt of a negative number poisons
// the factor with NaN, ok comes back false and nothing raises.
//
// stream_ingest (INGEST) fuses the rest of a block's ingest into the same
// launch: r_now = r - M dx_since (each row's dot product in ascending
// column order), V = sqrt(w) M, the sweep, b' = b + sign M^T (w r_now)
// (each column's sum in ascending row order) and chi2' = chi2 + sign
// sum(w r_now r_now) (ascending rows), then ok (every entry finite, the
// diagonal positive) and the condition proxy (max|d| / max(min|d|,
// 1e-300))^2, NaN where a diagonal is NaN, as torch's max and min give it.
//
// Design: one CTA per factor, one thread per row of L (rows strided over
// the block when K exceeds it), a barrier per column step.  L lives in
// dynamic shared memory, column-major so that a column step's threads
// read consecutive words, while K*K*8 bytes fit (K <= 168 on an H100);
// above that it is updated in place in the output, in global memory.
// The owner of row j computes (r, c, s) and publishes them in one of two
// shared slots (double-buffered: one barrier a step).  No floating-point
// atomics: every sum runs in a fixed order in one thread.
//
// What bounds it: the bytes (L read and written, 2 K^2 x 8) and the
// operations (about 6 (K - j) a column step per row, two divisions and a
// sqrt at the owner) make a launch-sized bound; the real limit is the
// chain of k x K dependent column steps, each a sqrt, two divisions and a
// barrier.  A wavefront over rows would cut the chain to k + K.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;

// L's element (i, j): column-major in shared memory, row-major in global.
template <bool SMEM>
__device__ __forceinline__ double& at(double* L, int K, int i, int j) {
  return SMEM ? L[(long)j * K + i] : L[(long)i * K + j];
}

template <bool SMEM, bool INGEST>
__global__ void chol_rank_kernel(const double* __restrict__ L_in,
                                 const double* __restrict__ V,
                                 const double* __restrict__ w,
                                 const double* __restrict__ r,
                                 const double* __restrict__ dx,
                                 const double* __restrict__ b,
                                 const double* __restrict__ chi2,
                                 double sign, int K, int k,
                                 double* __restrict__ L_out,
                                 double* __restrict__ b_out,
                                 double* __restrict__ chi2_out,
                                 double* __restrict__ rnow,
                                 double* __restrict__ okc) {
  extern __shared__ double smem[];
  __shared__ double cs[2][3];
  __shared__ double red[MAX_THREADS / 32][3];
  __shared__ int red_flags[MAX_THREADS / 32][2];
  const int t = threadIdx.x, T = blockDim.x;
  double* L = SMEM ? smem : L_out;
  double* x = SMEM ? smem + (long)K * K : smem;

  // the factor into its working copy (row-major global in, either layout)
  for (long e = t; e < (long)K * K; e += T) {
    const int i = (int)(e / K), j = (int)(e % K);
    at<SMEM>(L, K, i, j) = L_in[e];
  }

  if (INGEST) {
    // r_now = r - M dx_since: one row a thread, columns ascending
    for (int row = t; row < k; row += T) {
      const double* m = V + (long)row * K;
      double acc = 0.0;
      for (int j = 0; j < K; ++j) acc = acc + m[j] * dx[j];
      rnow[row] = r[row] - acc;
    }
  }
  __syncthreads();
  if (INGEST) {
    // b' = b + sign M^T (w r_now): one column a thread, rows ascending
    for (int i = t; i < K; i += T) {
      double acc = 0.0;
      for (int row = 0; row < k; ++row)
        acc = acc + V[(long)row * K + i] * (w[row] * rnow[row]);
      b_out[i] = b[i] + sign * acc;
    }
    if (t == 0) {
      double acc = 0.0;
      for (int row = 0; row < k; ++row) {
        const double wr = w[row] * rnow[row];
        acc = acc + wr * rnow[row];
      }
      chi2_out[0] = chi2[0] + sign * acc;
    }
  }

  for (int row = 0; row < k; ++row) {
    const double sw = INGEST ? sqrt(w[row]) : 1.0;
    int nonzero = 0;
    for (int i = t; i < K; i += T) {
      const double v = INGEST ? sw * V[(long)row * K + i] : V[(long)row * K + i];
      x[i] = v;
      nonzero |= v != 0.0;
    }
    // a zero row leaves every entry as it is: skip its sweep
    if (!__syncthreads_or(nonzero)) continue;
    for (int j = 0; j < K; ++j) {
      double* slot = cs[j & 1];
      if (t == j % T) {
        const double d = at<SMEM>(L, K, j, j);
        const double xj = x[j];
        const double rr = sqrt(d * d + sign * xj * xj);
        slot[0] = rr;
        slot[1] = rr / d;
        slot[2] = xj / d;
        at<SMEM>(L, K, j, j) = rr;
      }
      __syncthreads();
      const double c = slot[1], s = slot[2];
      const double ss = sign * s;
      for (int i = j + 1 + ((t - (j + 1)) % T + T) % T; i < K; i += T) {
        const double xi = x[i];
        const double col = (at<SMEM>(L, K, i, j) + ss * xi) / c;
        at<SMEM>(L, K, i, j) = col;
        x[i] = c * xi - s * col;
      }
    }
    __syncthreads();
  }

  // ok and the condition proxy; the factor out (shared memory only)
  int finite = 1, nan_d = 0;
  double dmax = 0.0, dmin = INFINITY;
  for (int i = t; i < K; i += T) {
    for (int j = 0; j < K; ++j) {
      const double v = at<SMEM>(L, K, i, j);
      finite &= isfinite(v);
      if (SMEM) L_out[(long)i * K + j] = v;
    }
    const double d = at<SMEM>(L, K, i, i);
    finite &= d > 0.0;
    const double a = fabs(d);
    if (isnan(a)) nan_d = 1;
    else {
      dmax = a > dmax ? a : dmax;
      dmin = a < dmin ? a : dmin;
    }
  }
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double a = __shfl_down_sync(0xffffffffu, dmax, o);
    const double m = __shfl_down_sync(0xffffffffu, dmin, o);
    dmax = a > dmax ? a : dmax;
    dmin = m < dmin ? m : dmin;
    finite &= __shfl_down_sync(0xffffffffu, finite, o);
    nan_d |= __shfl_down_sync(0xffffffffu, nan_d, o);
  }
  if (lane == 0) {
    red[warp][0] = dmax;
    red[warp][1] = dmin;
    red_flags[warp][0] = finite;
    red_flags[warp][1] = nan_d;
  }
  __syncthreads();
  if (t == 0) {
    for (int q = 1; q < (T + 31) / 32; ++q) {
      dmax = red[q][0] > dmax ? red[q][0] : dmax;
      dmin = red[q][1] < dmin ? red[q][1] : dmin;
      finite &= red_flags[q][0];
      nan_d |= red_flags[q][1];
    }
    const double lo = dmin < 1e-300 ? 1e-300 : dmin;
    const double q = dmax / lo;
    okc[0] = finite ? 1.0 : 0.0;
    okc[1] = nan_d ? NAN : q * q;
  }
}

template <bool SMEM, bool INGEST>
int launch_one(const double* L, const double* V, const double* w,
               const double* r, const double* dx, const double* b,
               const double* chi2, double sign, int K, int k, double* L_out,
               double* b_out, double* chi2_out, double* rnow, double* okc,
               int threads, size_t shmem, cudaStream_t st) {
  auto kern = chol_rank_kernel<SMEM, INGEST>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, threads, shmem, st>>>(L, V, w, r, dx, b, chi2, sign, K, k, L_out,
                                  b_out, chi2_out, rnow, okc);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared-memory limit of one block on the current device (bytes), and
// whether a K-column factor is worked in shared memory: 1 yes, 0 no.
extern "C" int chol_rank_update_uses_smem(int K) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  // the static slots and reduction scratch beside the dynamic buffer
  const size_t fixed = 2 * 3 * 8 + (MAX_THREADS / 32) * (3 * 8 + 2 * 4);
  return (size_t)K * K * 8 + (size_t)K * 8 + fixed <= (size_t)optin;
}

// L (K, K) row-major; V (k, K): the rows (chol_rank_update) or the block's
// frame-normalized design rows M (stream_ingest, with w, r (k,), dx (K,),
// b (K,), chi2 (1,) and the workspace rnow (k,)); sign +1 or -1.  Outputs:
// L_out (K, K), b_out, chi2_out, okc (2,) = [ok, cond].  ingest: 0 or 1.
extern "C" int chol_rank_update_launch(const double* L, const double* V,
                                       const double* w, const double* r,
                                       const double* dx, const double* b,
                                       const double* chi2, double sign, int K,
                                       int k, int ingest, double* L_out,
                                       double* b_out, double* chi2_out,
                                       double* rnow, double* okc,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((K + 31) / 32) * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  const bool smem = chol_rank_update_uses_smem(K);
  const size_t shmem = (size_t)(smem ? K * K + K : K) * 8;
  if (smem && ingest)
    return launch_one<true, true>(L, V, w, r, dx, b, chi2, sign, K, k, L_out,
                                  b_out, chi2_out, rnow, okc, threads, shmem,
                                  st);
  if (smem)
    return launch_one<true, false>(L, V, w, r, dx, b, chi2, sign, K, k,
                                   L_out, b_out, chi2_out, rnow, okc, threads,
                                   shmem, st);
  if (ingest)
    return launch_one<false, true>(L, V, w, r, dx, b, chi2, sign, K, k,
                                   L_out, b_out, chi2_out, rnow, okc, threads,
                                   shmem, st);
  return launch_one<false, false>(L, V, w, r, dx, b, chi2, sign, K, k, L_out,
                                  b_out, chi2_out, rnow, okc, threads, shmem,
                                  st);
}

extern "C" const char* chol_rank_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
