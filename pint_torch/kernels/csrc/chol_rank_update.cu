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
// Design: one CTA per factor; the rows of V, zero rows dropped first
// (keeping the order of the others), go through the factor as a wavefront:
// at step t, row m takes column j = t - m.  Row m only needs row m - 1 to
// be done with column j before it takes column j itself, so a pass of n
// rows takes n + K - 1 steps instead of n K.  Each entry L[i, j] still
// receives the rows' updates in row order with the formulas above, so the
// factor stays bitwise the plain version's, which sweeps row by row.
// A step, two barriers: one thread a row of V takes its column's (r, c,
// s) from L[j, j] and x_m[j] (written before the last barrier), sets L[j,
// j] = r and publishes (c, s); a barrier; every pair (row m of V, row i >
// j of L) of the step's columns is one update, the pairs spread over all
// threads (i fastest, so neighbours touch neighbouring words); a barrier.
// The factor's lower triangle (packed column by column) and the pass's
// x_m live in dynamic shared memory while they fit with 16 rows of x (K
// <= 223 on an H100; as many rows a pass as fit, at most 64), else in a
// global scratch.  A CTA runs no more threads than 1 / PAIRS of the
// pairs its k rows can give a step.  No floating-point atomics: every sum runs
// in a fixed order in one thread.
//
// What bounds it: the operations, about (5 + a division) (K - j) a row's
// column step j and a sqrt and two divisions at its owner, on one SM, and
// the chain of n + K - 1 dependent steps a pass, each two divisions, a
// sqrt and two barriers; the bytes (L read and written, 2 K^2 x 8) are
// few.  Below a few rows a step, each thread's own bookkeeping and the
// barriers of all its warps dominate: a small rung runs few threads.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int NPMAX = 64;   // rows of V a pass takes at most
constexpr int NPMIN = 16;   // ... and at least, beside a factor in smem
// pairs (row of V, row of L) a thread takes a step at full rows, which
// sets a CTA's threads (tools/torch_chol_probe.py --k9-variants times
// others)
constexpr int PAIRS = 4;
// the static slots, row list and reduction scratch of a CTA
constexpr size_t FIXED_SMEM = NPMAX * 3 * 8 + NPMAX * 4
                              + (MAX_THREADS / 32) * (3 * 8 + 2 * 4);

// Doubles of the packed lower triangle of a K-column factor.
__host__ __device__ __forceinline__ long packed(int K) {
  return (long)K * (K + 1) / 2;
}

// L's element (i, j), i >= j, in the working copy: the lower triangle
// packed column by column (column j's rows j..K-1 in turn).
__device__ __forceinline__ double& at(double* L, int K, int i, int j) {
  return L[(long)j * K - (long)j * (j + 1) / 2 + i];
}

template <bool SMEM, bool INGEST>
__global__ void __launch_bounds__(MAX_THREADS)
chol_rank_kernel(const double* __restrict__ L_in,
                 const double* __restrict__ V,
                 const double* __restrict__ w, const double* __restrict__ r,
                 const double* __restrict__ dx, const double* __restrict__ b,
                 const double* __restrict__ chi2, double sign, int K, int k,
                 int NP, double* __restrict__ L_work,
                 double* __restrict__ x_work, double* __restrict__ L_out,
                 double* __restrict__ b_out, double* __restrict__ chi2_out,
                 double* __restrict__ rnow, double* __restrict__ okc) {
  extern __shared__ double smem[];
  __shared__ double cs[NPMAX][2];  // (c, s) of a step's rows
  __shared__ long cb[NPMAX];       // their columns' bases
  __shared__ int sel[NPMAX];
  __shared__ double red[MAX_THREADS / 32][3];
  __shared__ int red_flags[MAX_THREADS / 32][2];
  const int t = threadIdx.x, T = blockDim.x;
  double* L = SMEM ? smem : L_work;
  // x_m[i] of the pass's row m at X[m K + i]
  double* X = SMEM ? smem + packed(K) : x_work;

  // the factor's lower triangle into its working copy (row-major in)
#pragma unroll 4
  for (int e = t; e < K * K; e += T) {
    const int i = e / K, j = e - i * K;
    if (j <= i) at(L, K, i, j) = L_in[e];
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

  // the entry of V's weighted row `row` at column i
  auto vrow = [&](int row, int i) {
    return INGEST ? sqrt(w[row]) * V[(long)row * K + i]
                  : V[(long)row * K + i];
  };
  int next = 0;
  while (true) {
    // the pass's rows: the next NP nonzero rows of V, in order (a zero row
    // leaves every entry as it is)
    int nr = 0;
    while (nr < NP && next < k) {
      int nonzero = 0;
      for (int i = t; i < K; i += T) nonzero |= vrow(next, i) != 0.0;
      if (__syncthreads_or(nonzero)) {
        if (t == 0) sel[nr] = next;
        ++nr;
      }
      ++next;
    }
    if (nr == 0) break;
    __syncthreads();
    for (int e = t; e < nr * K; e += T) {
      const int m = e / K, i = e - m * K;
      X[e] = vrow(sel[m], i);
    }
    __syncthreads();
    for (int step = 0; step < nr + K - 1; ++step) {
      // the active rows mlo..mhi, row m at column j = step - m
      const int mlo = max(0, step - K + 1), mhi = min(step, nr - 1);
      // the owners, one thread a row: L[j, j] and x_m[j] were last written
      // before the last barrier
      for (int q = t; q <= mhi - mlo; q += T) {
        const int m = mlo + q, j = step - m;
        const double xj = X[(long)m * K + j];
        const double d = at(L, K, j, j);
        const double rr = sqrt(d * d + sign * xj * xj);
        cs[m][0] = rr / d;
        cs[m][1] = xj / d;
        cb[m] = (long)j * K - (long)j * (j + 1) / 2;  // column j's base
        at(L, K, j, j) = rr;
      }
      __syncthreads();
      // every active row's column below its diagonal, the pairs (m, i)
      // spread over all threads, i fastest: thread t takes pair t, t + T,
      // ..., stepped from a quotient by ni taken once (in float, corrected)
      const int ilo = step - mhi + 1, ni = K - ilo;  // ni = 0: no row below
      const int npairs = ni > 0 ? (mhi - mlo + 1) * ni : 0;
      int q = 0, dq = 0;
      if (ni > 0) {
        const float rn = 1.0f / (float)ni;
        q = (int)((float)t * rn);
        q += (q + 1) * ni <= t ? 1 : 0;
        q -= q * ni > t ? 1 : 0;
        dq = (int)((float)T * rn);
        dq += (dq + 1) * ni <= T ? 1 : 0;
        dq -= dq * ni > T ? 1 : 0;
      }
      const int di = T - dq * ni;
      int i = ilo + (t - q * ni);
      for (int e = t; e < npairs; e += T) {
        const int m = mlo + q, j = step - m;
        if (i > j) {
          const double c = cs[m][0], s = cs[m][1];
          const double ss = sign * s;
          double* xp = X + (long)m * K + i;
          const double xi = *xp;
          double* lp = L + cb[m] + i;
          const double col = (*lp + ss * xi) / c;
          *lp = col;
          *xp = c * xi - s * col;
        }
        q += dq;
        i += di;
        if (i >= K) {
          i -= ni;
          ++q;
        }
      }
      __syncthreads();
    }
    __syncthreads();
  }

  // ok and the condition proxy; the factor out, row-major (the entries
  // above the diagonal as they came in)
  int finite = 1, nan_d = 0;
  double dmax = 0.0, dmin = INFINITY;
#pragma unroll 4
  for (int e = t; e < K * K; e += T) {
    const int i = e / K, j = e - i * K;
    const double v = j <= i ? at(L, K, i, j) : L_in[e];
    finite &= isfinite(v);
    L_out[e] = v;
  }
  for (int i = t; i < K; i += T) {
    const double d = at(L, K, i, i);
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
    const double mn = __shfl_down_sync(0xffffffffu, dmin, o);
    dmax = a > dmax ? a : dmax;
    dmin = mn < dmin ? mn : dmin;
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

// Threads a CTA and rows a pass (NP) for K columns and k rows: at most
// 1024 threads, no more than 1 / PAIRS of the pairs (row of V, row of
// L) a step can hold.
void shape(int K, int k, bool smem, int optin, int* T, int* NP) {
  int np = NPMAX;
  if (smem) {
    const long room =
        ((long)optin - (long)FIXED_SMEM - 8L * packed(K)) / (8L * K);
    np = room < NPMAX ? (int)room : NPMAX;
  }
  *NP = np;
  const long rows = k < np ? k : np;
  long threads = ((rows * K / PAIRS + 31) / 32) * 32;
  threads = threads < 32 ? 32 : threads;
  *T = threads > MAX_THREADS ? MAX_THREADS : (int)threads;
}

int optin_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

template <bool SMEM, bool INGEST>
int launch_one(const double* L, const double* V, const double* w,
               const double* r, const double* dx, const double* b,
               const double* chi2, double sign, int K, int k,
               double* L_work, double* x_work, double* L_out, double* b_out,
               double* chi2_out, double* rnow, double* okc,
               cudaStream_t st) {
  int T, NP;
  shape(K, k, SMEM, optin_smem(), &T, &NP);
  const size_t shmem = SMEM ? (size_t)(packed(K) + (long)NP * K) * 8 : 0;
  auto kern = chol_rank_kernel<SMEM, INGEST>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, T, shmem, st>>>(L, V, w, r, dx, b, chi2, sign, K, k, NP, L_work,
                            x_work, L_out, b_out, chi2_out, rnow, okc);
  return (int)cudaGetLastError();
}

}  // namespace

// Whether a K-column factor is worked in shared memory on the current
// device (with room for NPMIN rows of a pass beside it): 1 yes, 0 no.
extern "C" int chol_rank_update_uses_smem(int K) {
  return ((size_t)packed(K) + (size_t)NPMIN * K) * 8 + FIXED_SMEM
         <= (size_t)optin_smem();
}

// Rows of V a wavefront pass takes at K columns (the chain of a pass of n
// rows is n + K - 1 steps).
extern "C" int chol_rank_update_pass_rows(int K) {
  int T, NP;
  shape(K, 1, chol_rank_update_uses_smem(K), optin_smem(), &T, &NP);
  return NP;
}

// L (K, K) row-major; V (k, K): the rows (chol_rank_update) or the block's
// frame-normalized design rows M (stream_ingest, with w, r (k,), dx (K,),
// b (K,), chi2 (1,) and the workspace rnow (k,)); sign +1 or -1; for a
// factor outside shared memory the scratch L_work (K (K + 1) / 2) and
// x_work (pass rows, K).  Outputs: L_out (K, K), b_out, chi2_out, okc (2,) = [ok,
// cond].  ingest: 0 or 1.
extern "C" int chol_rank_update_launch(const double* L, const double* V,
                                       const double* w, const double* r,
                                       const double* dx, const double* b,
                                       const double* chi2, double sign, int K,
                                       int k, int ingest, double* L_work,
                                       double* x_work, double* L_out,
                                       double* b_out, double* chi2_out,
                                       double* rnow, double* okc,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // K * K indexes the factor in an int
  if (K <= 0 || k < 0 || (long)K * K > 2147483647L)
    return (int)cudaErrorInvalidValue;
  const bool smem = chol_rank_update_uses_smem(K);
  if (!smem && (L_work == nullptr || x_work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (smem && ingest)
    return launch_one<true, true>(L, V, w, r, dx, b, chi2, sign, K, k,
                                  L_work, x_work, L_out, b_out, chi2_out,
                                  rnow, okc, st);
  if (smem)
    return launch_one<true, false>(L, V, w, r, dx, b, chi2, sign, K, k,
                                   L_work, x_work, L_out, b_out, chi2_out,
                                   rnow, okc, st);
  if (ingest)
    return launch_one<false, true>(L, V, w, r, dx, b, chi2, sign, K, k,
                                   L_work, x_work, L_out, b_out, chi2_out,
                                   rnow, okc, st);
  return launch_one<false, false>(L, V, w, r, dx, b, chi2, sign, K, k,
                                  L_work, x_work, L_out, b_out, chi2_out,
                                  rnow, okc, st);
}

extern "C" const char* chol_rank_update_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
