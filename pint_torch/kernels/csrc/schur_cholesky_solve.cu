// K3 schur_cholesky_solve: the per-point solve of the grid's marginalized
// (Schur-complement) timing system.
//
// Replaces the tail of pint_tpu/grid.py:build_grid_gls_chi2_fn.chi2_point
// .gn_step (grid.py:737-765), CPU branch: an = sqrt(max(diag(Ar), 1e-300)),
// Arn = Ar / (an an^T) + ridge I, Cholesky, cho_solve of rhs/an, x/an, the
// ok flag (every entry of x finite; otherwise x is poisoned to NaN) and the
// condition proxy (max diag(L) / max(min diag(L), 1e-300))^2.  A pivot that
// is not positive (or NaN) marks the point failed: x NaN, ok 0, cond NaN --
// what the reference's NaN-filled factor produces.
//
// One CTA per grid point, one thread per matrix row (nt <= 128).  The
// normalized matrix lives in dynamic shared memory (nt = 89 is 63 KB,
// nt = 128 is 128 KB, above the 48 KB default, so the launcher raises the
// attribute).  The factorization is left-looking by columns: thread i
// accumulates s = Arn[i][j] - sum_k L[i][k] L[j][k] in k order, the same
// rounding sequence as the right-looking loop of the plain twin.
//
// Bound on this card: per point it reads nt^2 + nt doubles (62 KB at
// nt = 88) against nt^3/3 + 4 nt^2 ~ 0.26 MFLOP, ~4 f64 operations per
// byte, so the batch is bound by bytes on paper; this simple kernel is in
// practice bound by its chain of 3 nt __syncthreads steps (latency), which
// a later PR can shorten with blocked panels and several points per CTA.
//
// Compiled with -fmad=false so each product is rounded alone, as in the
// twin.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_NT = 128;

__global__ void schur_cholesky_kernel(const double* __restrict__ Ar,
                                      const double* __restrict__ rhs,
                                      double ridge, int nt,
                                      double* __restrict__ x,
                                      unsigned char* __restrict__ ok,
                                      double* __restrict__ cond) {
  extern __shared__ double smem[];
  double* A = smem;              // nt * nt, row-major; lower triangle -> L
  double* an = A + nt * nt;      // nt
  double* y = an + nt;           // nt
  __shared__ int bad;
  __shared__ int solved;
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const double* Ab = Ar + (long)b * nt * nt;
  if (i == 0) bad = 0;
  for (int e = i; e < nt * nt; e += blockDim.x) A[e] = Ab[e];
  __syncthreads();
  if (i < nt) {
    const double d = A[i * nt + i];
    an[i] = sqrt(d < 1e-300 ? 1e-300 : d);  // max that keeps NaN
  }
  __syncthreads();
  if (i < nt) {
    for (int j = 0; j < nt; ++j) {
      double v = A[i * nt + j] / (an[i] * an[j]);
      if (i == j) v = v + ridge;
      A[i * nt + j] = v;
    }
    y[i] = rhs[(long)b * nt + i] / an[i];
  }
  __syncthreads();
  // left-looking Cholesky, column by column
  for (int j = 0; j < nt; ++j) {
    if (i == j) {
      double s = A[j * nt + j];
      for (int k = 0; k < j; ++k) s = s - A[j * nt + k] * A[j * nt + k];
      if (!(s > 0.0)) bad = 1;
      A[j * nt + j] = sqrt(s);
    }
    __syncthreads();
    if (i > j && i < nt) {
      double s = A[i * nt + j];
      for (int k = 0; k < j; ++k) s = s - A[i * nt + k] * A[j * nt + k];
      A[i * nt + j] = s / A[j * nt + j];
    }
    __syncthreads();
  }
  // forward substitution L z = y (column-oriented)
  for (int k = 0; k < nt; ++k) {
    if (i == k) y[k] = y[k] / A[k * nt + k];
    __syncthreads();
    if (i > k && i < nt) y[i] = y[i] - A[i * nt + k] * y[k];
    __syncthreads();
  }
  // back substitution L^T w = z
  for (int k = nt - 1; k >= 0; --k) {
    if (i == k) y[k] = y[k] / A[k * nt + k];
    __syncthreads();
    if (i < k) y[i] = y[i] - A[k * nt + i] * y[k];
    __syncthreads();
  }
  if (i < nt) y[i] = y[i] / an[i];
  __syncthreads();
  if (i == 0) {
    int fin = !bad;
    for (int k = 0; k < nt; ++k) fin = fin && isfinite(y[k]);
    double dmax = A[0], dmin = A[0];
    int dnan = 0;
    for (int k = 0; k < nt; ++k) {
      const double d = A[k * nt + k];
      dnan = dnan || isnan(d);
      dmax = d > dmax ? d : dmax;
      dmin = d < dmin ? d : dmin;
    }
    double r = dmax / (dmin < 1e-300 ? 1e-300 : dmin);
    ok[b] = (unsigned char)fin;
    cond[b] = (bad || dnan) ? nan("") : r * r;
    solved = fin;
  }
  __syncthreads();
  if (i < nt) {
    x[(long)b * nt + i] = solved ? y[i] : nan("");
  }
}

}  // namespace

extern "C" int schur_cholesky_solve_launch(const double* Ar, const double* rhs,
                                           double ridge, int B, int nt,
                                           double* x, unsigned char* ok,
                                           double* cond, void* stream) {
  if (nt < 1 || nt > MAX_NT) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)(nt * nt + 2 * nt) * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      schur_cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  schur_cholesky_kernel<<<B, MAX_NT, smem, (cudaStream_t)stream>>>(
      Ar, rhs, ridge, nt, x, ok, cond);
  return (int)cudaGetLastError();
}

extern "C" const char* schur_cholesky_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
