// K14 polyco_fit: batched least-squares polyco fits, one window a block.
//
// Replaces pint_tpu/predict/generate.py:fit_kernel (generate.py:51-76,
// `one_window` vmapped over rows): per (pulsar, window) row, the scaled
// Vandermonde V = x^[0..n) of the row's m nodes, its QR factorization,
// c = R^-1 Q^T y and the fit's rms, sqrt(mean((V c - y)^2)).
//
// Design.  One block per row, the m x (n + 1) matrix [V | y] in shared
// memory (m <= 64, n <= 32).  V is built by repeated products (x^j =
// x^(j-1) x), not by a power.  Householder QR column by column: one thread
// forms the column's norm (a sequential sum), the reflector v = a_k -
// alpha e_k with alpha = -sign(a_kk) |a_k| and v'v = 2 |a_k| (|a_k| +
// |a_kk|), then each thread j > k applies it to its own column -- Q^T y is
// the (n+1)-th column, so it is reduced as the columns are.  Back
// substitution and the residual's sum of squares are sequential in one
// thread, the residual of each node in its own thread.  Every sum runs in
// index order and every product is rounded alone (-fmad=false), so the
// plain PyTorch version in polyco_fit.py, which makes the same operations
// in the same order, gives the same bits.  Pad rows (the last window's
// nodes against a zero target) solve to exactly zero.
//
// Bound on this card: per row 2 m doubles read and n + 1 written against
// ~2 m n^2 + 2 m n double operations (~8000 at m = 24, n = 12); at the
// path's 64 or 256 rows the whole call is ~5e5 operations and 50-100 KB,
// microseconds of either, so one launch's latency and the block's serial
// chain (the norm, the reflector, back substitution) bound it.
#include <cuda_runtime.h>

namespace {

constexpr int MMAX = 64;
constexpr int NMAX = 32;
constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
polyco_fit_kernel(const double* __restrict__ x, const double* __restrict__ y,
                  int m, int n, double* __restrict__ coef,
                  double* __restrict__ rms) {
  __shared__ double A[MMAX][NMAX + 2];  // [V | y], odd stride
  __shared__ double xs[MMAX];
  __shared__ double ys[MMAX];
  __shared__ double cs[NMAX];
  __shared__ double rs[MMAX];
  __shared__ double red[2];  // alpha, 2 / v'v
  const long row = blockIdx.x;
  const int t = threadIdx.x;
  const int nc = n + 1;
  if (t < m) {
    const double xi = x[row * m + t];
    const double yi = y[row * m + t];
    xs[t] = xi;
    ys[t] = yi;
    double p = 1.0;
    A[t][0] = p;
    for (int j = 1; j < n; ++j) {
      p = p * xi;
      A[t][j] = p;
    }
    A[t][n] = yi;
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    if (t == 0) {
      double s = 0.0;
      for (int i = k; i < m; ++i) s = s + A[i][k] * A[i][k];
      const double norm = sqrt(s);
      const double akk = A[k][k];
      const double alpha = akk >= 0.0 ? -norm : norm;
      const double vtv = (2.0 * norm) * (norm + fabs(akk));
      red[0] = alpha;
      red[1] = vtv > 0.0 ? 2.0 / vtv : 0.0;
      A[k][k] = akk - alpha;  // v_k; v_i = a_ik below
    }
    __syncthreads();
    const int j = k + 1 + t;
    if (j < nc) {
      double dot = 0.0;
      for (int i = k; i < m; ++i) dot = dot + A[i][k] * A[i][j];
      const double f = dot * red[1];
      for (int i = k; i < m; ++i) A[i][j] = A[i][j] - f * A[i][k];
    }
    __syncthreads();
    if (t == 0) A[k][k] = red[0];
    __syncthreads();
  }
  if (t == 0) {
    for (int i = n - 1; i >= 0; --i) {
      double s = A[i][n];
      for (int j = i + 1; j < n; ++j) s = s - A[i][j] * cs[j];
      cs[i] = s / A[i][i];
    }
  }
  __syncthreads();
  if (t < n) coef[row * n + t] = cs[t];
  if (t < m) {
    const double xi = xs[t];
    double p = 1.0;
    double s = p * cs[0];
    for (int j = 1; j < n; ++j) {
      p = p * xi;
      s = s + p * cs[j];
    }
    rs[t] = s - ys[t];
  }
  __syncthreads();
  if (t == 0) {
    double ss = 0.0;
    for (int i = 0; i < m; ++i) ss = ss + rs[i] * rs[i];
    rms[row] = sqrt(ss / (double)m);
  }
}

}  // namespace

extern "C" int polyco_fit_launch(const double* x, const double* y, long rows,
                                 int m, int n, double* coef, double* rms,
                                 void* stream) {
  if (m < n || m > MMAX || n < 1 || n > NMAX) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  polyco_fit_kernel<<<(unsigned)rows, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, m, n, coef, rms);
  return (int)cudaGetLastError();
}

extern "C" const char* polyco_fit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
