// K13 polyco_eval: batched polyco evaluation, phase and spin frequency.
//
// Replaces pint_tpu/predict/door.py:eval_kernel (door.py:86-113, the jitted
// `kern`): per (request b, epoch t), with dt in minutes from the window's
// midpoint and the window's n coefficients c_i (TEMPO convention),
//
//   poly  = sum_i c_i dt^i            (Horner, i = n-1 .. 0)
//   dpoly = sum_{i>=1} i c_i dt^(i-1) (Horner, i = n-1 .. 1)
//   raw   = rfrac + 60 f0 dt + poly
//   ip = floor(raw), frac = raw - ip, freq = f0 + dpoly / 60.
//
// One thread per (b, t): the Horner loops run in registers over the
// element's n coefficients, each read once, and the three outputs are
// stored once.  Bound on this card: per element (3 + n) doubles read and
// 3 written, (3 n + 6) double operations -- ~0.2 operations a byte at
// n = 12, far below the H100's balance, so bytes bound it; at the predict
// path's shapes (B x T up to 8 x 64) the whole call is a few tens of KB
// and one launch's latency bounds it instead.
//
// The operations run in the reference's order, each rounded alone
// (-fmad=false: the plain PyTorch version rounds every product), and
// dpoly / 60 is a division, not a product with its reciprocal.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
polyco_eval_kernel(const double* __restrict__ dt,
                   const double* __restrict__ rfrac,
                   const double* __restrict__ f0,
                   const double* __restrict__ coeffs, long total, int n,
                   double* __restrict__ ip, double* __restrict__ frac,
                   double* __restrict__ freq) {
  long e = (long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const double x = dt[e];
  const double* c = coeffs + e * n;
  double poly = 0.0;
  double dpoly = 0.0;
  for (int i = n - 1; i > 0; --i) {
    const double ci = c[i];
    poly = poly * x + ci;
    dpoly = dpoly * x + (double)i * ci;
  }
  poly = poly * x + c[0];
  const double f = f0[e];
  const double raw = (rfrac[e] + (60.0 * f) * x) + poly;
  const double k = floor(raw);
  ip[e] = k;
  frac[e] = raw - k;
  freq[e] = f + dpoly / 60.0;
}

}  // namespace

extern "C" int polyco_eval_launch(const double* dt, const double* rfrac,
                                  const double* f0, const double* coeffs,
                                  long total, int n, double* ip, double* frac,
                                  double* freq, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  long blocks = (total + THREADS - 1) / THREADS;
  polyco_eval_kernel<<<(unsigned)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(dt, rfrac, f0, coeffs, total,
                                               n, ip, frac, freq);
  return (int)cudaGetLastError();
}

extern "C" const char* polyco_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
