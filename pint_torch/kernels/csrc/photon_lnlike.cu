// K8 photon_lnlike: the photon-template log-likelihood of a walker
// ensemble, per walker row the sum over photons of
//   log(max(w_i f(phi_i) + 1 - w_i, 1e-300)),  phi_i = frac_i mod 1,
// or, on request, the template density f(phi) itself.
//
// Replaces pint_tpu/event_fitter.py:110-127, lnpost_one's template part as
// the reference's vmap evaluates it per walker: _template_density (binned
// :327-333, analytic :345-346 through lctemplate.py:36-50 and
// lcprimitives.py:126-135), then jnp.sum(jnp.log(jnp.maximum(vals,
// 1e-300))) with vals = w f + (1 - w) (f alone without weights).  The
// phase fraction is wrapped as x - floor(x): that is jnp.mod's (and
// torch.remainder's, fmod(x, 1) + 1 for a negative x) value up to the
// sign of a zero, so -1e-17 becomes exactly 1.0, which the binned index
// then clips to the last bin.
//
// Two template modes (MODE):
//   BINNED  idx = clip((int)(phi * nbins), 0, nbins - 1) (a NaN phase:
//           bin 0, as the reference's integer conversion gives it),
//           f = table[idx];
//   GAUSS   table = [bg, (sigma, loc, norm, sigma sqrt(2 pi)) per peak]:
//           per peak z = (phi - loc) mod 1, s = sum over k = -6..6 in
//           ascending order of exp(-0.5 ((z + k) / sigma)^2), s / (sigma
//           sqrt(2 pi)) with the denominator folded on the host as the
//           reference folds it in numpy; f = bg, then f + norm_i s_i in
//           peak order -- the reference's operations one for one.
// Built with -fmad=false like K1-K7: each product and sum rounds alone, as
// the plain version's torch operations do (kernels/photon_lnlike.py), so
// the density is bitwise the plain version's; exp and log are CUDA's,
// which torch's CUDA kernels call too.
//
// The reduction is deterministic: one thread a photon, each block's terms
// summed by warp shuffles and then across its warps in a fixed tree, the
// block's sum written to partials[row, block]; a second small kernel sums
// each row's partials in a fixed order (a warp a row, lanes strided, then
// a shuffle tree).  No floating-point atomics: two launches on the same
// inputs give the same bits, as a chain's accept decisions need.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BINNED = 0;
constexpr int GAUSS = 1;
constexpr int NWRAP = 6;

__device__ __forceinline__ double wrap1(double x) { return x - floor(x); }

template <int MODE>
__device__ __forceinline__ double density(double frac,
                                          const double* __restrict__ table,
                                          int ntable) {
  const double phi = wrap1(frac);
  if (MODE == BINNED) {
    const double x = phi * (double)ntable;
    int idx = isnan(x) ? 0 : (int)x;
    idx = idx < 0 ? 0 : (idx > ntable - 1 ? ntable - 1 : idx);
    return __ldg(table + idx);
  }
  const int npeaks = (ntable - 1) / 4;
  double f = __ldg(table);
  for (int i = 0; i < npeaks; ++i) {
    const double sigma = __ldg(table + 1 + 4 * i);
    const double loc = __ldg(table + 2 + 4 * i);
    const double norm = __ldg(table + 3 + 4 * i);
    const double den = __ldg(table + 4 + 4 * i);
    const double z = wrap1(phi - loc);
    double s = 0.0;
#pragma unroll
    for (int k = -NWRAP; k <= NWRAP; ++k) {
      const double t = (z + (double)k) / sigma;
      s = s + exp(-0.5 * (t * t));
    }
    f = f + norm * (s / den);
  }
  return f;
}

template <int MODE>
__global__ void photon_density_kernel(const double* __restrict__ frac,
                                      const double* __restrict__ table,
                                      int ntable, int N,
                                      double* __restrict__ out) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const long off = (long)blockIdx.y * N + n;
  out[off] = density<MODE>(frac[off], table, ntable);
}

template <int MODE>
__global__ void photon_lnlike_kernel(const double* __restrict__ frac,
                                     const double* __restrict__ weights,
                                     const double* __restrict__ table,
                                     int ntable, int N,
                                     double* __restrict__ partials) {
  __shared__ double warp_sum[WARPS];
  const int n = blockIdx.x * THREADS + threadIdx.x;
  double term = 0.0;
  if (n < N) {
    const long off = (long)blockIdx.y * N + n;
    double v = density<MODE>(frac[off], table, ntable);
    if (weights != nullptr) {
      const double w = __ldg(weights + n);
      const double wf = w * v;
      v = wf + (1.0 - w);
    }
    v = v < 1e-300 ? 1e-300 : v;  // NaN stays NaN, as jnp.maximum keeps it
    term = log(v);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    term = term + __shfl_down_sync(0xffffffffu, term, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = term;
  __syncthreads();
  if (warp == 0) {
    double s = lane < WARPS ? warp_sum[lane] : 0.0;
#pragma unroll
    for (int d = WARPS / 2; d > 0; d >>= 1)
      s = s + __shfl_down_sync(0xffffffffu, s, d);
    if (lane == 0) partials[(long)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// One warp a row: lane l sums partials l, l + 32, ... in order, then a
// shuffle tree; nblocks = 0 (no photons) gives 0.
__global__ void photon_lnlike_rowsum(const double* __restrict__ partials,
                                     int B, int nblocks,
                                     double* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  double s = 0.0;
  for (int j = lane; j < nblocks; j += 32)
    s = s + partials[(long)row * nblocks + j];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    s = s + __shfl_down_sync(0xffffffffu, s, d);
  if (lane == 0) out[row] = s;
}

}  // namespace

// frac (B, N) phase fractions; weights (N,) or null; table (ntable,):
// the bins (BINNED) or [bg, 4 per peak] (GAUSS); dens != 0: out (B, N)
// gets f, else out (B, ceil(N / 256)) each block's sum of terms.
extern "C" int photon_lnlike_launch(const double* frac, const double* weights,
                                    const double* table, int ntable,
                                    int mode, int dens, int B, int N,
                                    double* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  if (dens && mode == BINNED)
    photon_density_kernel<BINNED><<<grid, THREADS, 0, st>>>(
        frac, table, ntable, N, out);
  else if (dens)
    photon_density_kernel<GAUSS><<<grid, THREADS, 0, st>>>(
        frac, table, ntable, N, out);
  else if (mode == BINNED)
    photon_lnlike_kernel<BINNED><<<grid, THREADS, 0, st>>>(
        frac, weights, table, ntable, N, out);
  else
    photon_lnlike_kernel<GAUSS><<<grid, THREADS, 0, st>>>(
        frac, weights, table, ntable, N, out);
  return (int)cudaGetLastError();
}

// out (B,): each row's sum of its nblocks partials (B, nblocks).
extern "C" int photon_lnlike_rowsum_launch(const double* partials, int B,
                                           int nblocks, double* out,
                                           void* stream) {
  constexpr int ROWS = 4;  // warps (rows) a block
  if (B == 0) return 0;
  photon_lnlike_rowsum<<<(B + ROWS - 1) / ROWS, 32 * ROWS, 0,
                         (cudaStream_t)stream>>>(partials, B, nblocks, out);
  return (int)cudaGetLastError();
}

extern "C" const char* photon_lnlike_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
