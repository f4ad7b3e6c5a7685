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
//   MIXED   any mixture of the closed-form primitives (queue B 5d):
//           table = [bg, one record of REC = 8 numbers per primitive:
//           (type, p0, p1, p2, norm, c0, c1, c2)], the per-primitive
//           constants c computed on the host once per table as the
//           reference's numpy computes them; per photon f = bg, then
//           f + norm_i pdf_i in primitive order, each pdf as the
//           reference's _pdf writes it (lcprimitives.py:118-356, the
//           _NWRAP = 6 images in ascending order):
//             0 LCGaussian    (sigma, loc; sigma sqrt(2 pi)): as GAUSS;
//             1 LCGaussian2   (w1, w2, loc; 1/w1, 1/w2, sqrt(2/pi)/(w1+w2)):
//               z = phi - loc + k, zz = z (z <= 0 ? 1/w1 : 1/w2),
//               sum of exp(-0.5 zz^2), times the amplitude;
//             2 LCLorentzian  (gamma, loc; sinh(2 pi gamma), cosh(..)):
//               sinh / (cosh - cos(2 pi (phi - loc)));
//             3 LCLorentzian2 (g1, g2, loc; 1/g1, 1/g2, 2/pi/(g1+g2)):
//               z0 = (phi - loc + 0.5) mod 1 - 0.5, sum over images of
//               amp / (1 + zz^2);
//             4 LCVonMises    (width, loc; kappa, i0e(kappa) by scipy):
//               exp(kappa (cos(2 pi (phi - loc)) - 1)) / i0e(kappa);
//             5 LCTopHat      (width, loc; width / 2, 1 / width):
//               |z0| <= width / 2 ? 1 / width : 0;
//             6 LCKing        (sigma, gamma, loc; the normalisation
//               sigma sqrt(2 pi gamma) exp(gammaln(gamma - 1/2) -
//               gammaln(gamma)) by scipy): sum over images of (1 +
//               u / gamma)^-gamma, u = ((z0 + k) / sigma)^2 / 2, the
//               power as exp(-gamma log(1 + u / gamma)) (fault C4's
//               lesson), over the normalisation;
//             7 LCHarmonic    (loc; 2 pi order): 1 + 2 cos(c0 (phi - loc)).
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
constexpr int MIXED = 2;
constexpr int NWRAP = 6;
constexpr int REC = 8;
constexpr double TWO_PI = 6.283185307179586;  // 2 * np.pi

__device__ __forceinline__ double wrap1(double x) { return x - floor(x); }

// One closed-form primitive's density at phase phi (record r, see above).
__device__ __forceinline__ double mixed_pdf(double phi,
                                            const double* __restrict__ r) {
  const int type = (int)__ldg(r);
  const double p0 = __ldg(r + 1), p1 = __ldg(r + 2), p2 = __ldg(r + 3);
  const double c0 = __ldg(r + 5), c1 = __ldg(r + 6), c2 = __ldg(r + 7);
  switch (type) {
    case 0: {  // LCGaussian
      const double z = wrap1(phi - p1);
      double s = 0.0;
      for (int k = -NWRAP; k <= NWRAP; ++k) {
        const double t = (z + (double)k) / p0;
        s = s + exp(-0.5 * (t * t));
      }
      return s / c0;
    }
    case 1: {  // LCGaussian2
      const double z0 = phi - p2;
      double s = 0.0;
      for (int k = -NWRAP; k <= NWRAP; ++k) {
        const double z = z0 + (double)k;
        const double zz = z * (z <= 0.0 ? c0 : c1);
        s = s + exp(-0.5 * (zz * zz));
      }
      return s * c2;
    }
    case 2: {  // LCLorentzian
      const double z = TWO_PI * (phi - p1);
      return c0 / (c1 - cos(z));
    }
    case 3: {  // LCLorentzian2
      const double z0 = wrap1(phi - p2 + 0.5) - 0.5;
      double s = 0.0;
      for (int k = -NWRAP; k <= NWRAP; ++k) {
        const double z = z0 + (double)k;
        const double zz = z * (z <= 0.0 ? c0 : c1);
        s = s + c2 / (1.0 + zz * zz);
      }
      return s;
    }
    case 4: {  // LCVonMises
      const double z = TWO_PI * (phi - p1);
      return exp(c0 * (cos(z) - 1.0)) / c1;
    }
    case 5: {  // LCTopHat
      const double z = wrap1(phi - p1 + 0.5) - 0.5;
      return fabs(z) <= c0 ? c1 : 0.0;
    }
    case 6: {  // LCKing
      const double z0 = wrap1(phi - p2 + 0.5) - 0.5;
      double s = 0.0;
      for (int k = -NWRAP; k <= NWRAP; ++k) {
        const double t = (z0 + (double)k) / p0;
        const double u = 0.5 * (t * t);
        s = s + exp(-p1 * log(1.0 + u / p1));
      }
      return s / c0;
    }
    default:  // 7 LCHarmonic
      return 1.0 + 2.0 * cos(c0 * (phi - p0));
  }
}

template <int MODE>
__device__ __forceinline__ double density(double frac,
                                          const double* __restrict__ table,
                                          int ntable) {
  const double phi = wrap1(frac);
  if constexpr (MODE == BINNED) {
    const double x = phi * (double)ntable;
    int idx = isnan(x) ? 0 : (int)x;
    idx = idx < 0 ? 0 : (idx > ntable - 1 ? ntable - 1 : idx);
    return __ldg(table + idx);
  } else if constexpr (MODE == MIXED) {
    const int nprim = (ntable - 1) / REC;
    double f = __ldg(table);
    for (int i = 0; i < nprim; ++i) {
      const double* r = table + 1 + REC * i;
      f = f + __ldg(r + 4) * mixed_pdf(phi, r);
    }
    return f;
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
// the bins (BINNED), [bg, 4 per peak] (GAUSS) or [bg, 8 per primitive]
// (MIXED); dens != 0: out (B, N) gets f, else out (B, ceil(N / 256)) each
// block's sum of terms.
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
  else if (dens && mode == GAUSS)
    photon_density_kernel<GAUSS><<<grid, THREADS, 0, st>>>(
        frac, table, ntable, N, out);
  else if (dens)
    photon_density_kernel<MIXED><<<grid, THREADS, 0, st>>>(
        frac, table, ntable, N, out);
  else if (mode == BINNED)
    photon_lnlike_kernel<BINNED><<<grid, THREADS, 0, st>>>(
        frac, weights, table, ntable, N, out);
  else if (mode == GAUSS)
    photon_lnlike_kernel<GAUSS><<<grid, THREADS, 0, st>>>(
        frac, weights, table, ntable, N, out);
  else
    photon_lnlike_kernel<MIXED><<<grid, THREADS, 0, st>>>(
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
