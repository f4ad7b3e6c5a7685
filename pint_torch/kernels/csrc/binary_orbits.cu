// K6 binary_orbits: the orbit count and instantaneous period per (point,
// TOA) of the FBX and ORBWAVES parameterizations, with their partials on
// request.
//
// Replaces pint_tpu/models/binary/engines.py:orbits_fbx (:68) and
// orbits_waves (:83) as PulsarBinary._orbits_fn (components.py:168-193)
// hands them to every binary engine.  The outputs feed the orbit-input
// instantiations of K2 (dd_binary.cu) and K4 (ell1_binary.cu).
//
// FORM, a template parameter:
//   FBX       -- orbits = sum_n FBn t^(n+1)/(n+1)!, pbprime = 1 / freq,
//                freq = sum_n FBn t^n/n!, by the reference's Horner ladder
//                (products with the rounded reciprocals 1/(n+2), 1/(n+1));
//   WAVES_PB  -- t / (PB 86400) + dphi, pbprime = 1 / (1 / (PB 86400) +
//                dphi_dot) (the PB base ignores PBDOT/XPBDOT);
//   WAVES_FBX -- the FBX orbits + dphi, pbprime = 1 / (1 / pbprime_fbx +
//                dphi_dot);
// dphi = sum_k C_k cos((k+1) OM tw) + S_k sin((k+1) OM tw), tw = t + tw_off
// (the seconds from ORBWAVE_EPOCH to the binary's epoch, a host double),
// dphi_dot its rate; term by term in the reference's order.
//
// Coefficient row (ncoef values per point): FB0..FB(nfb-1) (or PB for the
// PB base), then C_0, S_0, C_1, S_1, ... and ORBWAVE_OM.  Partials, (B, N,
// 2, 1 + ncoef): of orbits, then of pbprime, with respect to t (column 0)
// and each coefficient, in closed form (dpbprime = -pbprime^2 dg, g the
// orbital frequency); the plain twin (models/binary/engines.py
// binary_orbits_forward, binary_orbits_partials) repeats both passes
// operation for operation, so orbits and pbprime are bitwise the twin's.
//
// Per FORM a primal and a dual, the dual staged through shared memory or,
// past the widest tile, direct (STAGED; the wrapper counts both under the
// dual's name).  One thread per (point, TOA).  The primal is a few hundred
// operations a TOA and bound by its bytes (t in, two values out).  The
// dual recomputes the wave terms'
// sines and cosines in its partial pass rather than keep 2 nwaves of them,
// and writes 16 (1 + ncoef) bytes a TOA, which bound it: each thread builds
// its 2 (1 + ncoef) partials in its row of the block's tile in shared
// memory, each pbprime entry already scaled by -pbprime^2 (pbprime comes
// out of the forward pass first), and the tile -- one contiguous,
// 16-byte-aligned range of the output -- leaves in one TMA bulk store
// (cp.async.bulk).  The block is sized from ncoef in dynamic shared
// memory: 128 threads while their tile fits (10 KB at ncoef = 4, 32 KB at
// ncoef = 15), else fewer, in whole warps, down to one warp, whose tile
// fits up to ncoef = 453 in the 227 KB a block may opt into.  Past that
// width -- 226 ORBWAVES terms, which the reference allows -- the dual
// writes each row straight to device memory (STAGED = false).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
enum : int { FBX = 0, WAVES_PB = 1, WAVES_FBX = 2 };

// The Horner ladder: orbits (not yet times t) and freq.
__device__ __forceinline__ void horner(const double* c, int nfb, double t,
                                       double& orbits, double& freq) {
  orbits = 0.0;
  freq = 0.0;
  for (int n = nfb - 1; n >= 0; --n) {
    orbits = (orbits * t) * (1.0 / (n + 2)) + c[n];
    freq = (freq * t) * (1.0 / (n + 1)) + c[n];
  }
  orbits = orbits * t;
}

template <int FORM>
__device__ __forceinline__ void forward(const double* c, int nfb, int nw,
                                        double t, double tw_off,
                                        double& orbits, double& pbprime,
                                        double& freq, double& pb_s) {
  double inv;
  int first;
  if constexpr (FORM == WAVES_PB) {
    pb_s = c[0] * 86400.0;
    orbits = t / pb_s;
    inv = 1.0 / pb_s;
    first = 1;
  } else {
    horner(c, nfb, t, orbits, freq);
    const double pbp0 = 1.0 / freq;
    if constexpr (FORM == FBX) {
      pbprime = pbp0;
      return;
    }
    inv = 1.0 / pbp0;
    first = nfb;
  }
  const double om = c[first + 2 * nw];
  const double tw = t + tw_off;
  double dphi = 0.0, dphi_dot = 0.0;
  for (int k = 0; k < nw; ++k) {
    const double cc = c[first + 2 * k], ss = c[first + 2 * k + 1];
    const double w = (double)(k + 1) * om;
    const double ph = w * tw;
    double sp, cp;
    sincos(ph, &sp, &cp);
    dphi = dphi + cc * cp + ss * sp;
    dphi_dot = dphi_dot + w * (ss * cp - cc * sp);
  }
  orbits = orbits + dphi;
  pbprime = 1.0 / (inv + dphi_dot);
}

// The partials of one element into its row P[0 .. 2 (1 + nc)): orbits',
// then pbprime's, each pbprime entry stored as m dg, m = -pbprime^2.
template <int FORM>
__device__ __forceinline__ void partials(const double* c, int nfb, int nw,
                                         int nc, double t, double tw_off,
                                         double pbprime, double freq,
                                         double pb_s, double* P) {
  double* Po = P;
  double* Pg = P + 1 + nc;
  const double m = -(pbprime * pbprime);
  double po_t, pg_t;
  int first;
  if constexpr (FORM == WAVES_PB) {
    po_t = 1.0 / pb_s;
    Po[1] = -((t / pb_s) / pb_s) * 86400.0;
    Pg[1] = m * (0.0 - 86400.0 / (pb_s * pb_s));
    pg_t = 0.0;
    first = 1;
  } else {
    double cn = 1.0;
    for (int n = 0; n < nfb; ++n) {
      const double nxt = (cn * t) * (1.0 / (n + 1));
      Po[1 + n] = nxt;
      Pg[1 + n] = m * cn;
      cn = nxt;
    }
    double dfreq = 0.0;
    for (int n = nfb - 1; n > 0; --n) dfreq = (dfreq * t) * (1.0 / n) + c[n];
    po_t = freq;
    pg_t = dfreq;
    first = nfb;
  }
  if constexpr (FORM != FBX) {
    const double om = c[first + 2 * nw];
    const double tw = t + tw_off;
    double g_om_o = 0.0, g_om_g = 0.0;
    for (int k = 0; k < nw; ++k) {
      const double cc = c[first + 2 * k], ss = c[first + 2 * k + 1];
      const double w = (double)(k + 1) * om;
      const double ph = w * tw;
      double sp, cp;
      sincos(ph, &sp, &cp);
      const double rate = ss * cp - cc * sp;
      const double curv = ss * sp + cc * cp;
      Po[1 + first + 2 * k] = cp;
      Po[2 + first + 2 * k] = sp;
      Pg[1 + first + 2 * k] = m * -(w * sp);
      Pg[2 + first + 2 * k] = m * (w * cp);
      po_t = po_t + w * rate;
      pg_t = pg_t - (w * w) * curv;
      g_om_o = g_om_o + ((double)(k + 1) * tw) * rate;
      g_om_g = g_om_g + (double)(k + 1) * rate - (w * ((double)(k + 1) * tw)) * curv;
    }
    Po[nc] = g_om_o;
    Pg[nc] = m * g_om_g;
  }
  Po[0] = po_t;
  Pg[0] = m * pg_t;
}

// One TMA bulk store of ``bytes`` (a multiple of 16) from shared memory to
// a 16-byte-aligned global address, by the calling thread, which waits
// until the source has been read (the tile must outlive the copy).
__device__ __forceinline__ void bulk_store(double* dst, const double* src,
                                           unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      ::"l"(dst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int FORM>
__global__ void binary_orbits_primal(const double* __restrict__ tt0,
                                     const double* __restrict__ coef, int B,
                                     int N, int nc, int nfb, int nw,
                                     double tw_off,
                                     double* __restrict__ orbits_out,
                                     double* __restrict__ pbprime_out) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  const double* c = coef + (long)b * nc;
  const double t = tt0[idx];
  double orbits, pbprime, freq = 0.0, pb_s = 0.0;
  forward<FORM>(c, nfb, nw, t, tw_off, orbits, pbprime, freq, pb_s);
  orbits_out[idx] = orbits;
  pbprime_out[idx] = pbprime;
}

// blockDim.x threads, each with its row of 2 (1 + nc) doubles in the tile
// (STAGED) or in the output itself.
template <int FORM, bool STAGED>
__global__ void binary_orbits_dual(const double* __restrict__ tt0,
                                   const double* __restrict__ coef, int B,
                                   int N, int nc, int nfb, int nw,
                                   double tw_off,
                                   double* __restrict__ orbits_out,
                                   double* __restrict__ pbprime_out,
                                   double* __restrict__ P) {
  extern __shared__ __align__(16) double tile[];
  const long row = 2 * (1 + nc);
  const long first = (long)blockIdx.x * blockDim.x;
  const long idx = first + threadIdx.x;
  const long total = (long)B * N;
  if (idx < total) {
    const int b = (int)(idx / N);
    const double* c = coef + (long)b * nc;
    const double t = tt0[idx];
    double orbits, pbprime, freq = 0.0, pb_s = 0.0;
    forward<FORM>(c, nfb, nw, t, tw_off, orbits, pbprime, freq, pb_s);
    orbits_out[idx] = orbits;
    pbprime_out[idx] = pbprime;
    partials<FORM>(c, nfb, nw, nc, t, tw_off, pbprime, freq, pb_s,
                   STAGED ? tile + threadIdx.x * row : P + idx * row);
  }
  if constexpr (STAGED) {
    // the tile's rows are the output's [first, first + rows)
    const long rows = total - first < blockDim.x ? total - first : blockDim.x;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_store(P + first * row, tile, (unsigned)(rows * row * 8));
  }
}

// The shared memory a block may opt into (227 KB on the H100).
int max_smem() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return bytes;
}

template <int FORM>
int launch(const double* tt0, const double* coef, int B, int N, int nc,
           int nfb, int nw, double tw_off, double* orbits, double* pbprime,
           double* P, cudaStream_t st) {
  const long total = (long)B * N;
  if (P == nullptr) {
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    binary_orbits_primal<FORM><<<blocks, THREADS, 0, st>>>(
        tt0, coef, B, N, nc, nfb, nw, tw_off, orbits, pbprime);
    return 0;
  }
  if (reinterpret_cast<uintptr_t>(P) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long row_bytes = 16L * (1 + nc);
  int threads = THREADS;
  while (threads > 32 && threads * row_bytes > max_smem()) threads -= 32;
  const long smem = threads * row_bytes;
  if (smem > max_smem()) {
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    binary_orbits_dual<FORM, false><<<blocks, THREADS, 0, st>>>(
        tt0, coef, B, N, nc, nfb, nw, tw_off, orbits, pbprime, P);
    return 0;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        binary_orbits_dual<FORM, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  binary_orbits_dual<FORM, true><<<blocks, threads, smem, st>>>(
      tt0, coef, B, N, nc, nfb, nw, tw_off, orbits, pbprime, P);
  return 0;
}

}  // namespace

extern "C" int binary_orbits_launch(const double* tt0, const double* coef,
                                    int B, int N, int form, int nfb, int nw,
                                    double tw_off, double* orbits,
                                    double* pbprime, double* partials,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long)B * N == 0) return 0;
  int rc;
  switch (form) {
    case FBX:
      rc = launch<FBX>(tt0, coef, B, N, nfb, nfb, 0, tw_off, orbits, pbprime,
                       partials, st);
      break;
    case WAVES_PB:
      rc = launch<WAVES_PB>(tt0, coef, B, N, 2 + 2 * nw, 0, nw, tw_off,
                            orbits, pbprime, partials, st);
      break;
    case WAVES_FBX:
      rc = launch<WAVES_FBX>(tt0, coef, B, N, nfb + 1 + 2 * nw, nfb, nw,
                             tw_off, orbits, pbprime, partials, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

extern "C" const char* binary_orbits_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
