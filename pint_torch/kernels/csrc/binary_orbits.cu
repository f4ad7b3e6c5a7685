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
// Six instantiations: primal and dual (DUAL, a template parameter) of each
// FORM.  One thread per (point, TOA).  The primal is a few hundred operations a
// TOA and bound by its bytes (t in, two values out); the dual recomputes
// the wave terms' sines and cosines in its partial pass rather than keep
// 2 nwaves of them, and writes 16 (1 + ncoef) bytes a TOA.
#include <cuda_runtime.h>
#include <math.h>

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

// The partials of one element into P[0 .. 2 (1 + nc)): orbits' then
// pbprime's; the pbprime row is first written as dg and scaled at the end.
template <int FORM>
__device__ __forceinline__ void partials(const double* c, int nfb, int nw,
                                         int nc, double t, double tw_off,
                                         double pbprime, double freq,
                                         double pb_s, double* P) {
  double* Po = P;
  double* Pg = P + 1 + nc;
  double po_t, pg_t;
  int first;
  if constexpr (FORM == WAVES_PB) {
    po_t = 1.0 / pb_s;
    Po[1] = -((t / pb_s) / pb_s) * 86400.0;
    Pg[1] = 0.0 - 86400.0 / (pb_s * pb_s);
    pg_t = 0.0;
    first = 1;
  } else {
    double cn = 1.0;
    for (int n = 0; n < nfb; ++n) {
      const double nxt = (cn * t) * (1.0 / (n + 1));
      Po[1 + n] = nxt;
      Pg[1 + n] = cn;
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
      Pg[1 + first + 2 * k] = -(w * sp);
      Pg[2 + first + 2 * k] = w * cp;
      po_t = po_t + w * rate;
      pg_t = pg_t - (w * w) * curv;
      g_om_o = g_om_o + ((double)(k + 1) * tw) * rate;
      g_om_g = g_om_g + (double)(k + 1) * rate - (w * ((double)(k + 1) * tw)) * curv;
    }
    Po[nc] = g_om_o;
    Pg[nc] = g_om_g;
  }
  Po[0] = po_t;
  Pg[0] = pg_t;
  const double m = -(pbprime * pbprime);
  for (int j = 0; j <= nc; ++j) Pg[j] = m * Pg[j];
}

template <int FORM, bool DUAL>
__global__ void binary_orbits_kernel(const double* __restrict__ tt0,
                                     const double* __restrict__ coef, int B,
                                     int N, int nc, int nfb, int nw,
                                     double tw_off,
                                     double* __restrict__ orbits_out,
                                     double* __restrict__ pbprime_out,
                                     double* __restrict__ P) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  const double* c = coef + (long)b * nc;
  const double t = tt0[idx];
  double orbits, pbprime, freq = 0.0, pb_s = 0.0;
  forward<FORM>(c, nfb, nw, t, tw_off, orbits, pbprime, freq, pb_s);
  orbits_out[idx] = orbits;
  pbprime_out[idx] = pbprime;
  if constexpr (DUAL)
    partials<FORM>(c, nfb, nw, nc, t, tw_off, pbprime, freq, pb_s,
                   P + idx * 2 * (1 + nc));
}

template <int FORM>
void launch(const double* tt0, const double* coef, int B, int N, int nc,
            int nfb, int nw, double tw_off, double* orbits, double* pbprime,
            double* P, cudaStream_t st) {
  const long total = (long)B * N;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (P == nullptr)
    binary_orbits_kernel<FORM, false><<<blocks, THREADS, 0, st>>>(
        tt0, coef, B, N, nc, nfb, nw, tw_off, orbits, pbprime, P);
  else
    binary_orbits_kernel<FORM, true><<<blocks, THREADS, 0, st>>>(
        tt0, coef, B, N, nc, nfb, nw, tw_off, orbits, pbprime, P);
}

}  // namespace

extern "C" int binary_orbits_launch(const double* tt0, const double* coef,
                                    int B, int N, int form, int nfb, int nw,
                                    double tw_off, double* orbits,
                                    double* pbprime, double* partials,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long)B * N == 0) return 0;
  switch (form) {
    case FBX:
      launch<FBX>(tt0, coef, B, N, nfb, nfb, 0, tw_off, orbits, pbprime,
                  partials, st);
      break;
    case WAVES_PB:
      launch<WAVES_PB>(tt0, coef, B, N, 2 + 2 * nw, 0, nw, tw_off, orbits,
                       pbprime, partials, st);
      break;
    case WAVES_FBX:
      launch<WAVES_FBX>(tt0, coef, B, N, nfb + 1 + 2 * nw, nfb, nw, tw_off,
                        orbits, pbprime, partials, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* binary_orbits_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
