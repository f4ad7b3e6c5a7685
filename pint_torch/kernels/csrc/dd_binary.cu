// K2 dd_binary: the Damour-Deruelle binary delay per (point, TOA).
//
// Replaces pint_tpu/models/binary/engines.py:orbits_pb, solve_kepler,
// dd_state and dd_delay_core (engines.py:38-226) as called by
// BinaryDD.delay_func (components.py:195-205 and :458-475): orbits and the
// instantaneous period from PB/PBDOT/XPBDOT, the mean anomaly, 15 clamped
// Newton steps of Kepler's equation, the true anomaly and periastron
// advance, then the inverse-timing Roemer/Einstein delay, the Shapiro delay
// and the A0/B0 aberration.  One thread per (point, TOA).
//
// Parameter row (16 values): PB, PBDOT, XPBDOT, A1, A1DOT, ECC, EDOT, OM,
// OMDOT, M2, SINI, GAMMA, DR, DTH, A0, B0 -- the reference's units (PB in
// days, OM in degrees, OMDOT in deg/yr, M2 in solar masses).  Partials are
// with respect to tt0 (index 0) and the 16 parameters (1..16).
//
// Bound on this card: operations.  Per element it reads tt0 (8 B) and
// writes the delay (8 B), or 17 more partials, against ~1144 f64
// operations for the primal (735 of them in the 15 Newton steps; a sine,
// cosine, arctangent, logarithm or square root counted as 20) and ~446 more
// per lane with partials, ~8700 in all; at the H100's 34 TFLOP/s f64 that
// is the binding limit.
// The design keeps the whole chain in registers (the dual instantiation
// spills to L1-cached local memory) and reads the parameter row once.
//
// NaN propagates: the Newton clamp is written as comparisons that keep NaN,
// so a point outside the physical domain (SINI > 1 making the Shapiro log
// negative) poisons its delay instead of returning a number.
#include "dual.cuh"

namespace {

constexpr double TWO_PI = 6.283185307179586;        // 2.0 * math.pi
constexpr double DEG = 0.017453292519943295;        // math.pi / 180.0
constexpr double SEC_PER_YEAR = 31557600.0;         // 365.25 * 86400.0
constexpr double TSUN = 4.925490947000518e-06;      // G Msun / c^3 [s]
constexpr int NPAR = 16;
constexpr int NPARTIAL = NPAR + 1;

template <typename T>
__device__ T dd_delay_math(const T& tt0, const T* p) {
  // orbits_pb
  const T pb_s = p[0] * 86400.0;
  const T pbdot = p[1] + p[2];
  const T frac = tt0 / pb_s;
  const T orbits = frac - 0.5 * pbdot * frac * frac;
  const T pbprime = pb_s + p[1] * tt0;
  // mean_anomaly
  const double fl = floor(val(orbits));
  const T M = (orbits - fl) * TWO_PI;
  // ecc_at
  const T e = p[5] + tt0 * p[6];
  // solve_kepler: 15 clamped Newton steps
  T E = M + e * dsin(M);
  for (int it = 0; it < 15; ++it) {
    const T dE = (E - e * dsin(E) - M) / (1.0 - e * dcos(E));
    E = E - dclip(dE, -1.0, 1.0);
  }
  const T sinE = dsin(E);
  const T cosE = dcos(E);
  // dd_state: true anomaly and periastron advance
  const T nu = 2.0 * datan2(dsqrt(1.0 + e) * dsin(E / 2.0),
                            dsqrt(1.0 - e) * dcos(E / 2.0));
  const T k = p[8] * DEG / SEC_PER_YEAR / (TWO_PI / pbprime);
  const T nu_cont = nu + TWO_PI * fl + (val(nu) < 0.0 ? TWO_PI : 0.0);
  const T omega = p[7] * DEG + k * nu_cont;
  // a1_at
  const T a1 = p[3] + tt0 * p[4];
  // dd_delay_core
  const T m2_tsun = p[9] * TSUN;
  const T er = e * (1.0 + p[12]);
  const T eth = e * (1.0 + p[13]);
  const T sin_om = dsin(omega);
  const T cos_om = dcos(omega);
  const T alpha = a1 * sin_om;
  const T beta = a1 * dsqrt(1.0 - eth * eth) * cos_om;
  const T Dre = alpha * (cosE - er) + beta * sinE + p[11] * sinE;
  const T Drep = -alpha * sinE + (beta + p[11]) * cosE;
  const T Drepp = -alpha * cosE - (beta + p[11]) * sinE;
  const T nhat = TWO_PI / pbprime / (1.0 - e * cosE);
  const T nD = nhat * Drep;
  const T nhat2 = nhat * nhat;
  const T delayI =
      Dre * (1.0 - nhat * Drep + nD * nD + 0.5 * nhat2 * Dre * Drepp -
             0.5 * e * sinE / (1.0 - e * cosE) * nhat2 * Dre * Drep);
  const T brace =
      1.0 - e * cosE -
      p[10] * (sin_om * (cosE - e) + dsqrt(1.0 - e * e) * cos_om * sinE);
  const T delayS = -2.0 * m2_tsun * dlog(brace);
  const T om_plus_nu = omega + nu;
  const T delayA = p[14] * (dsin(om_plus_nu) + e * sin_om) +
                   p[15] * (dcos(om_plus_nu) + e * cos_om);
  return delayI + delayS + delayA;
}

__global__ void dd_binary_primal(const double* __restrict__ tt0,
                                 const double* __restrict__ params, int B,
                                 int N, double* __restrict__ delay) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  double p[NPAR];
#pragma unroll
  for (int i = 0; i < NPAR; ++i) p[i] = params[b * NPAR + i];
  delay[idx] = dd_delay_math<double>(tt0[idx], p);
}

__global__ void dd_binary_dual(const double* __restrict__ tt0,
                               const double* __restrict__ params, int B, int N,
                               double* __restrict__ delay,
                               double* __restrict__ partials) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  Dual<NPARTIAL> p[NPAR];
#pragma unroll
  for (int i = 0; i < NPAR; ++i)
    p[i] = dvar<NPARTIAL>(params[b * NPAR + i], i + 1);
  const Dual<NPARTIAL> t = dvar<NPARTIAL>(tt0[idx], 0);
  const Dual<NPARTIAL> r = dd_delay_math<Dual<NPARTIAL>>(t, p);
  delay[idx] = r.v;
#pragma unroll
  for (int i = 0; i < NPARTIAL; ++i) partials[idx * NPARTIAL + i] = r.d[i];
}

}  // namespace

extern "C" int dd_binary_launch(const double* tt0, const double* params, int B,
                                int N, double* delay, double* partials,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long total = (long)B * N;
  if (total == 0) return 0;
  const int threads = 128;
  const long blocks = (total + threads - 1) / threads;
  if (partials == nullptr) {
    dd_binary_primal<<<(unsigned)blocks, threads, 0, st>>>(tt0, params, B, N,
                                                           delay);
  } else {
    dd_binary_dual<<<(unsigned)blocks, threads, 0, st>>>(tt0, params, B, N,
                                                         delay, partials);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dd_binary_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
