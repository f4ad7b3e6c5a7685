// K1 spin_phase: the spindown pulse phase with its exact F0*t mod 1 fold.
//
// Replaces pint_tpu/dd.py:mul_mod1 (dd.py:355-390) and day2sec_exact
// (dd.py:396-414) as composed by pint_tpu/models/spindown.py:phase_func
// (spindown.py:70-123): dt = (tdb - delay - PEPOCH) is split into exact
// float64 "fold" components plus a small tail, F0 times each fold is folded
// mod 1 into an (integer, fraction) pair, F0*tail and the Horner series of
// F1..Fn go into the fraction, and the carry is renormalized as
// Phase.make does.  One thread per (point, TOA).
//
// Bound on this card: the primal reads the delay (8 B) and writes k, f
// (16 B) per element against ~117 f64 operations (S = 2 with PEPOCH).  In
// the dual instantiation the mul_mod1 folds still run on plain doubles and
// only the tangent sums and products have K = S + 2 lanes: 36 operations
// per lane, ~261 in all, against 56 B (the delay, k, f and 4 partials).
// Both lie below the H100's balance of ~10 f64 operations per byte, so
// both are bound by bytes.
// The design keeps everything per element in registers and the parameter
// rows in L1; a later PR can fuse the partials into their consumer.
//
// Partials: with respect to F0..F_{S-1}, the delay and PEPOCH's high word
// (index S+1).  The mul_mod1 rule mirrors the reference's custom JVP: the
// fold's whole derivative t*dF0 + F0*dt goes into the fraction.
//
// Compiled with -fmad=false: the folds assume each product is rounded
// alone.
#include "dual.cuh"

namespace {

constexpr double DAY_S = 86400.0;

// split x = hi + lo, hi a multiple of 2**(pow_bound - 25)
__device__ __forceinline__ void scaled_split(double x, double s, double& hi,
                                             double& lo) {
  hi = rne(x * (1.0 / s)) * s;
  lo = x - hi;
}

__device__ __forceinline__ void mul_mod1_impl(double c, double t, double& k,
                                              double& f) {
  double ch, cl, th, tl;
  scaled_split(c, 0x1p-13, ch, cl);  // |c| < 2**12
  scaled_split(t, 0x1p10, th, tl);   // |t| < 2**35
  k = 0.0;
  f = 0.0;
  double p, kp;
  p = ch * th;
  kp = rne(p);
  k = k + kp;
  f = f + (p - kp);
  p = ch * tl;
  kp = rne(p);
  k = k + kp;
  f = f + (p - kp);
  p = cl * th;
  kp = rne(p);
  k = k + kp;
  f = f + (p - kp);
  f = f + cl * tl;
  kp = rne(f);
  k = k + kp;
  f = f - kp;
}

__device__ __forceinline__ void mul_mod1(double c, double t, double& k,
                                         double& f) {
  mul_mod1_impl(c, t, k, f);
}
template <int K>
__device__ __forceinline__ void mul_mod1(const Dual<K>& c, const Dual<K>& t,
                                         double& k, Dual<K>& f) {
  mul_mod1_impl(c.v, t.v, k, f.v);
#pragma unroll
  for (int i = 0; i < K; ++i) f.d[i] = t.v * c.d[i] + c.v * t.d[i];
}

__device__ __forceinline__ void day2sec(double d, double& e1, double& e2) {
  double dh, dl;
  scaled_split(d, 0x1p-10, dh, dl);  // |d| < 2**15 days
  e1 = dh * DAY_S;
  e2 = dl * DAY_S;
}
template <int K>
__device__ __forceinline__ void day2sec(const Dual<K>& d, Dual<K>& e1,
                                        Dual<K>& e2) {
  day2sec(d.v, e1.v, e2.v);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    e1.d[i] = d.d[i] * DAY_S;
    e2.d[i] = 0.0;
  }
}

// the spindown phase of one (point, TOA); F holds S spin terms
template <typename T>
__device__ void spin_phase_math(double t_hi, double t_lo, double tdb0,
                                const T& pe_hi, double pe_lo, const T& delay,
                                const T* F, int S, int has_pe, double& k_out,
                                T& f_out) {
  T folds[3];
  int nf = 0;
  folds[nf++] = Lift<T>::of(t_hi);
  T tail = t_lo - delay;
  if (has_pe) {
    T e1, e2;
    day2sec(pe_hi - tdb0, e1, e2);
    folds[nf++] = -e1;
    folds[nf++] = -e2;
    tail = tail - pe_lo * DAY_S;
  }
  const T F0 = F[0];
  double k = 0.0;
  T f = Lift<T>::of(0.0);
  T dt64 = Lift<T>::of(0.0);
  for (int i = 0; i < nf; ++i) {
    double ki;
    T fi;
    mul_mod1(F0, folds[i], ki, fi);
    k = k + ki;
    f = f + fi;
    dt64 = dt64 + folds[i];
  }
  dt64 = dt64 + tail;
  f = f + F0 * tail;
  if (S > 1) {
    T acc = Lift<T>::of(0.0);
    double fact = 1.0;
    for (int i = 2; i <= S; ++i) fact *= (double)i;
    for (int i = S - 1; i >= 1; --i) {
      const T c = F[i] / fact;
      acc = acc * dt64 + c;
      fact /= (double)(i + 1);
    }
    f = f + acc * dt64 * dt64;
  }
  const double kk = rne(val(f));
  k_out = k + kk;
  f_out = f - kk;
}

constexpr int SMAX = 6;

__global__ void spin_phase_primal(const double* __restrict__ t_hi,
                                  const double* __restrict__ t_lo, double tdb0,
                                  const double* __restrict__ pe,
                                  const double* __restrict__ delay,
                                  const double* __restrict__ F, int B, int N,
                                  int S, int has_pe, double* __restrict__ k_out,
                                  double* __restrict__ f_out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  const int n = (int)(idx - (long)b * N);
  double Fb[SMAX];
  for (int i = 0; i < S; ++i) Fb[i] = F[b * S + i];
  double k, f;
  spin_phase_math<double>(t_hi[n], t_lo[n], tdb0, pe[2 * b], pe[2 * b + 1],
                          delay[idx], Fb, S, has_pe, k, f);
  k_out[idx] = k;
  f_out[idx] = f;
}

template <int S>
__global__ void spin_phase_dual(const double* __restrict__ t_hi,
                                const double* __restrict__ t_lo, double tdb0,
                                const double* __restrict__ pe,
                                const double* __restrict__ delay,
                                const double* __restrict__ F, int B, int N,
                                int has_pe, double* __restrict__ k_out,
                                double* __restrict__ f_out,
                                double* __restrict__ partials) {
  constexpr int K = S + 2;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  const int n = (int)(idx - (long)b * N);
  Dual<K> Fb[S];
#pragma unroll
  for (int i = 0; i < S; ++i) Fb[i] = dvar<K>(F[b * S + i], i);
  const Dual<K> dl = dvar<K>(delay[idx], S);
  const Dual<K> ph = dvar<K>(pe[2 * b], S + 1);
  double k;
  Dual<K> f;
  spin_phase_math<Dual<K>>(t_hi[n], t_lo[n], tdb0, ph, pe[2 * b + 1], dl, Fb,
                           S, has_pe, k, f);
  k_out[idx] = k;
  f_out[idx] = f.v;
#pragma unroll
  for (int i = 0; i < K; ++i) partials[idx * K + i] = f.d[i];
}

template <int S>
cudaError_t launch_dual(const double* t_hi, const double* t_lo, double tdb0,
                        const double* pe, const double* delay, const double* F,
                        int B, int N, int has_pe, double* k, double* f,
                        double* P, cudaStream_t stream) {
  const long total = (long)B * N;
  const int threads = 128;
  const long blocks = (total + threads - 1) / threads;
  spin_phase_dual<S><<<(unsigned)blocks, threads, 0, stream>>>(
      t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int spin_phase_launch(const double* t_hi, const double* t_lo,
                                 double tdb0, const double* pe,
                                 const double* delay, const double* F, int B,
                                 int N, int S, int has_pe, double* k, double* f,
                                 double* partials, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > SMAX) return (int)cudaErrorInvalidValue;
  if ((long)B * N == 0) return 0;
  if (partials == nullptr) {
    const long total = (long)B * N;
    const int threads = 128;
    const long blocks = (total + threads - 1) / threads;
    spin_phase_primal<<<(unsigned)blocks, threads, 0, st>>>(
        t_hi, t_lo, tdb0, pe, delay, F, B, N, S, has_pe, k, f);
    return (int)cudaGetLastError();
  }
  switch (S) {
    case 1: return (int)launch_dual<1>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 2: return (int)launch_dual<2>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 3: return (int)launch_dual<3>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 4: return (int)launch_dual<4>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 5: return (int)launch_dual<5>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    default: return (int)launch_dual<6>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
  }
}

extern "C" const char* spin_phase_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
