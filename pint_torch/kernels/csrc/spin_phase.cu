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
//
// Design.  Both instantiations are templates on S (1..6), so the row and
// the Horner loop live in registers (no stack frame).  A 2-D grid gives
// each block THREADS TOAs of one row b (blockIdx.y): the block's first
// threads load its row into shared memory -- F0, the Horner coefficients
// F[i] / (i+1)! (the divisions the per-element code made, once per block)
// and PEPOCH -- while every thread's own inputs are already in flight, and
// no thread divides by N.  The folds and the tail stay per element.  The
// dual stages its S + 2 partials in shared memory (rows padded to an odd
// stride) so that each block writes its rows of the (B, N, S + 2) output
// contiguously.
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

// (i)!, exact in float64 for the orders the kernel takes
__device__ __forceinline__ double factorial(int i) {
  double r = 1.0;
  for (int j = 2; j <= i; ++j) r *= (double)j;
  return r;
}

// The spindown phase of one (point, TOA).  F0 is the first spin term and
// C[i] (i = 1..S-1) the Horner coefficient F[i] / (i+1)!, which the block
// computes once for its row.
template <typename T, int S>
__device__ __forceinline__ void spin_phase_math(
    double t_hi, double t_lo, double tdb0, const T& pe_hi, double pe_lo,
    const T& delay, const T& F0, const T* C, int has_pe, double& k_out,
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
#pragma unroll
    for (int i = S - 1; i >= 1; --i) acc = acc * dt64 + C[i];
    f = f + acc * dt64 * dt64;
  }
  const double kk = rne(val(f));
  k_out = k + kk;
  f_out = f - kk;
}

constexpr int SMAX = 6;
constexpr int THREADS = 128;
constexpr int MAX_GRID_Y = 65535;

// The block's row b into shared memory: F0, the Horner coefficients
// F[i] / (i+1)! (i = 1..S-1), PEPOCH's (hi, lo) and, for the partials
// (DUAL), the coefficients' derivatives 1 / (i+1)! at S + 1 + i.  The
// first threads compute them with the divisions the per-element code made.
template <int S, bool DUAL>
__device__ __forceinline__ void load_row(const double* __restrict__ F,
                                         const double* __restrict__ pe,
                                         long b, double* row) {
  const int t = threadIdx.x;
  if (t == 0) {
    row[0] = F[b * S];
  } else if (t < S) {
    row[t] = F[b * S + t] / factorial(t + 1);
  } else if (t < S + 2) {
    row[t] = pe[2 * b + (t - S)];
  } else if (DUAL && t < 2 * S + 1) {
    row[t] = 1.0 / factorial(t - S);
  }
  __syncthreads();
}

// One block covers THREADS TOAs of one row b = b0 + blockIdx.y.  Each
// thread's inputs are loaded before the row's barrier, so that their
// latency overlaps the row's.
template <int S>
__global__ void spin_phase_primal(const double* __restrict__ t_hi,
                                  const double* __restrict__ t_lo, double tdb0,
                                  const double* __restrict__ pe,
                                  const double* __restrict__ delay,
                                  const double* __restrict__ F, int b0, int N,
                                  int has_pe, double* __restrict__ k_out,
                                  double* __restrict__ f_out) {
  __shared__ double row[S + 2];
  const long b = (long)b0 + blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const long idx = b * N + n;
  const bool in = n < N;
  const double th = in ? t_hi[n] : 0.0, tl = in ? t_lo[n] : 0.0,
               dl = in ? delay[idx] : 0.0;
  load_row<S, false>(F, pe, b, row);
  if (!in) return;
  double C[S];
#pragma unroll
  for (int i = 1; i < S; ++i) C[i] = row[i];
  double k, f;
  spin_phase_math<double, S>(th, tl, tdb0, row[S], row[S + 1], dl, row[0], C,
                             has_pe, k, f);
  k_out[idx] = k;
  f_out[idx] = f;
}

// As the primal, with the S + 2 partials of f staged in shared memory
// (rows padded to an odd stride) so that the block writes its rows of the
// (B, N, S + 2) output contiguously.
template <int S>
__global__ void spin_phase_dual(const double* __restrict__ t_hi,
                                const double* __restrict__ t_lo, double tdb0,
                                const double* __restrict__ pe,
                                const double* __restrict__ delay,
                                const double* __restrict__ F, int b0, int N,
                                int has_pe, double* __restrict__ k_out,
                                double* __restrict__ f_out,
                                double* __restrict__ partials) {
  constexpr int K = S + 2;
  constexpr int KP = K | 1;
  __shared__ double row[2 * S + 1];
  __shared__ double stage[THREADS * KP];
  const long b = (long)b0 + blockIdx.y;
  const int n0 = blockIdx.x * THREADS;
  const int n = n0 + threadIdx.x;
  const long idx = b * N + n;
  const bool in = n < N;
  const double th = in ? t_hi[n] : 0.0, tl = in ? t_lo[n] : 0.0,
               d = in ? delay[idx] : 0.0;
  load_row<S, true>(F, pe, b, row);
  if (in) {
    Dual<K> C[S];
#pragma unroll
    for (int i = 1; i < S; ++i) {
      C[i] = dconst<K>(row[i]);
      C[i].d[i] = row[S + 1 + i];
    }
    const Dual<K> F0 = dvar<K>(row[0], 0);
    const Dual<K> dl = dvar<K>(d, S);
    const Dual<K> ph = dvar<K>(row[S], S + 1);
    double k;
    Dual<K> f;
    spin_phase_math<Dual<K>, S>(th, tl, tdb0, ph, row[S + 1], dl, F0, C,
                                has_pe, k, f);
    k_out[idx] = k;
    f_out[idx] = f.v;
#pragma unroll
    for (int i = 0; i < K; ++i) stage[threadIdx.x * KP + i] = f.d[i];
  }
  __syncthreads();
  const int m = (N - n0 < THREADS ? N - n0 : THREADS) * K;
  double* out = partials + ((long)b * N + n0) * K;
  for (int e = threadIdx.x; e < m; e += THREADS)
    out[e] = stage[(e / K) * KP + e % K];
}

template <int S>
cudaError_t launch(const double* t_hi, const double* t_lo, double tdb0,
                   const double* pe, const double* delay, const double* F,
                   int B, int N, int has_pe, double* k, double* f, double* P,
                   cudaStream_t stream) {
  const unsigned nx = (unsigned)((N + THREADS - 1) / THREADS);
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const dim3 grid(nx, (unsigned)(B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y));
    if (P == nullptr)
      spin_phase_primal<S><<<grid, THREADS, 0, stream>>>(
          t_hi, t_lo, tdb0, pe, delay, F, b0, N, has_pe, k, f);
    else
      spin_phase_dual<S><<<grid, THREADS, 0, stream>>>(
          t_hi, t_lo, tdb0, pe, delay, F, b0, N, has_pe, k, f, P);
  }
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
  switch (S) {
    case 1: return (int)launch<1>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 2: return (int)launch<2>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 3: return (int)launch<3>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 4: return (int)launch<4>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    case 5: return (int)launch<5>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
    default: return (int)launch<6>(t_hi, t_lo, tdb0, pe, delay, F, B, N, has_pe, k, f, partials, st);
  }
}

extern "C" const char* spin_phase_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
