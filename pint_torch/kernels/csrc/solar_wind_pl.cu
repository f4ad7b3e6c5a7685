// K7 solar_wind_pl: the power-law solar-wind path geometry per (point,
// TOA), with its partials on request.
//
// Replaces pint_tpu/models/solar_wind.py:solar_wind_geometry_pl (:65)
// with _sw_I (:55), the 64-node Gauss-Legendre integral of cos(phi)^(p-2)
// over [0, arctan(z/b)], as SolarWindDispersion (SWM 1, :111-178) and
// SolarWindDispersionX (per window, :278-290) call it: the Hazboun et al.
// (2022) eq. 11 geometry
//   g = (AU / b)^p (b / pc) (I_inf(p) + I(z / b, p)),
//   b = r sin(theta), z = r cos(theta), I(u, p) = (phi_max / 2)
//   sum_j w_j cos(phi_max / 2 (x_j + 1))^(p - 2), phi_max = arctan(u),
// in parsecs, r the observatory-Sun distance [ls] and theta the pulsar's
// elongation [rad].  I_inf(p) (a ratio of gamma functions, one per point
// and window) comes in from torch, as do the nodes x_j and weights w_j
// (numpy's leggauss(64), the reference's own; never retyped here).  The
// 64 terms are summed in index order, which the plain twin
// (kernels/solar_wind_pl.py) repeats, so g is bitwise the twin's.  Unlike
// K1-K6 this file is built with contraction on: the library's pow() built
// with -fmad=false rounds a few values in a million a bit apart from
// torch's pow, which is built with it on; the kernel's own additions,
// products and divisions are the never-fused __d*_rn intrinsics, so each
// still rounds alone.
//
// Each point carries W power-law indices (W = 1: NE_SW's SWP; W = nswx:
// one SWXP_ per window) and each TOA a window index (win[n] < 0: no
// window, g = 0); a TOA's geometry is computed for its own window only,
// as the reference's masked sum over disjoint windows gives it.
//
// The dual writes dg/dtheta (the astrometry's partials reach the
// elongation through it), dg/dp (SWP, SWXP_ may be fitted) and dg/dI_inf
// (through which torch chains I_inf's dependence on p), (B, N, 3).  One
// thread per (point, TOA); ops-bound: 64 cosines and powers an element.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int NGL = 64;
constexpr double AU_LS = 1.495978707e11 / 299792458.0;        // AU / c
constexpr double PC_LS = 3.0856775814913673e16 / 299792458.0;  // pc / c

// The kernel's own arithmetic, rounded once each: the file is built with
// contraction on (kernels/_build.py CONTRACTED) so that the library's pow()
// rounds as torch's (built so) does, and these intrinsics are never fused.
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}

template <bool DUAL>
__global__ void solar_wind_pl_kernel(const double* __restrict__ r,
                                     const double* __restrict__ theta,
                                     const double* __restrict__ p,
                                     const double* __restrict__ iinf,
                                     const int* __restrict__ win,
                                     const double* __restrict__ gl,
                                     int B, int N, int W,
                                     double* __restrict__ geom,
                                     double* __restrict__ P) {
  __shared__ double x1[NGL], wj[NGL];
  if (threadIdx.x < NGL) {
    x1[threadIdx.x] = add(gl[threadIdx.x], 1.0);
    wj[threadIdx.x] = gl[NGL + threadIdx.x];
  }
  __syncthreads();
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long)B * N) return;
  const int b = (int)(idx / N);
  const int n = (int)(idx - (long)b * N);
  const int k = win == nullptr ? 0 : win[n];
  if (k < 0) {
    geom[idx] = 0.0;
    if constexpr (DUAL) {
      P[3 * idx] = 0.0;
      P[3 * idx + 1] = 0.0;
      P[3 * idx + 2] = 0.0;
    }
    return;
  }
  const double pk = p[(long)b * W + k];
  const double ik = iinf[(long)b * W + k];
  const double rn = r[n];
  const double th = theta[idx];
  // sin() and cos() apart, each the bits of the twin's torch.sin and
  // torch.cos
  const double bb = mul(rn, sin(th));
  const double z = mul(rn, cos(th));
  const double u = dvd(z, bb);
  const double half = mul(0.5, atan(u));
  const double pm2 = sub(pk, 2.0);
  double acc = 0.0, acc_h = 0.0, acc_p = 0.0;
  for (int j = 0; j < NGL; ++j) {
    const double phi = mul(half, x1[j]);
    const double cp = cos(phi);
    const double v = pow(cp, pm2);
    acc = add(acc, mul(wj[j], v));
    if constexpr (DUAL) {
      const double sp = sin(phi);
      // w (-(pm2 v sp / cp) x1) and w (v log(cp))
      acc_h = add(acc_h,
                  mul(wj[j], mul(-dvd(mul(mul(pm2, v), sp), cp), x1[j])));
      acc_p = add(acc_p, mul(wj[j], mul(v, log(cp))));
    }
  }
  const double I = mul(half, acc);
  const double a = mul(pow(dvd(AU_LS, bb), pk), dvd(bb, PC_LS));
  const double C = add(ik, I);
  geom[idx] = mul(a, C);
  if constexpr (DUAL) {
    // half = arctan(z / b) / 2; dz = -b dtheta, db = z dtheta
    const double bb2 = mul(bb, bb);
    const double du = dvd(sub(-bb2, mul(z, z)), bb2);
    const double dhalf = dvd(mul(0.5, du), add(1.0, mul(u, u)));
    const double dI_dth = mul(add(acc, mul(half, acc_h)), dhalf);
    const double dI_dp = mul(half, acc_p);
    const double da_dth = mul(dvd(mul(sub(1.0, pk), a), bb), z);
    const double da_dp = mul(a, log(dvd(AU_LS, bb)));
    P[3 * idx] = add(mul(da_dth, C), mul(a, dI_dth));
    P[3 * idx + 1] = add(mul(da_dp, C), mul(a, dI_dp));
    P[3 * idx + 2] = a;
  }
}

}  // namespace

extern "C" int solar_wind_pl_launch(const double* r, const double* theta,
                                    const double* p, const double* iinf,
                                    const int* win, const double* gl, int B,
                                    int N, int W, double* geom, double* P,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long total = (long)B * N;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (P == nullptr)
    solar_wind_pl_kernel<false><<<blocks, THREADS, 0, st>>>(
        r, theta, p, iinf, win, gl, B, N, W, geom, P);
  else
    solar_wind_pl_kernel<true><<<blocks, THREADS, 0, st>>>(
        r, theta, p, iinf, win, gl, B, N, W, geom, P);
  return (int)cudaGetLastError();
}

extern "C" const char* solar_wind_pl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
