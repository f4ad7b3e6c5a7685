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
// (kernels/solar_wind_pl.py) repeats, so g is bitwise the twin's.  Each
// power is exp(y log(x)), one logarithm and one exponential, where CUDA's
// pow() computes its logarithm in double-double first; the dual's d/dp sum
// reuses the node's logarithm and takes sin(phi) and cos(phi) from one
// sincos(), as both instantiations take sin(theta) and cos(theta).  Built
// with -fmad=false like K1-K6: every product and sum rounds alone, as the
// twin's torch operations do.
//
// Each point carries W power-law indices (W = 1: NE_SW's SWP; W = nswx:
// one SWXP_ per window) and each TOA a window index (win[n] < 0: no
// window, g = 0); a TOA's geometry is computed for its own window only,
// as the reference's masked sum over disjoint windows gives it.
//
// The dual writes dg/dtheta (the astrometry's partials reach the
// elongation through it), dg/dp (SWP, SWXP_ may be fitted) and dg/dI_inf
// (through which torch chains I_inf's dependence on p), (B, N, 3), each
// thread its three straight to the output: staged through shared memory
// to leave as one contiguous run, as K2's dual writes its partials, they
// took 7% longer on the pta stand-in's call (tools/torch_kernel_variants.py
// `staged`), since 24 bytes an element are nothing to this kernel.  One
// thread per (point, TOA); bound by its operations: 64 nodes an element,
// each a cosine (the dual a sincos), a logarithm and an exponential
// (chip_smoke.py K7_OPS counts them).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int NGL = 64;
constexpr double AU_LS = 1.495978707e11 / 299792458.0;        // AU / c
constexpr double PC_LS = 3.0856775814913673e16 / 299792458.0;  // pc / c

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
    x1[threadIdx.x] = gl[threadIdx.x] + 1.0;
    wj[threadIdx.x] = gl[NGL + threadIdx.x];
  }
  __syncthreads();
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long)B * N) return;
  double* row = DUAL ? P + 3 * idx : nullptr;  // the element's partials
  const int b = (int)(idx / N);
  const int n = (int)(idx - (long)b * N);
  const int k = win == nullptr ? 0 : win[n];
  if (k < 0) {
    geom[idx] = 0.0;
    if constexpr (DUAL) row[0] = row[1] = row[2] = 0.0;
  } else {
    const double pk = p[(long)b * W + k];
    const double ik = iinf[(long)b * W + k];
    const double rn = r[n];
    const double th = theta[idx];
    // one sincos(), each result the bits of the twin's torch.sin and
    // torch.cos
    double st, ct;
    sincos(th, &st, &ct);
    const double bb = rn * st;
    const double z = rn * ct;
    const double u = z / bb;
    const double half = 0.5 * atan(u);
    const double pm2 = pk - 2.0;
    double acc = 0.0, acc_h = 0.0, acc_p = 0.0;
    for (int j = 0; j < NGL; ++j) {
      const double phi = half * x1[j];
      double sp, cp;
      if constexpr (DUAL)
        sincos(phi, &sp, &cp);
      else
        cp = cos(phi);
      // cos(phi)^(p - 2), with the logarithm the dual's d/dp sum reuses
      const double lc = log(cp);
      const double v = exp(pm2 * lc);
      acc = acc + wj[j] * v;
      if constexpr (DUAL) {
        // w (-(pm2 v sp / cp) x1) and w (v log(cp))
        acc_h = acc_h + wj[j] * (-(pm2 * v * sp / cp) * x1[j]);
        acc_p = acc_p + wj[j] * (v * lc);
      }
    }
    const double I = half * acc;
    // (AU / b)^p (b / pc), the logarithm shared with d/dp
    const double la = log(AU_LS / bb);
    const double a = exp(pk * la) * (bb / PC_LS);
    const double C = ik + I;
    geom[idx] = a * C;
    if constexpr (DUAL) {
      // half = arctan(z / b) / 2; dz = -b dtheta, db = z dtheta
      const double bb2 = bb * bb;
      const double du = (-bb2 - z * z) / bb2;
      const double dhalf = 0.5 * du / (1.0 + u * u);
      const double dI_dth = (acc + half * acc_h) * dhalf;
      const double dI_dp = half * acc_p;
      const double da_dth = (1.0 - pk) * a / bb * z;
      const double da_dp = a * la;
      row[0] = da_dth * C + a * dI_dth;
      row[1] = da_dp * C + a * dI_dp;
      row[2] = a;
    }
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
