// K10 hd_cross_lnlike: the Hellings-Downs cross term of the joint PTA
// log-likelihood, one walker point (log10_A, gamma) per CTA.
//
// Replaces the cross term of pint_tpu/catalog/likelihood.py:112
// _joint_kernel (its lines 141-153: phi_gw and sqp, the einsum over the
// HD factor, the R x R Cholesky, the solve and the log-determinant, vmapped
// over the walker points).  The point-independent pieces are computed once
// by the caller (pint_torch/catalog/likelihood.py): G (R, R) row-major,
// G[a i, b j] = sum_c L_HD[c,a] L_HD[c,b] X_c[i,j], and u (R,), u[a i] =
// sum_c L_HD[c,a] y_c[i], with R = n_pulsars x 2 n_modes and row a i =
// a * 2 n_modes + i.  Per walker b:
//   amp    = exp(log10_A ln 10)
//   phi_k  = ((amp amp) scale) exp((gamma - 3) ln fyr) exp(-gamma ln f_k)
//            (scale = 1 / (12 pi^2 Tspan), every power as exp(y log x))
//   d_r    = sqrt(phi_{(r mod 2m) / 2})
//   M      = I + D G D  (M_ij = (d_i G_ij) d_j + delta_ij),  v = D u
//   L L^T = M (left-looking, column by column), z = L^-1 v
//   out_b  = 0.5 sum_j z_j^2 - sum_j log L_jj
// At log10_A = -inf the amplitude is exactly 0: M = I, v = 0, and the
// result is exactly 0.0 (the reference's factorization pin).
//
// Design: one CTA per walker; the factor lives in a global workspace (B,
// R, R + 1) the wrapper allocates, column-major per walker (column j's
// rows j..R at W[j (R + 1) + i]; row R is the augmented row that carries
// v, so that its entries become z).  Column j: phase 1, each thread takes
// rows i >= j (strided over the block) and forms s_i = M_ij - sum_{k<j}
// L_ik L_jk in ascending k (the row of v: v_j - sum z_k L_jk); a barrier;
// phase 2, every thread takes the same pivot sqrt(s_j), divides its rows,
// and thread 0 adds log L_jj; a barrier.  Thread 0 adds z_j^2 once column
// j is out.  Every sum runs in one fixed order in one thread; no atomics.
// Built with -fmad=false, each product and difference rounds alone, so the
// plain version (kernels/hd_cross_lnlike.py), a right-looking loop whose
// every entry sees the same rounding sequence, gives the same bits.
//
// What bounds it: the R^3 / 6 multiply-subtracts per walker (separate
// float64 instructions under -fmad=false) at the CUDA cores' instruction
// rate; in practice the left-looking loads (each column reads the
// trailing rows' prefixes, R^3 / 6 doubles per walker from L2 or HBM)
// and one SM per walker (B = 32 walkers fill 32 of 132 SMs).  A tiled,
// multi-CTA or DMMA factorization is later work (ROADMAP
// kernel-performance).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void hd_cross_kernel(const double* __restrict__ G,
                                const double* __restrict__ u,
                                const double* __restrict__ log10_A,
                                const double* __restrict__ gamma,
                                const double* __restrict__ freqs, int R,
                                int m, double scale, double ln10,
                                double lnfyr, double* __restrict__ W,
                                double* __restrict__ out) {
  extern __shared__ double sq[];  // sqrt(phi_k), k < m
  const int t = threadIdx.x, T = blockDim.x;
  const int b = blockIdx.x;
  const long LD = (long)R + 1;
  double* w = W + (long)b * R * LD;
  const int two_m = 2 * m;

  const double la = log10_A[b], g = gamma[b];
  for (int k = t; k < m; k += T) {
    const double amp = exp(la * ln10);
    const double phi = (((amp * amp) * scale) * exp((g - 3.0) * lnfyr))
                       * exp((-g) * log(freqs[k]));
    sq[k] = sqrt(phi);
  }
  __syncthreads();

  double acc_log = 0.0, acc_zz = 0.0;
  for (int j = 0; j < R; ++j) {
    const double dj = sq[(j % two_m) >> 1];
    double* colj = w + (long)j * LD;
    // phase 1: the column's entries before the division
    for (int i = j + t; i <= R; i += T) {
      double s;
      if (i < R)
        s = (sq[(i % two_m) >> 1] * G[(long)i * R + j]) * dj
            + (i == j ? 1.0 : 0.0);
      else
        s = dj * u[j];
      for (int k = 0; k < j; ++k) {
        const double* colk = w + (long)k * LD;
        s = s - colk[i] * colk[j];
      }
      colj[i] = s;
    }
    __syncthreads();
    // phase 2: the pivot (the same bits in every thread) and the division
    const double piv = sqrt(colj[j]);
    for (int i = j + 1 + t; i <= R; i += T) colj[i] = colj[i] / piv;
    if (t == 0) acc_log = acc_log + log(piv);
    __syncthreads();
    if (t == 0) {
      const double z = colj[R];
      acc_zz = acc_zz + z * z;
    }
  }
  if (t == 0) out[b] = 0.5 * acc_zz - acc_log;
}

}  // namespace

// G (R, R) row-major, u (R,), log10_A and gamma (B,), freqs (m,) with R a
// multiple of 2 m; workspace (B, R, R + 1); out (B,).  scale = 1 / (12 pi^2
// Tspan), ln10 = log(10), lnfyr = log(1 / yr in Hz), from the caller.
extern "C" int hd_cross_lnlike_launch(const double* G, const double* u,
                                      const double* log10_A,
                                      const double* gamma,
                                      const double* freqs, int B, int R,
                                      int m, double scale, double ln10,
                                      double lnfyr, double* workspace,
                                      double* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || R <= 0 || m <= 0 || R % (2 * m) != 0)
    return (int)cudaErrorInvalidValue;
  int threads = ((R + 1 + 31) / 32) * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  const size_t shmem = (size_t)m * sizeof(double);
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  hd_cross_kernel<<<B, threads, shmem, st>>>(G, u, log10_A, gamma, freqs, R,
                                             m, scale, ln10, lnfyr, workspace,
                                             out);
  return (int)cudaGetLastError();
}

extern "C" const char* hd_cross_lnlike_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
