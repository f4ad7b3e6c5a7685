// K11 compensated_matmul: a float64 matrix product computed from operands
// rounded to a reduced compute dtype (float32 or bfloat16), the products
// re-entering float64 by one of four accumulation modes.
//
// Replaces pint_tpu/precision/compensated.py:163 _matmul_jnp with its
// operand split :152 _dd_split_jnp and the fold :121 two_sum_accumulate:
//   native    products and sum in float32, the sum rounded to the compute
//             dtype, then widened (bfloat16 x bfloat16 is exact in float32);
//   f64       the rounded operands' products, exact in float64, summed in
//             float64;
//   two_sum   float64 partial sums over the contraction blocks of
//             _split_slices(k, split) (np.linspace(0, k, n + 1).astype(int)
//             boundaries, computed on the host and passed by value), the
//             partials folded in block order by Knuth's two_sum exactly as
//             two_sum_accumulate does: hi = p0; (hi, e) = two_sum(hi, p);
//             lo = e for the first e, lo + e after; hi + lo;
//   two_prod  each operand split in registers as x = hi + lo, hi and lo
//             rounded to the compute dtype (lo = x - (double)hi, rounded);
//             three float64 sums hi*hi, hi*lo, lo*hi over the whole
//             contraction, folded in that order as above.
// Rounding a double to bfloat16 goes through float32 (round to nearest
// even twice), as the reference's astype does on both its host (ml_dtypes)
// and device (XLA) paths and as torch's .to(torch.bfloat16) does.
//
// Operands: a (batch, m, k) and b (batch, k, n) float64 with any strides (a
// stride of 0 for an operand shared by the batch; the wrapper maps a 1-D b
// to (k, 1) and a 1-D a to (1, k)).  Output (batch, m, n) float64,
// contiguous.  Design (simple first): one CTA of 16 x 16 threads per 16 x 16
// output tile, a thread per output element; each 16-deep stage of the
// contraction is loaded, rounded (and split) once per element into shared
// memory.  Each thread walks the contraction blocks in order (one block,
// [0, k), outside two_sum) and, under two_sum, folds each block's partial
// into its (hi, lo) pair in registers as soon as the block ends.  Within a
// block each thread sums its products in three levels -- a stage's 16, then
// 16 stages, then those sums -- so that a sum of k products carries about
// (32 + k / 256) roundings, not k: a serve Gram's sums over 4096 padded
// rows at a condition of ~1.7e7 left its uncertainties 1.2e-8 from the
// reference's when summed in one run (as cuBLAS's single reduction did, PR
// 14), which the three levels bring to the 256-row blocks' level.  Built
// with -fmad=false like K1-K10: no product is fused into a sum, which keeps
// two_sum error-free.
//
// Bound: the products of the rounded parts are exact in float64, so the
// float64 tensor cores could do an f64, two_sum or two_prod product (three
// a pair under two_prod) at their matrix rate, float32 native at the CUDA
// cores' float32 rate and bfloat16 native on the bfloat16 tensor cores;
// this kernel issues them as float64 (or float32) instructions on the CUDA
// cores, a multiply and an add each.
#include <cuda_runtime.h>

namespace {

constexpr int T = 16;    // output tile edge and threads a side
constexpr int TK = 16;   // contraction depth a shared-memory stage
constexpr int MID = 16;  // stages a middle-level sum
constexpr int MAX_BLOCKS = 256;
constexpr int NATIVE = 0, F64 = 1, TWO_SUM = 2, TWO_PROD = 3;
constexpr int CT_F32 = 0, CT_BF16 = 1;

}  // namespace

struct CmBounds {
  int n;                      // contraction blocks
  int b[MAX_BLOCKS + 1];      // their boundaries, b[0] = 0, b[n] = k
};

namespace {

// float32 -> bfloat16, round to nearest even, widened back to float32
__device__ __forceinline__ float bf16_round(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(u | 0x00400000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

template <int CT>
__device__ __forceinline__ float round_ct(double x) {
  const float f = __double2float_rn(x);
  return CT == CT_BF16 ? bf16_round(f) : f;
}

// Knuth's branch-free two_sum: s + e == a + b exactly
__device__ __forceinline__ void two_sum(double a, double b, double& s,
                                        double& e) {
  s = a + b;
  const double bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

template <int MODE, int CT>
__global__ void __launch_bounds__(T * T)
compensated_matmul_kernel(const double* __restrict__ a, long long sab,
                          long long sam, long long sak,
                          const double* __restrict__ b, long long sbb,
                          long long sbk, long long sbn,
                          double* __restrict__ dst, int batch, int m, int n,
                          CmBounds bd) {
  __shared__ float ah[T][TK + 1];
  __shared__ float bh[TK][T + 1];
  __shared__ float al[MODE == TWO_PROD ? T : 1][TK + 1];
  __shared__ float bl[MODE == TWO_PROD ? TK : 1][T + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * T + ty;
  const int j = blockIdx.x * T + tx;
  for (long long bat = blockIdx.z; bat < batch; bat += gridDim.z) {
    const double* ab = a + bat * sab;
    const double* bbp = b + bat * sbb;
    // the two_sum fold over the blocks' partials: hi = p0, then
    // (hi, e) = two_sum(hi, p); lo = e, then lo + e
    double fhi = 0.0, flo = 0.0;
    float accf = 0.0f;
    double acc = 0.0, acc_hl = 0.0, acc_lh = 0.0;
    for (int blk = 0; blk < bd.n; ++blk) {
      const int kb0 = bd.b[blk], kb1 = bd.b[blk + 1];
      // three-level sums: a stage's products, MID stages, the totals
      float midf = 0.0f;
      double mid = 0.0, mid_hl = 0.0, mid_lh = 0.0;
      accf = 0.0f;
      acc = acc_hl = acc_lh = 0.0;
      int stage = 0;
      for (int k0 = kb0; k0 < kb1; k0 += TK) {
        const int ka = k0 + tx, kb = k0 + ty;
        const double xa = (i < m && ka < kb1) ? ab[i * sam + ka * sak] : 0.0;
        const double xb = (j < n && kb < kb1) ? bbp[kb * sbk + j * sbn] : 0.0;
        const float ha = round_ct<CT>(xa), hb = round_ct<CT>(xb);
        ah[ty][tx] = ha;
        bh[ty][tx] = hb;
        if constexpr (MODE == TWO_PROD) {
          al[ty][tx] = round_ct<CT>(xa - (double)ha);
          bl[ty][tx] = round_ct<CT>(xb - (double)hb);
        }
        __syncthreads();
        float pf = 0.0f;
        double p = 0.0, p_hl = 0.0, p_lh = 0.0;
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          if constexpr (MODE == NATIVE) {
            pf = pf + ah[ty][kk] * bh[kk][tx];
          } else if constexpr (MODE == TWO_PROD) {
            const double x = (double)ah[ty][kk], y = (double)bh[kk][tx];
            p = p + x * y;
            p_hl = p_hl + x * (double)bl[kk][tx];
            p_lh = p_lh + (double)al[ty][kk] * y;
          } else {
            p = p + (double)ah[ty][kk] * (double)bh[kk][tx];
          }
        }
        midf = midf + pf;
        mid = mid + p;
        mid_hl = mid_hl + p_hl;
        mid_lh = mid_lh + p_lh;
        if (++stage == MID) {
          accf = accf + midf;
          acc = acc + mid;
          acc_hl = acc_hl + mid_hl;
          acc_lh = acc_lh + mid_lh;
          midf = 0.0f;
          mid = mid_hl = mid_lh = 0.0;
          stage = 0;
        }
        __syncthreads();
      }
      accf = accf + midf;
      acc = acc + mid;
      acc_hl = acc_hl + mid_hl;
      acc_lh = acc_lh + mid_lh;
      if constexpr (MODE == TWO_SUM) {
        if (blk == 0) {
          fhi = acc;
        } else {
          double e;
          two_sum(fhi, acc, fhi, e);
          flo = blk == 1 ? e : flo + e;
        }
      }
    }
    if (i < m && j < n) {
      double r;
      if constexpr (MODE == NATIVE) {
        r = (double)(CT == CT_BF16 ? bf16_round(accf) : accf);
      } else if constexpr (MODE == TWO_PROD) {
        double hi, e, lo;
        two_sum(acc, acc_hl, hi, e);
        lo = e;
        two_sum(hi, acc_lh, hi, e);
        lo = lo + e;
        r = hi + lo;
      } else if constexpr (MODE == TWO_SUM) {
        r = bd.n > 1 ? fhi + flo : fhi;
      } else {
        r = acc;
      }
      dst[bat * (long long)m * n + (long long)i * n + j] = r;
    }
  }
}

template <int MODE, int CT>
void launch_one(dim3 grid, cudaStream_t st, const double* a, long long sab,
                long long sam, long long sak, const double* b, long long sbb,
                long long sbk, long long sbn, double* dst, int batch, int m,
                int n, const CmBounds& bd) {
  compensated_matmul_kernel<MODE, CT><<<grid, dim3(T, T), 0, st>>>(
      a, sab, sam, sak, b, sbb, sbk, sbn, dst, batch, m, n, bd);
}

}  // namespace

// bd holds the contraction blocks: [0, k] outside two_sum, the reference's
// _split_slices(k, split) boundaries under it.
extern "C" int compensated_matmul_launch(
    const double* a, long long sab, long long sam, long long sak,
    const double* b, long long sbb, long long sbk, long long sbn, double* dst,
    int batch, int m, int n, int mode, int ct, CmBounds bd, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (bd.n < 1 || bd.n > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  const long long tiles_m = (m + T - 1) / T;
  if (tiles_m > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n + T - 1) / T, (unsigned)tiles_m,
                  (unsigned)(batch < 65535 ? batch : 65535));
  cudaStream_t st = (cudaStream_t)stream;
#define CM_ARGS grid, st, a, sab, sam, sak, b, sbb, sbk, sbn, dst, batch, m, \
                n, bd
  if (ct == CT_F32) {
    if (mode == NATIVE) launch_one<NATIVE, CT_F32>(CM_ARGS);
    else if (mode == F64) launch_one<F64, CT_F32>(CM_ARGS);
    else if (mode == TWO_SUM) launch_one<TWO_SUM, CT_F32>(CM_ARGS);
    else launch_one<TWO_PROD, CT_F32>(CM_ARGS);
  } else {
    if (mode == NATIVE) launch_one<NATIVE, CT_BF16>(CM_ARGS);
    else if (mode == F64) launch_one<F64, CT_BF16>(CM_ARGS);
    else if (mode == TWO_SUM) launch_one<TWO_SUM, CT_BF16>(CM_ARGS);
    else launch_one<TWO_PROD, CT_BF16>(CM_ARGS);
  }
#undef CM_ARGS
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11's backward: the cotangents (da, db) of a @ b under one (mode, compute
// dtype), as jax.vjp of the reference's _matmul_jnp computes them (its
// jaxpr read operation by operation, float64 a, b and cotangent g):
//   native    gc, bc, ac the operands rounded to the compute dtype;
//             da = ct(gc @ bc^T), db = ct(ac^T @ gc), products and sums in
//             float32 (bfloat16 x bfloat16 is exact in float32), the sum
//             rounded to the compute dtype, then widened;
//   f64       da = ct(g @ f64(bc)^T), db = ct(f64(ac)^T @ g): float64
//             products of the UNROUNDED cotangent (not exact, unlike the
//             forward's) summed in float64, then rounded to the compute
//             dtype by the transpose of astype, then widened;
//   two_sum   the same as f64: the fold's transpose hands each block's
//             partial the cotangent g itself (c + (-c) chains), and the
//             blocks' slices of da and db are disjoint, so each element is
//             one float64 sum over the whole contraction;
//   two_prod  H = ct(g @ f64(bh)^T), L = ct(g @ f64(bl)^T);
//             da = f64(H) + f64(ct((L + H) - H)), the two compute-dtype
//             additions in that order (the split lo = ct(a - f64(ah))
//             transposes into d_a = d_lo + (d_ah + ct(-d_lo))); db the
//             mirror with ah, al: H = ct(f64(ah)^T @ g), L = ct(f64(al)^T
//             @ g).
// A compute-dtype addition is a float32 addition, rounded to bfloat16
// under bfloat16, as XLA's CPU code and torch compute it.
//
// One launch computes both: the first tiles_da blocks the (m, k) tiles of
// da, the rest the (k, n) tiles of db.  A thread owns one element and sums
// its products one at a time in ascending contraction index (0.0 first),
// so the plain version (kernels/compensated_matmul.py) repeats the sum
// bitwise with one elementwise multiply and add per index.  Bound: 2 m k
// n float64 multiply-adds a mode (4 under two_prod), issued as separate
// multiplies and adds on the CUDA cores (-fmad=false); the float64
// tensor cores could do them at their matrix rate.  Simple first: one
// element a thread, 16 x 16 tiles in shared memory.
namespace {

template <int CT>
__device__ __forceinline__ float ct_add(float x, float y) {
  const float s = x + y;
  return CT == CT_BF16 ? bf16_round(s) : s;
}

template <int MODE, int CT>
__device__ __forceinline__ double bwd_epilogue(double acc, double acc_lo,
                                               float accf) {
  if constexpr (MODE == NATIVE) {
    return (double)(CT == CT_BF16 ? bf16_round(accf) : accf);
  } else if constexpr (MODE == TWO_PROD) {
    const float h = round_ct<CT>(acc), l = round_ct<CT>(acc_lo);
    const float s = ct_add<CT>(ct_add<CT>(l, h), -h);
    return (double)h + (double)s;
  } else {
    return (double)round_ct<CT>(acc);
  }
}

template <int MODE, int CT>
__global__ void __launch_bounds__(T * T)
compensated_matmul_bwd_kernel(
    const double* __restrict__ a, long long sab, long long sam,
    long long sak, const double* __restrict__ b, long long sbb,
    long long sbk, long long sbn, const double* __restrict__ g,
    long long sgb, long long sgm, long long sgn, double* __restrict__ da,
    double* __restrict__ db, int batch, int m, int k, int n, int tiles_da,
    int cols_da, int cols_db) {
  __shared__ double gs[T][T + 1];
  __shared__ float hs[T][T + 1];
  __shared__ float ls[MODE == TWO_PROD ? T : 1][T + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const bool is_da = (int)blockIdx.x < tiles_da;
  const int tile = is_da ? blockIdx.x : blockIdx.x - tiles_da;
  const int cols = is_da ? cols_da : cols_db;
  const int tr = tile / cols, tc = tile % cols;
  for (long long bat = blockIdx.z; bat < batch; bat += gridDim.z) {
    const double* ab = a + bat * sab;
    const double* bb = b + bat * sbb;
    const double* gb = g + bat * sgb;
    double acc = 0.0, acc_lo = 0.0;
    float accf = 0.0f;
    if (is_da) {
      // da (m, k): element (i, kk), a sum over j < n of g[i, j] b[kk, j]
      for (int j0 = 0; j0 < n; j0 += T) {
        const int len = n - j0 < T ? n - j0 : T;
        {
          const int r = tr * T + ty, c = j0 + tx;
          const double x = (r < m && c < n) ? gb[r * sgm + c * sgn] : 0.0;
          gs[ty][tx] = MODE == NATIVE ? (double)round_ct<CT>(x) : x;
        }
        {
          const int r = tc * T + ty, c = j0 + tx;
          const double x = (r < k && c < n) ? bb[r * sbk + c * sbn] : 0.0;
          const float h = round_ct<CT>(x);
          hs[ty][tx] = h;
          if constexpr (MODE == TWO_PROD) ls[ty][tx] = round_ct<CT>(x - (double)h);
        }
        __syncthreads();
        for (int jj = 0; jj < len; ++jj) {
          const double gv = gs[ty][jj];
          if constexpr (MODE == NATIVE) {
            accf = accf + (float)gv * hs[tx][jj];
          } else if constexpr (MODE == TWO_PROD) {
            acc = acc + gv * (double)hs[tx][jj];
            acc_lo = acc_lo + gv * (double)ls[tx][jj];
          } else {
            acc = acc + gv * (double)hs[tx][jj];
          }
        }
        __syncthreads();
      }
      const int i = tr * T + ty, kk = tc * T + tx;
      if (i < m && kk < k)
        da[bat * (long long)m * k + (long long)i * k + kk] =
            bwd_epilogue<MODE, CT>(acc, acc_lo, accf);
    } else {
      // db (k, n): element (kk, j), a sum over i < m of a[i, kk] g[i, j]
      for (int i0 = 0; i0 < m; i0 += T) {
        const int len = m - i0 < T ? m - i0 : T;
        {
          const int r = i0 + ty, c = tr * T + tx;
          const double x = (r < m && c < k) ? ab[r * sam + c * sak] : 0.0;
          const float h = round_ct<CT>(x);
          hs[ty][tx] = h;
          if constexpr (MODE == TWO_PROD) ls[ty][tx] = round_ct<CT>(x - (double)h);
        }
        {
          const int r = i0 + ty, c = tc * T + tx;
          const double x = (r < m && c < n) ? gb[r * sgm + c * sgn] : 0.0;
          gs[ty][tx] = MODE == NATIVE ? (double)round_ct<CT>(x) : x;
        }
        __syncthreads();
        for (int ii = 0; ii < len; ++ii) {
          const double gv = gs[ii][tx];
          if constexpr (MODE == NATIVE) {
            accf = accf + hs[ii][ty] * (float)gv;
          } else if constexpr (MODE == TWO_PROD) {
            acc = acc + (double)hs[ii][ty] * gv;
            acc_lo = acc_lo + (double)ls[ii][ty] * gv;
          } else {
            acc = acc + (double)hs[ii][ty] * gv;
          }
        }
        __syncthreads();
      }
      const int kk = tr * T + ty, j = tc * T + tx;
      if (kk < k && j < n)
        db[bat * (long long)k * n + (long long)kk * n + j] =
            bwd_epilogue<MODE, CT>(acc, acc_lo, accf);
    }
  }
}

}  // namespace

// a (batch, m, k), b (batch, k, n), g (batch, m, n) float64 of any
// strides; da (batch, m, k) and db (batch, k, n) float64, contiguous.
extern "C" int compensated_matmul_bwd_launch(
    const double* a, long long sab, long long sam, long long sak,
    const double* b, long long sbb, long long sbk, long long sbn,
    const double* g, long long sgb, long long sgm, long long sgn, double* da,
    double* db, int batch, int m, int k, int n, int mode, int ct,
    void* stream) {
  if (batch <= 0 || k <= 0 || (m <= 0 && n <= 0)) return 0;
  const long long cols_da = (k + T - 1) / T, rows_da = (m + T - 1) / T;
  const long long cols_db = (n + T - 1) / T, rows_db = (k + T - 1) / T;
  const long long tiles_da = rows_da * cols_da;
  const long long tiles = tiles_da + rows_db * cols_db;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, 1,
                  (unsigned)(batch < 65535 ? batch : 65535));
  cudaStream_t st = (cudaStream_t)stream;
#define CMB_ARGS a, sab, sam, sak, b, sbb, sbk, sbn, g, sgb, sgm, sgn, da, db, \
                 batch, m, k, n, (int)tiles_da, (int)cols_da, (int)cols_db
#define CMB_LAUNCH(M, C) \
  compensated_matmul_bwd_kernel<M, C><<<grid, dim3(T, T), 0, st>>>(CMB_ARGS)
  if (ct == CT_F32) {
    if (mode == NATIVE) CMB_LAUNCH(NATIVE, CT_F32);
    else if (mode == F64) CMB_LAUNCH(F64, CT_F32);
    else if (mode == TWO_SUM) CMB_LAUNCH(TWO_SUM, CT_F32);
    else CMB_LAUNCH(TWO_PROD, CT_F32);
  } else {
    if (mode == NATIVE) CMB_LAUNCH(NATIVE, CT_BF16);
    else if (mode == F64) CMB_LAUNCH(F64, CT_BF16);
    else if (mode == TWO_SUM) CMB_LAUNCH(TWO_SUM, CT_BF16);
    else CMB_LAUNCH(TWO_PROD, CT_BF16);
  }
#undef CMB_LAUNCH
#undef CMB_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* compensated_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
