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
//   two_prod  each operand split as x = hi + lo, hi and lo rounded to the
//             compute dtype (lo = x - (double)hi, rounded); the float64 sums
//             hi*hi and hi*lo + lo*hi over the whole contraction, folded by
//             two_sum (the reference folds hi*lo and lo*hi apart: the order
//             of the two small sums moves the result by an ulp of them).
// Rounding a double to bfloat16 goes through float32 (round to nearest
// even twice), as the reference's astype does on both its host (ml_dtypes)
// and device (XLA) paths and as torch's .to(torch.bfloat16) does.
//
// Operands: a (batch, m, k) and b (batch, k, n) float64 with any strides (a
// stride of 0 for an operand shared by the batch, the transposed views of
// X^T X; the wrapper maps a 1-D b to (k, 1) and a 1-D a to (1, k)).  Output
// (batch, m, n) float64, contiguous.
//
// Design.  The products of the rounded parts are exact in float64, so f64,
// two_sum and two_prod (both compute dtypes) run on the float64 tensor
// cores (cm_dmma: mma.sync m16n8k4 .f64 -- m8n8k4 issues at half their
// rate on this card, tools/torch_dmma_probe.py -- whose fused
// multiply-adds give the bits of a separate exact product and add): a
// first pass (cm_round) rounds, and under two_prod splits, every element
// once into zero-padded row-major float64 copies, and the tensor-core
// kernel streams their 16-deep stages through a 4-stage cp.async ring in
// shared memory (3 under two_prod).  native bfloat16 runs on the bfloat16
// tensor cores with float32 accumulation (cm_bf16: mma.sync m16n8k16, its
// products exact in float32) and native float32 on the CUDA cores with
// register tiles of 4 x 4 elements a thread (cm_f32, fused float32
// multiply-adds: TF32 would drop 13 bits of each operand); those two read
// each stage into registers one stage ahead, round it on its way into a
// double-buffered ring and multiply from there.  Rounding count: no
// accumulator runs over the whole contraction.  A stage's chain starts
// from zero (16 products), stages go into a middle sum, and every 16
// stages the middle sum goes into the block total, so that a sum of k
// products carries about 32 + k / 256 roundings: a serve Gram's sums over
// 4096 padded rows at a condition of ~1.7e7 left its uncertainties 1.2e-8
// from the reference's when summed in one run (as cuBLAS's single
// reduction did).  Under two_sum each _split_slices block's total
// is folded into a (hi, lo) pair in block order.  Split-K: where the
// output tiles of all batches cannot fill the card twice
// (compensated_matmul_splits), the contraction is cut into parts -- the
// two_sum blocks themselves, else runs of whole 256-deep middle sums --
// each CTA writes its part's totals to scratch that the wrapper
// allocates, and cm_reduce sums (or under two_sum folds) the parts in
// their order: no atomics, so two launches on the same inputs give the
// same bits.  Built with -fmad=false like K1-K10: no product is fused
// into a sum outside the tensor cores' own multiply-adds, which keeps
// two_sum's error-free transform exact.
//
// What limits it at the serve Gram (tools/torch_k11_probe.py): the
// fragments' shared-memory loads (a warp's 32 x 16 tile reads 0.75 byte a
// multiply-add, about the tensor cores' rate against the SM's 128 bytes a
// clock) and the rounding pass's HBM traffic (each operand read and its
// copy written once).
//
// Bound: f64, two_sum and two_prod (three products a pair) at the float64
// tensor cores' 67 TFLOP/s, native float32 at the CUDA cores' float32 rate
// and native bfloat16 at the bfloat16 tensor cores' (or the bytes, for
// small contractions).
#include <cuda_runtime.h>

namespace {

constexpr int T = 16;    // the backward's output tile edge and threads a side
constexpr int TK = 16;   // contraction depth a stage (a chain from zero)
constexpr int MID = 16;  // stages a middle-level sum
constexpr int CHUNK = TK * MID;  // a split-K part is whole middle sums
constexpr int NT = 256;  // threads a native or split-K-pass CTA (8 warps)
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

// ---- hardware primitives: the tensor cores' products ----------------------
// d (16x8 float64: d0, d1 row g, columns 2t + {0,1}; d2, d3 row g + 8) +=
// a (16x4: a0 row g, column t; a1 row g + 8) b (4x8: b0 row t, column g);
// g = lane / 4, t = lane % 4.  An sm_90 shape: m8n8k4 issues at half the
// float64 tensor cores' rate on this card (tools/torch_dmma_probe.py).
__device__ __forceinline__ void mma_1684(double (&d)[4], double a0, double a1,
                                         double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// d (16x8 float32: d0, d1 row g, columns 2t + {0,1}; d2, d3 row g + 8)
// += a (16x16 bfloat16, row-major: a0 rows g, columns 2t + {0,1}; a1 row
// g + 8; a2 row g, columns 2t + 8 + {0,1}; a3 row g + 8, those columns)
// b (16x8, column-major: b0 rows 2t + {0,1} of column g; b1 rows 2t + 8 +
// {0,1}); g = lane / 4, t = lane % 4, two bfloat16 a 32-bit register
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// ---- end of hardware primitives -------------------------------------------

// The stages a CTA walks: the contraction blocks [first, last) of its part
// (two_sum: every block, or block `part` of a split launch; otherwise one
// block, the part's whole middle sums), each in 16-deep stages from its
// start, the last one masked at its end.
struct Walk {
  int blk, last, k0, lo, hi;
};

// ALIGN: stages start on multiples of TK (the pre-rounded operands' rows
// are padded to them; a stage's entries outside [lo, hi) are masked),
// else at the block's start
template <int MODE, bool ALIGN = false>
__device__ __forceinline__ Walk walk_first(const CmBounds& bd, int k,
                                           int splits, int part) {
  Walk w;
  if (MODE == TWO_SUM) {
    w.blk = splits == 1 ? 0 : part;
    w.last = splits == 1 ? bd.n : part + 1;
    w.lo = bd.b[w.blk];
    w.hi = bd.b[w.blk + 1];
  } else {
    const int nch = (k + CHUNK - 1) / CHUNK;
    w.blk = 0;
    w.last = 1;
    w.lo = (int)((long long)part * nch / splits) * CHUNK;
    const long long e = (long long)(part + 1) * nch / splits * CHUNK;
    w.hi = e < k ? (int)e : k;
  }
  w.k0 = ALIGN ? w.lo - w.lo % TK : w.lo;
  return w;
}

template <int MODE, bool ALIGN = false>
__device__ __forceinline__ bool walk_next(Walk& w, const CmBounds& bd) {
  w.k0 += TK;
  if (w.k0 < w.hi) return true;
  if (MODE != TWO_SUM || ++w.blk >= w.last) return false;
  w.lo = bd.b[w.blk];
  w.hi = bd.b[w.blk + 1];
  w.k0 = ALIGN ? w.lo - w.lo % TK : w.lo;
  return true;
}

// Operand staging of the native kernels: a (BM x TK) and b (TK x BN)
// tiles of the stage at k0 (masked at the block end hi and the edges),
// LA and LB raw doubles a thread, each operand walked along its faster
// index in memory so that a warp's loads fall on neighbouring addresses.
template <int BM, int BN>
struct Stage {
  static constexpr int LA = BM * TK / NT, LB = TK * BN / NT;
  double ra[LA], rb[LB];

  __device__ __forceinline__ void load(const double* ab, long long sam,
                                       long long sak, const double* bb,
                                       long long sbk, long long sbn, int m,
                                       int n, int i0, int j0, int k0, int hi,
                                       bool a_kfast, bool b_nfast) {
    const int t = threadIdx.x;
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int e = t + NT * q;
      const int r = a_kfast ? e / TK : e % BM, kk = a_kfast ? e % TK : e / BM;
      const int i = i0 + r, kg = k0 + kk;
      ra[q] = (i < m && kg < hi) ? ab[i * sam + kg * sak] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < LB; ++q) {
      const int e = t + NT * q;
      const int c = b_nfast ? e % BN : e / TK, kk = b_nfast ? e / BN : e % TK;
      const int j = j0 + c, kg = k0 + kk;
      rb[q] = (j < n && kg < hi) ? bb[kg * sbk + j * sbn] : 0.0;
    }
  }

  // element q's position in its tile
  __device__ __forceinline__ static void a_at(int q, bool a_kfast, int& r,
                                              int& kk) {
    const int e = threadIdx.x + NT * q;
    r = a_kfast ? e / TK : e % BM;
    kk = a_kfast ? e % TK : e / BM;
  }
  __device__ __forceinline__ static void b_at(int q, bool b_nfast, int& kk,
                                              int& c) {
    const int e = threadIdx.x + NT * q;
    c = b_nfast ? e % BN : e / TK;
    kk = b_nfast ? e / BN : e % TK;
  }
};

// ---- f64, two_sum, two_prod on the float64 tensor cores ------------------
// Two kernels.  cm_round rounds (and under two_prod splits) each operand
// once, into a zero-padded row-major float64 copy -- A (batches, mp, kp),
// B (batches, kp, np), m padded to 64, k to 16, n to 64, a batch stride of
// 0 kept as one copy -- through a 32 x 32 tile in shared memory, so that
// its reads run along the source's faster index and its writes along the
// copy's rows.  cm_dmma then streams the copies' 16-deep stages through an
// NS-stage cp.async ring in shared memory, A [BM][TK + 4] and B [TK][BN +
// 4] (the padding puts a half-warp's fragment loads on distinct banks),
// twice under two_prod (hi, lo), entries outside a two_sum block masked to
// zero; no thread converts or waits on its own loads.  WM x WN warps, each
// MI x NI mma tiles of 16 x 8; each thread keeps a stage's chains and the
// middle sums of its EPT elements in registers and the block totals (and
// two_sum's fold) in shared memory, touched once every 16 stages, so that
// two CTAs fit an SM: [PARTS][EPT][NTH], under two_sum the fold's hi and
// lo [EPT][NTH] after them.
constexpr int PAD_M = 64, PAD_N = 64;  // the copies' row and column padding
constexpr int F64_WM = 2, F64_WN = 4, F64_MI = 2, F64_NI = 2;
constexpr int CMP_WM = 2, CMP_WN = 4, CMP_MI = 1, CMP_NI = 2;
template <int MODE>
struct Dmma {
  static constexpr bool F = MODE == F64;
  static constexpr int WM = F ? F64_WM : CMP_WM, WN = F ? F64_WN : CMP_WN;
  static constexpr int MI = F ? F64_MI : CMP_MI, NI = F ? F64_NI : CMP_NI;
  static constexpr int NTH = 32 * WM * WN;
  static constexpr int BM = WM * 16 * MI, BN = WN * 8 * NI;
  static_assert(PAD_M % BM == 0 && PAD_N % BN == 0, "the copies' padding");
  static constexpr int SA = TK + 4, SB = BN + 4;
  static constexpr int PARTS = MODE == TWO_PROD ? 2 : 1;  // hi, lo
  static constexpr int NS = MODE == TWO_PROD ? 3 : 4;     // ring stages
  static constexpr int STAGE = PARTS * (BM * SA + TK * SB);
  static constexpr int EPT = MI * NI * 4;  // a thread's output elements
  static constexpr int SMEM =
      8 * (NS * STAGE + (PARTS + (MODE == TWO_SUM ? 2 : 0)) * EPT * NTH);
};
constexpr int MIN_CTAS = 2;  // CTAs an SM holds (the register budget)
constexpr int SPLIT_MIN_K = 4 * CHUNK;  // the shortest contraction split

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's rounding: hi (nb, rp, cp) row-major, hi[b][r][c] = the
// compute dtype's rounding of src[b][r][c] for r < rows, c < cols, else 0;
// under SPLIT also lo = the rounding of src - hi.
struct RoundJob {
  const double* src;
  long long sb, sr, sc;
  int rows, cols, nb, rp, cp;
  double *hi, *lo;
};

// Both operands in one launch: each CTA a 32 x 32 tile of one batch of
// one job, A's tiles first, in a grid-stride loop over all of them.
template <int CT, bool SPLIT>
__global__ void __launch_bounds__(256)
cm_round(RoundJob ja, RoundJob jb) {
  __shared__ double tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ax = (ja.cp + 31) / 32, bx = (jb.cp + 31) / 32;
  const long long ta = (long long)ax * ((ja.rp + 31) / 32);
  const long long tb = (long long)bx * ((jb.rp + 31) / 32);
  const long long na = ta * ja.nb, total = na + tb * jb.nb;
  for (long long q = blockIdx.x; q < total; q += gridDim.x) {
    const bool first = q < na;
    const long long u = first ? q : q - na, per = first ? ta : tb;
    const long long bt = u / per;
    const int t = (int)(u % per), nx = first ? ax : bx;
    const int r0 = t / nx * 32, c0 = t % nx * 32;
    const int rows = first ? ja.rows : jb.rows, cols = first ? ja.cols
                                                             : jb.cols;
    const int rp = first ? ja.rp : jb.rp, cp = first ? ja.cp : jb.cp;
    const long long sr = first ? ja.sr : jb.sr, sc = first ? ja.sc : jb.sc;
    const double* s = (first ? ja.src : jb.src) + bt * (first ? ja.sb
                                                              : jb.sb);
    double* hi = first ? ja.hi : jb.hi;
    double* lo = first ? ja.lo : jb.lo;
    const bool cfast = (sc < 0 ? -sc : sc) <= (sr < 0 ? -sr : sr);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = cfast ? ty + 8 * i : tx, cc = cfast ? tx : ty + 8 * i;
      const int r = r0 + rr, c = c0 + cc;
      tile[rr][cc] = (r < rows && c < cols) ? s[r * sr + c * sc] : 0.0;
    }
    __syncthreads();
    const long long base = bt * (long long)rp * cp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 8 * i;
      if (r0 + rr >= rp || c0 + tx >= cp) continue;
      const double x = tile[rr][tx];
      const float h = round_ct<CT>(x);
      const long long o = base + (long long)(r0 + rr) * cp + c0 + tx;
      hi[o] = (double)h;
      if constexpr (SPLIT) lo[o] = (double)round_ct<CT>(x - (double)h);
    }
  }
}

template <int MODE, int CT>
__global__ void __launch_bounds__(Dmma<MODE>::NTH, MIN_CTAS)
cm_dmma(const double* __restrict__ ahi, const double* __restrict__ alo,
        long long sab, int lda, const double* __restrict__ bhi,
        const double* __restrict__ blo, long long sbb, int ldb,
        double* __restrict__ dst, double* __restrict__ part, int batch,
        int m, int n, int k, int splits, CmBounds bd) {
  using D = Dmma<MODE>;
  constexpr int MI = D::MI, NI = D::NI, BM = D::BM, BN = D::BN;
  constexpr int SA = D::SA, SB = D::SB, EPT = D::EPT, NTH = D::NTH;
  constexpr int NS = D::NS, HALF = BM * SA + TK * SB;  // hi's, then lo's
  extern __shared__ __align__(16) double sh[];
  double* tot = sh + NS * D::STAGE;           // [PARTS][EPT][NTH]
  double* fhi = tot + D::PARTS * EPT * NTH;   // two_sum: [EPT][NTH]
  double* flo = fhi + EPT * NTH;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int wm = (warp / D::WN) * 16 * MI, wn = (warp % D::WN) * 8 * NI;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const long long mn = (long long)m * n;
  // a thread's element e = (i, j, q): row wm + 16 i + g + 8 (q / 2),
  // column wn + 8 j + 2 q4 + q % 2
  auto elem = [&](int e, int& r, int& c) {
    const int i = e / (NI * 4), j = (e / 4) % NI, q = e % 4;
    r = wm + 16 * i + g + 8 * (q >> 1);
    c = wn + 8 * j + 2 * q4 + (q & 1);
  };
  for (long long z = blockIdx.z; z < (long long)batch * splits;
       z += gridDim.z) {
    const long long bat = z / splits;
    const int sp = (int)(z % splits);
    cp_async_wait<0>();
    __syncthreads();  // the previous batch's ring is drained and read
    const double* ah = ahi + bat * sab + (long long)i0 * lda;
    const double* bh = bhi + bat * sbb + j0;
    const double* al = MODE == TWO_PROD ? alo + bat * sab + (long long)i0 * lda
                                        : nullptr;
    const double* bl = MODE == TWO_PROD ? blo + bat * sbb + j0 : nullptr;
    // the stage at w.k0 into ring slot `slot`, entries outside [lo, hi)
    // zero
    auto issue = [&](int slot, const Walk& w) {
      double* A = sh + slot * D::STAGE;
      double* B = A + BM * SA;
#pragma unroll
      for (int q = 0; q < BM * TK / NTH; ++q) {
        const int e = t + NTH * q, r = e / TK, kk = e % TK, kg = w.k0 + kk;
        const bool on = kg >= w.lo && kg < w.hi;
        const long long o = (long long)r * lda + kg;
        cp_async8(A + r * SA + kk, ah + (on ? o : 0), on);
        if constexpr (MODE == TWO_PROD)
          cp_async8(A + HALF + r * SA + kk, al + (on ? o : 0), on);
      }
#pragma unroll
      for (int q = 0; q < TK * BN / NTH; ++q) {
        const int e = t + NTH * q, kk = e / BN, c = e % BN, kg = w.k0 + kk;
        const bool on = kg >= w.lo && kg < w.hi;
        const long long o = (long long)kg * ldb + c;
        cp_async8(B + kk * SB + c, bh + (on ? o : 0), on);
        if constexpr (MODE == TWO_PROD)
          cp_async8(B + HALF + kk * SB + c, bl + (on ? o : 0), on);
      }
    };
    // the middle sums in registers ([0] hi*hi or the only sum, [1] hi*lo
    // + lo*hi under two_prod), the totals in shared memory
    double mid[D::PARTS][EPT];
#pragma unroll
    for (int p = 0; p < D::PARTS; ++p)
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        mid[p][e] = 0.0;
        tot[(p * EPT + e) * NTH + t] = 0.0;
      }
    Walk wi = walk_first<MODE, true>(bd, k, splits, sp);
    bool iv = wi.k0 < wi.hi;
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      if (iv) {
        issue(s, wi);
        iv = walk_next<MODE, true>(wi, bd);
      }
      cp_async_commit();
    }
    Walk w = walk_first<MODE, true>(bd, k, splits, sp);
    bool have = w.k0 < w.hi;
    int slot = 0, stage = 0, nblk = 0;
    while (have) {
      cp_async_wait<NS - 2>();
      __syncthreads();
      if (iv) {
        issue((slot + NS - 1) % NS, wi);
        iv = walk_next<MODE, true>(wi, bd);
      }
      cp_async_commit();
      // the stage's chains, from zero
      {
        const double* A = sh + slot * D::STAGE;
        const double* B = A + BM * SA;
        double c[D::PARTS][MI][NI][4];
#pragma unroll
        for (int p = 0; p < D::PARTS; ++p)
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) c[p][i][j][q] = 0.0;
#pragma unroll
        for (int s4 = 0; s4 < TK; s4 += 4) {
          double a0[MI], a1[MI], bf[NI];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            a0[i] = A[(wm + 16 * i + g) * SA + s4 + q4];
            a1[i] = A[(wm + 16 * i + g + 8) * SA + s4 + q4];
          }
#pragma unroll
          for (int j = 0; j < NI; ++j)
            bf[j] = B[(s4 + q4) * SB + wn + 8 * j + g];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
              mma_1684(c[0][i][j], a0[i], a1[i], bf[j]);
          if constexpr (MODE == TWO_PROD) {
            double l0[MI], l1[MI], bl2[NI];
#pragma unroll
            for (int i = 0; i < MI; ++i) {
              l0[i] = A[HALF + (wm + 16 * i + g) * SA + s4 + q4];
              l1[i] = A[HALF + (wm + 16 * i + g + 8) * SA + s4 + q4];
            }
#pragma unroll
            for (int j = 0; j < NI; ++j)
              bl2[j] = B[HALF + (s4 + q4) * SB + wn + 8 * j + g];
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
              for (int j = 0; j < NI; ++j) {
                mma_1684(c[D::PARTS - 1][i][j], a0[i], a1[i], bl2[j]);
                mma_1684(c[D::PARTS - 1][i][j], l0[i], l1[i], bf[j]);
              }
          }
        }
#pragma unroll
        for (int p = 0; p < D::PARTS; ++p)
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int e = (i * NI + j) * 4 + q;
                mid[p][e] = mid[p][e] + c[p][i][j][q];
              }
      }
      Walk nx = w;
      const bool more = walk_next<MODE, true>(nx, bd);
      const bool blk_end = !more || nx.blk != w.blk;
      if (++stage == MID || blk_end) {
#pragma unroll
        for (int p = 0; p < D::PARTS; ++p)
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            double& x = tot[(p * EPT + e) * NTH + t];
            x = x + mid[p][e];
            mid[p][e] = 0.0;
          }
        stage = 0;
      }
      if (MODE == TWO_SUM && blk_end) {
        // fold the block's total: hi = p0, then (hi, e) = two_sum(hi, p);
        // lo = e, then lo + e
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const int o = e * NTH + t;
          if (nblk == 0) {
            fhi[o] = tot[o];
          } else {
            double hv, er;
            two_sum(fhi[o], tot[o], hv, er);
            fhi[o] = hv;
            flo[o] = nblk == 1 ? er : flo[o] + er;
          }
          tot[o] = 0.0;
        }
        ++nblk;
      }
      slot = (slot + 1) % NS;
      w = nx;
      have = more;
    }
    // the epilogue: each of a thread's elements
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      int r, c;
      elem(e, r, c);
      r += i0;
      c += j0;
      if (r >= m || c >= n) continue;
      const long long o = bat * mn + (long long)r * n + c;
      const double t0 = tot[e * NTH + t];
      if (splits > 1) {
        part[(long long)sp * D::PARTS * batch * mn + o] =
            MODE == TWO_SUM ? fhi[e * NTH + t] : t0;
        if constexpr (MODE == TWO_PROD)
          part[((long long)sp * 2 + 1) * batch * mn + o] =
              tot[(EPT + e) * NTH + t];
        continue;
      }
      double rv;
      if constexpr (MODE == TWO_PROD) {
        double hv, er;
        two_sum(t0, tot[(EPT + e) * NTH + t], hv, er);
        rv = hv + er;
      } else if constexpr (MODE == TWO_SUM) {
        rv = nblk > 1 ? fhi[e * NTH + t] + flo[e * NTH + t] : fhi[e * NTH + t];
      } else {
        rv = t0;
      }
      dst[o] = rv;
    }
  }
}

// ---- native bfloat16 on the bfloat16 tensor cores ------------------------
// 8 warps as 2 x 4, a warp 2 x 2 mma tiles of 16 x 8 (a 64 x 64 CTA tile);
// a stage is one k16 product a tile from a zero accumulator, then the
// three levels in float32 on the CUDA cores.  Shared memory holds the
// bfloat16 bits, A [BM][TK + 2] row-major and B [BN][TK + 2] column-major
// (a fragment's pair is one 32-bit word; a row of 9 words puts a warp's
// staging stores along m or n on distinct banks).
constexpr int HB_M = 64, HB_N = 64, HB_S = TK + 2;

__device__ __forceinline__ unsigned short bf16_bits(float f) {
  return (unsigned short)(__float_as_uint(bf16_round(f)) >> 16);
}

__global__ void __launch_bounds__(NT, MIN_CTAS)
cm_bf16(const double* __restrict__ a, long long sab, long long sam,
        long long sak, const double* __restrict__ b, long long sbb,
        long long sbk, long long sbn, double* __restrict__ dst,
        double* __restrict__ part, int batch, int m, int n, int k,
        int splits, CmBounds bd) {
  __shared__ __align__(16) unsigned short sh[2][(HB_M + HB_N) * HB_S];
  using St = Stage<HB_M, HB_N>;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int i0 = blockIdx.y * HB_M, j0 = blockIdx.x * HB_N;
  const bool a_kfast = (sak < 0 ? -sak : sak) <= (sam < 0 ? -sam : sam);
  const bool b_nfast = (sbn < 0 ? -sbn : sbn) <= (sbk < 0 ? -sbk : sbk);
  const long long mn = (long long)m * n;
  for (long long z = blockIdx.z; z < (long long)batch * splits;
       z += gridDim.z) {
    const long long bat = z / splits;
    const int sp = (int)(z % splits);
    __syncthreads();  // the previous batch's last stage is read
    const double* ab = a + bat * sab;
    const double* bb = b + bat * sbb;
    St st;
    auto put = [&](int buf) {
      unsigned short* A = sh[buf];
      unsigned short* B = A + HB_M * HB_S;
#pragma unroll
      for (int q = 0; q < St::LA; ++q) {
        int r, kk;
        St::a_at(q, a_kfast, r, kk);
        A[r * HB_S + kk] = bf16_bits(__double2float_rn(st.ra[q]));
      }
#pragma unroll
      for (int q = 0; q < St::LB; ++q) {
        int kk, c;
        St::b_at(q, b_nfast, kk, c);
        B[c * HB_S + kk] = bf16_bits(__double2float_rn(st.rb[q]));
      }
    };
    float mid[2][2][4], tot[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mid[i][j][e] = tot[i][j][e] = 0.0f;
    Walk w = walk_first<NATIVE>(bd, k, splits, sp);
    bool have = w.k0 < w.hi;
    int buf = 0, stage = 0;
    if (have) {
      st.load(ab, sam, sak, bb, sbk, sbn, m, n, i0, j0, w.k0, w.hi, a_kfast,
              b_nfast);
      put(0);
    }
    __syncthreads();
    while (have) {
      Walk nx = w;
      const bool more = walk_next<NATIVE>(nx, bd);
      if (more)
        st.load(ab, sam, sak, bb, sbk, sbn, m, n, i0, j0, nx.k0, nx.hi,
                a_kfast, b_nfast);
      {
        const unsigned short* A = sh[buf];
        const unsigned short* B = A + HB_M * HB_S;
        unsigned af[2][4], bf[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const unsigned short* r0 = A + (wm + 16 * i + g) * HB_S + 2 * q4;
          const unsigned short* r8 = r0 + 8 * HB_S;
          af[i][0] = *reinterpret_cast<const unsigned*>(r0);
          af[i][1] = *reinterpret_cast<const unsigned*>(r8);
          af[i][2] = *reinterpret_cast<const unsigned*>(r0 + 8);
          af[i][3] = *reinterpret_cast<const unsigned*>(r8 + 8);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned short* c0 = B + (wn + 8 * j + g) * HB_S + 2 * q4;
          bf[j][0] = *reinterpret_cast<const unsigned*>(c0);
          bf[j][1] = *reinterpret_cast<const unsigned*>(c0 + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(c, af[i], bf[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) mid[i][j][e] = mid[i][j][e] + c[e];
          }
      }
      if (++stage == MID || !more) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[i][j][e] = tot[i][j][e] + mid[i][j][e];
              mid[i][j][e] = 0.0f;
            }
        stage = 0;
      }
      if (more) {
        put(buf ^ 1);
        __syncthreads();
        buf ^= 1;
      }
      w = nx;
      have = more;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = i0 + wm + 16 * i + g + (e >= 2 ? 8 : 0);
          const int c = j0 + wn + 8 * j + 2 * q4 + (e & 1);
          if (r >= m || c >= n) continue;
          const long long o = bat * mn + (long long)r * n + c;
          if (splits > 1)
            part[(long long)sp * batch * mn + o] = (double)tot[i][j][e];
          else
            dst[o] = (double)bf16_round(tot[i][j][e]);
        }
  }
}

// ---- native float32 on the CUDA cores --------------------------------------
// 16 x 16 threads, each a 4 x 4 register tile (rows 4 ty + i, columns 4 tx
// + j) of a 64 x 64 CTA tile read as one 16-byte load of A and of B a
// step; shared memory A [TK][64 + 4] and B [TK][64 + 4] in float32,
// double-buffered; fused float32 multiply-adds.
constexpr int F_M = 64, F_N = 64, F_S = 64 + 4;

__global__ void __launch_bounds__(NT, MIN_CTAS)
cm_f32(const double* __restrict__ a, long long sab, long long sam,
       long long sak, const double* __restrict__ b, long long sbb,
       long long sbk, long long sbn, double* __restrict__ dst,
       double* __restrict__ part, int batch, int m, int n, int k, int splits,
       CmBounds bd) {
  __shared__ __align__(16) float sh[2][2 * TK * F_S];
  using St = Stage<F_M, F_N>;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int i0 = blockIdx.y * F_M, j0 = blockIdx.x * F_N;
  const bool a_kfast = (sak < 0 ? -sak : sak) <= (sam < 0 ? -sam : sam);
  const bool b_nfast = (sbn < 0 ? -sbn : sbn) <= (sbk < 0 ? -sbk : sbk);
  const long long mn = (long long)m * n;
  for (long long z = blockIdx.z; z < (long long)batch * splits;
       z += gridDim.z) {
    const long long bat = z / splits;
    const int sp = (int)(z % splits);
    __syncthreads();  // the previous batch's last stage is read
    const double* ab = a + bat * sab;
    const double* bb = b + bat * sbb;
    St st;
    auto put = [&](int buf) {
      float* A = sh[buf];
      float* B = A + TK * F_S;
#pragma unroll
      for (int q = 0; q < St::LA; ++q) {
        int r, kk;
        St::a_at(q, a_kfast, r, kk);
        A[kk * F_S + r] = __double2float_rn(st.ra[q]);
      }
#pragma unroll
      for (int q = 0; q < St::LB; ++q) {
        int kk, c;
        St::b_at(q, b_nfast, kk, c);
        B[kk * F_S + c] = __double2float_rn(st.rb[q]);
      }
    };
    float mid[4][4], tot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mid[i][j] = tot[i][j] = 0.0f;
    Walk w = walk_first<NATIVE>(bd, k, splits, sp);
    bool have = w.k0 < w.hi;
    int buf = 0, stage = 0;
    if (have) {
      st.load(ab, sam, sak, bb, sbk, sbn, m, n, i0, j0, w.k0, w.hi, a_kfast,
              b_nfast);
      put(0);
    }
    __syncthreads();
    while (have) {
      Walk nx = w;
      const bool more = walk_next<NATIVE>(nx, bd);
      if (more)
        st.load(ab, sam, sak, bb, sbk, sbn, m, n, i0, j0, nx.k0, nx.hi,
                a_kfast, b_nfast);
      {
        const float* A = sh[buf];
        const float* B = A + TK * F_S;
        float c[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(A + kk * F_S + 4 * ty);
          const float4 y4 =
              *reinterpret_cast<const float4*>(B + kk * F_S + 4 * tx);
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
          const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) c[i][j] = __fmaf_rn(x[i], y[j], c[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mid[i][j] = mid[i][j] + c[i][j];
      }
      if (++stage == MID || !more) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tot[i][j] = tot[i][j] + mid[i][j];
            mid[i][j] = 0.0f;
          }
        stage = 0;
      }
      if (more) {
        put(buf ^ 1);
        __syncthreads();
        buf ^= 1;
      }
      w = nx;
      have = more;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = i0 + 4 * ty + i, c = j0 + 4 * tx + j;
        if (r >= m || c >= n) continue;
        const long long o = bat * mn + (long long)r * n + c;
        if (splits > 1)
          part[(long long)sp * batch * mn + o] = (double)tot[i][j];
        else
          dst[o] = (double)tot[i][j];
      }
  }
}

// ---- split-K's second pass: the parts in their order -----------------------
template <int MODE, int CT>
__global__ void __launch_bounds__(NT)
cm_reduce(const double* __restrict__ part, double* __restrict__ dst,
          long long total, int splits) {
  const long long o = (long long)blockIdx.x * NT + threadIdx.x;
  if (o >= total) return;
  double rv;
  if constexpr (MODE == NATIVE) {
    float s = (float)part[o];
    for (int p = 1; p < splits; ++p) s = s + (float)part[p * total + o];
    rv = (double)(CT == CT_BF16 ? bf16_round(s) : s);
  } else if constexpr (MODE == TWO_PROD) {
    double h = part[o], c = part[total + o];
    for (int p = 1; p < splits; ++p) {
      h = h + part[2 * p * total + o];
      c = c + part[(2 * p + 1) * total + o];
    }
    double hi, er;
    two_sum(h, c, hi, er);
    rv = hi + er;
  } else if constexpr (MODE == TWO_SUM) {
    // the reference's fold of the blocks' partials, in block order
    double hi = part[o], lo = 0.0;
    for (int p = 1; p < splits; ++p) {
      double er;
      two_sum(hi, part[p * total + o], hi, er);
      lo = p == 1 ? er : lo + er;
    }
    rv = splits > 1 ? hi + lo : hi;
  } else {
    double s = part[o];
    for (int p = 1; p < splits; ++p) s = s + part[p * total + o];
    rv = s;
  }
  dst[o] = rv;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  return sms;
}

void tile_of(int mode, int ct, int& bm, int& bn) {
  if (mode == NATIVE) {
    bm = ct == CT_F32 ? F_M : HB_M;
    bn = ct == CT_F32 ? F_N : HB_N;
  } else if (mode == F64) {
    bm = Dmma<F64>::BM;
    bn = Dmma<F64>::BN;
  } else {
    bm = Dmma<TWO_SUM>::BM;
    bn = Dmma<TWO_SUM>::BN;
  }
}

// the float64 tensor-core modes' rounded copies: (batches, rows padded to
// PAD_M, k padded to TK) and (batches, k padded to TK, columns padded to
// PAD_N), a batch stride of 0 (or one batch) as one copy
struct Copies {
  double *ahi, *alo, *bhi, *blo;
};

template <int MODE, int CT>
void launch_one(dim3 grid, cudaStream_t st, const double* a, long long sab,
                long long sam, long long sak, const double* b, long long sbb,
                long long sbk, long long sbn, double* dst, double* part,
                const Copies& cp, int batch, int m, int n, int k, int splits,
                const CmBounds& bd) {
  if constexpr (MODE == NATIVE && CT == CT_F32) {
    cm_f32<<<grid, NT, 0, st>>>(a, sab, sam, sak, b, sbb, sbk, sbn, dst,
                                part, batch, m, n, k, splits, bd);
  } else if constexpr (MODE == NATIVE) {
    cm_bf16<<<grid, NT, 0, st>>>(a, sab, sam, sak, b, sbb, sbk, sbn, dst,
                                 part, batch, m, n, k, splits, bd);
  } else {
    constexpr bool SPLIT = MODE == TWO_PROD;
    const int mp = (m + PAD_M - 1) / PAD_M * PAD_M;
    const int kp = (k + TK - 1) / TK * TK;
    const int np = (n + PAD_N - 1) / PAD_N * PAD_N;
    const int ba = (batch == 1 || sab == 0) ? 1 : batch;
    const int bb = (batch == 1 || sbb == 0) ? 1 : batch;
    if (k > 0) {
      const RoundJob ja{a, sab, sam, sak, m, k, ba, mp, kp, cp.ahi, cp.alo};
      const RoundJob jb{b, sbb, sbk, sbn, k, n, bb, kp, np, cp.bhi, cp.blo};
      const long long tiles =
          (long long)ba * ((mp + 31) / 32) * ((kp + 31) / 32) +
          (long long)bb * ((kp + 31) / 32) * ((np + 31) / 32);
      const unsigned g = (unsigned)(tiles < (1LL << 30) ? tiles : 1LL << 30);
      cm_round<CT, SPLIT><<<g, dim3(32, 8), 0, st>>>(ja, jb);
    }
    cm_dmma<MODE, CT><<<grid, Dmma<MODE>::NTH, Dmma<MODE>::SMEM, st>>>(
        cp.ahi, cp.alo, ba == 1 ? 0 : (long long)mp * kp, kp, cp.bhi, cp.blo,
        bb == 1 ? 0 : (long long)kp * np, np, dst, part, batch, m, n, k,
        splits, bd);
  }
  if (splits > 1 && cudaPeekAtLastError() == cudaSuccess) {
    const long long total = (long long)batch * m * n;
    cm_reduce<MODE, CT><<<(unsigned)((total + NT - 1) / NT), NT, 0, st>>>(
        part, dst, total, splits);
  }
}

template <int MODE, int CT>
cudaError_t raise_smem() {
  return cudaFuncSetAttribute(cm_dmma<MODE, CT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Dmma<MODE>::SMEM);
}

}  // namespace

// Once a process, before the first launch (and outside any CUDA-graph
// capture): the float64 tensor-core kernels' dynamic shared memory above
// 48 KB.
extern "C" int compensated_matmul_init() {
  cudaError_t e = cudaSuccess;
  const cudaError_t r[] = {
      raise_smem<F64, CT_F32>(),      raise_smem<F64, CT_BF16>(),
      raise_smem<TWO_SUM, CT_F32>(),  raise_smem<TWO_SUM, CT_BF16>(),
      raise_smem<TWO_PROD, CT_F32>(), raise_smem<TWO_PROD, CT_BF16>()};
  for (cudaError_t x : r)
    if (x != cudaSuccess) e = x;
  return (int)e;
}

// The parts a launch cuts the contraction into (1: no split-K pass): where
// the output tiles of all batches number fewer than twice the SMs, the
// two_sum blocks (nblocks), or for a contraction of SPLIT_MIN_K or more
// (a shorter one costs less than the second pass's launch) as many runs
// of whole 256-deep middle sums as bring the CTAs to twice the SMs.  The
// wrapper sizes the scratch from it: parts x (2 under two_prod) x batch x
// m x n doubles.
extern "C" int compensated_matmul_splits(int batch, int m, int n, int k,
                                         int mode, int ct, int nblocks) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0) return 1;
  int bm, bn;
  tile_of(mode, ct, bm, bn);
  const long long tiles =
      (long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn) * batch;
  const long long want = 2LL * sm_count();
  if (tiles >= want) return 1;
  if (mode == TWO_SUM) return nblocks;
  if (k < SPLIT_MIN_K) return 1;
  const long long nch = (k + CHUNK - 1) / CHUNK;
  long long s = (want + tiles - 1) / tiles;
  if (s > nch) s = nch;
  return s < 1 ? 1 : (int)s;
}

// bd holds the contraction blocks: [0, k] outside two_sum, the reference's
// _split_slices(k, split) boundaries under it.  splits from
// compensated_matmul_splits; part: its scratch (unused when splits is 1);
// ahi, bhi (and under two_prod alo, blo): the float64 tensor-core modes'
// rounded copies, of the sizes Copies describes (unused under native).
extern "C" int compensated_matmul_launch(
    const double* a, long long sab, long long sam, long long sak,
    const double* b, long long sbb, long long sbk, long long sbn, double* dst,
    double* part, double* ahi, double* alo, double* bhi, double* blo,
    int batch, int m, int n, int k, int mode, int ct, int splits,
    CmBounds bd, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (bd.n < 1 || bd.n > MAX_BLOCKS || splits < 1 ||
      (mode == TWO_SUM && splits > 1 && splits != bd.n))
    return (int)cudaErrorInvalidValue;
  int bm, bn;
  tile_of(mode, ct, bm, bn);
  const long long tiles_m = (m + bm - 1) / bm;
  const long long zs = (long long)batch * splits;
  if (tiles_m > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((n + bn - 1) / bn, (unsigned)tiles_m,
                  (unsigned)(zs < 65535 ? zs : 65535));
  cudaStream_t st = (cudaStream_t)stream;
  const Copies cp{ahi, alo, bhi, blo};
#define CM_ARGS grid, st, a, sab, sam, sak, b, sbb, sbk, sbn, dst, part, cp, \
                batch, m, n, k, splits, bd
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
