// K5 wls_lstsq: per-point minimum-norm least squares of the normalized
// whitened design matrix, with its singular values.
//
// Replaces jnp.linalg.lstsq in the reference WLS grid's Gauss-Newton step
// (pint_tpu/grid.py:309-321, chi2_point.gn_step): for each point p,
//   norms = ||Aw[:, j]|| (0 -> 1),  An = Aw / norms,
//   x = V diag(mask / s) U^T rw,  mask = s > 0 and s >= eps max(N, k) s_max,
// where An = U diag(s) V^T, and s in descending order.  Torch's CUDA SVD
// batches only matrices up to 32 x 32 and takes the others one library
// call at a time; these kernels take all P points in two launches.
//
// Tiled path (k <= wls_lstsq_tiled_max_k(), 111: R, a tile and the rest
// fit a block's 227 KB of shared memory), two kernels:
//
//  wls_tsqr_fold -- one block of 256 threads per point.  The block keeps a
//   running triangle R of the augmented matrix [Aw | rw] ((k + 1)
//   columns, padded to kp, a multiple of 8) in shared memory and folds in
//   the point's N rows in tiles of TILE = 128 consecutive rows.  A tile of
//   Aw's row-major rows is one contiguous span: it is read once, by
//   cp.async, into the tile buffer, and while it is folded the next tile's
//   lines are prefetched into L2 (one buffer: two would leave room for
//   64-row tiles only, twice the panels per point; measured slower).  Zero
//   rows pad the ragged last tile and leave R as it is.  The fold is the
//   Householder QR of [R; tile] that uses R's triangle: reflector j is
//   I - tau u u^T with u = [alpha e_j; t], t the tile's column j as it
//   stands, so it touches row j of R and the tile rows only, and t itself
//   is stored as the reflector.  The reflectors go NB = 8 at a time in compact WY form,
//   I - V Tw V^T with V = [diag(alpha); U] and Tw upper triangular (LAPACK
//   dlarft).  One warp factors a panel (4 tile rows a lane in registers,
//   the panel's R block in lanes 0..7): per reflector one fused reduction,
//   a reduce-scatter of 8 dot products (t with every panel column: its
//   norm, the later columns' products, Tw's column), then a square root
//   and a division.  Every warp then takes 8-column slices of the trailing
//   matrix and applies the block as three products on the float64 tensor
//   cores (mma.sync m8n8k4; wgmma has no f64 type): W = diag(alpha) R_rows
//   + U^T T, W = Tw^T W, T = T - U W with R_rows -= diag(alpha) W.
//   Look-ahead: warp 0 updates the next panel's slice first and factors it
//   while the other warps finish the trailing update, so a panel costs one
//   __syncthreads.  The column sums of squares (the norms) and the finite
//   check are taken from each tile as it lands.  The block writes its
//   triangle (rows 0..k-1, columns 0..k, c = (Q^T rw)[:k] in the last), its
//   sums of squares and its NaN flag to a workspace: (k (k + 1) + k + 1)
//   doubles per point, 16 MB for a chunk of 256 points at k = 88.
//  wls_tsqr_svd -- one block of 256 threads per point, two blocks an SM:
//   the norms, the poisoning of a point with a non-finite input, R's
//   columns scaled by 1 / norms (QR(A D^-1) = Q (R D^-1), and Householder
//   QR is columnwise backward stable, so this is the QR of the normalized
//   matrix to rounding; column scales to 1e8 are held by chip_smoke.py),
//   then a one-sided Jacobi SVD of the triangle's transpose: R's rows are
//   rotated in pairs in place (R D^-1 = J W^T), 8 lanes a pair, all pairs
//   of a round at once, the lanes' entries kept in registers between the
//   products and the rotation.  J itself is not kept: x needs only J^T c,
//   and each rotation of J's columns a and b rotates entries a and b of
//   y = J^T c alike.  s_a = ||W_a||, x = sum_a W_a (mask_a / s_a^2) y_a.
//
// Global path (k > wls_lstsq_tiled_max_k()): wls_lstsq_global, the
// untiled kernel:
// one block of 512 threads per point, Aw transposed into a
// (P, k, N) workspace, column norms, an unblocked Householder QR over
// device memory, then the Jacobi on R's columns with V, in shared memory
// up to k = 119 and in a second workspace above.
//
// Both Jacobis rotate in round-robin order (every pair once per sweep)
// until a sweep rotates no pair whose cosine exceeds sqrt(k) eps (LAPACK
// dgesvj's tolerance), at most MAX_SWEEPS; a point that still rotates then
// is poisoned.  A zero column stays exactly zero through the folds (its
// reflector is the identity; U^T of a zero column is 0), so its direction
// is dropped and its x is exactly 0; its row of R stays zero too, where
// LAPACK's keeps a row of Q^T A (R is unique up to its rows' signs only at
// full rank, and R^T R = A^T A at any rank).  The kernels differ from the
// reference's LAPACK SVD by rounding, not bitwise: chip_smoke.py holds x
// to 1e-9 of max|x| per point and s to 1e-12 s_max against the plain twin
// (kernels/wls_lstsq.py), with the same rank and NaN flags, and each tiled
// kernel against its own plain version.
//
// Bound on this card.  Per point the function must read Aw and rw once
// (8 N (k + 1) bytes) and do ~2 N k^2 operations of QR (matrix products,
// at the float64 tensor cores' rate) plus ~12 k^3 for an SVD of R: bound by
// operations at the path's shapes (P = 256, N = 4005, k = 88; 0.32 ms).
// The tiled fold reads the matrix once; what holds it is the panel warp's
// chain (a reduction, a square root and a division per reflector, k per
// tile) and the trailing slices' shared-memory traffic, which on the card
// add up rather than overlap; the Jacobi is bound by its rounds' barriers
// and shared-memory traffic (~10 sweeps of k - 1 rounds).
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

namespace {

constexpr int MAX_SWEEPS = 30;
constexpr double EPS = 2.220446049250313e-16;
constexpr int SMEM_BYTES = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // every lane holds the same bits: each step adds a pair both ways
}

// Each of 8 values summed over the warp, returned to every lane: a
// reduce-scatter (lanes 4c..4c+3 end with value c's sum: at each of the
// first three levels a lane keeps half of its values and adds its
// partner's copy of them), then a gather, 34 shuffles of 32 bits where 8
// warp sums take 80.  Every lane holds the same bits.
__device__ __forceinline__ void warp_sum8(double (&e)[8], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  double a4[4], a2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double keep = h4 ? e[i + 4] : e[i], send = h4 ? e[i] : e[i + 4];
    a4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const double keep = h3 ? a4[i + 2] : a4[i], send = h3 ? a4[i] : a4[i + 2];
    a2[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  double a1 = (h2 ? a2[1] : a2[0]) +
              __shfl_xor_sync(0xffffffffu, h2 ? a2[0] : a2[1], 4);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
  a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) e[c] = __shfl_sync(0xffffffffu, a1, 4 * c);
}

// ---- hardware primitives: the f64 tensor-core product, async copies -------
// d (8x8, 2 a lane: row lane/4, columns 2 (lane%4) + {0,1}) += a (8x4, row
// lane/4, column lane%4) b (4x8, row lane%4, column lane/4)
__device__ __forceinline__ void mma_884(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// ---- end of hardware primitives -------------------------------------------

// ---------------------------------------------------------------------------
// Tiled path
// ---------------------------------------------------------------------------
constexpr int TILE = 128;      // M: rows of a tile of the fold
constexpr int NB = 8;          // reflectors per compact-WY block
constexpr int ACC = 4;         // independent sums of a slice's U^T T
constexpr int JG = 8;          // lanes per Jacobi pair (4, 8, 16 or 32)
constexpr int JPL = 128 / JG;  // a row's entries per lane, for k < 128
constexpr int FOLD_THREADS = 256;
constexpr int SVD_THREADS = 256;
constexpr int SVD_BLOCKS = 2;  // wls_tsqr_svd's blocks an SM (registers)
static_assert(NB == 8, "a WY block is one 8-column mma slice");
constexpr int TWB = NB * NB + NB;  // a panel's Tw and alphas
static_assert(TILE % (4 * ACC) == 0, "");

struct Shape {
  int k, kp, ldr, ldt;
  __host__ __device__ explicit Shape(int k_)
      : k(k_), kp((k_ + 8) / 8 * 8), ldr(kp + 1),
        ldt((kp + 15) / 16 * 16 + 4) {}
  // shared memory, in doubles: wls_tsqr_fold's R, tile, W slice rows and
  // two Tw; wls_tsqr_svd's R and four k-vectors (norms, sigma, coef, y)
  __host__ __device__ int fold_smem() const {
    return kp * ldr + TILE * ldt + 8 * ldt + 2 * TWB;
  }
  __host__ __device__ int svd_smem() const { return kp * ldr + 4 * kp; }
  // workspace per point: the triangle's k rows of k + 1, k sums of
  // squares, the NaN flag
  __host__ __device__ int ws_doubles() const { return k * (k + 1) + k + 1; }
};

// One warp factors the panel of columns j0..j0+NB-1 of [R rows j0..; T]
// (T of M rows).  Reflector j = j0 + jj (j < k; the others are the
// identity) is H = I - tau u u^T with u = [alpha e_j; t], t the tile's
// column j as it stands, alpha = x0 - beta and tau = 1 / (||x|| (|x0| +
// ||x||)): it maps column j of the stacked matrix onto beta e_j and
// touches row j of R and the tile rows only.  t is left in place as the
// reflector's tile part, alpha goes to Al, and Tw's column jj is formed on
// the way (LAPACK dlarft; the R parts of distinct reflectors are
// orthogonal, so only the tile parts enter it).  One fused reduction a
// reflector gives t's norm, its products with the panel's later columns
// and with the earlier reflectors.  The panel's diagonal block of R lives
// in the registers of lanes 0..NB-1 (lane c holds its column c).
template <int M>
__device__ __forceinline__ void panel_factor(double* T, double* R,
                                             double* Tw, double* Al, int j0,
                                             const Shape& sh, int lane) {
  constexpr int RPL = M / 32;  // tile rows per lane
  constexpr int B = NB;
  double t[B][RPL], rc[B];
#pragma unroll
  for (int c = 0; c < B; ++c)
#pragma unroll
    for (int r = 0; r < RPL; ++r)
      t[c][r] = T[(lane + 32 * r) * sh.ldt + j0 + c];
#pragma unroll
  for (int i = 0; i < B; ++i)
    rc[i] = lane < B ? R[(j0 + i) * sh.ldr + j0 + lane] : 0.0;
#pragma unroll
  for (int jj = 0; jj < B; ++jj) {
    const int j = j0 + jj;
    double e[B];  // t_jj . t_c for every column c of the panel
#pragma unroll
    for (int c = 0; c < B; ++c) {
      e[c] = 0.0;
#pragma unroll
      for (int r = 0; r < RPL; ++r) e[c] += t[jj][r] * t[c][r];
    }
    warp_sum8(e, lane);
    const double x0 = __shfl_sync(0xffffffffu, rc[jj], jj);
    double tau = 0.0, beta = x0, alpha = 0.0;
    if (j < sh.k && e[jj] > 0.0) {
      const double nrm = sqrt(x0 * x0 + e[jj]);
      const double ax = fabs(x0) + nrm;
      beta = x0 >= 0.0 ? -nrm : nrm;
      alpha = x0 >= 0.0 ? ax : -ax;
      tau = 1.0 / (nrm * ax);
    }
    if (lane == jj) rc[jj] = beta;
#pragma unroll
    for (int l = jj + 1; l < B; ++l) {
      const double rjl = __shfl_sync(0xffffffffu, rc[jj], l);
      const double f = tau * (alpha * rjl + e[l]);
#pragma unroll
      for (int r = 0; r < RPL; ++r) t[l][r] -= f * t[jj][r];
      if (lane == l) rc[jj] -= f * alpha;
    }
    if (lane < jj) {  // Tw[0:jj, jj] = -tau Tw[0:jj, 0:jj] (U^T u_jj)
      double acc = 0.0;
#pragma unroll
      for (int i = 0; i < jj; ++i) acc += Tw[lane * B + i] * e[i];
      Tw[lane * B + jj] = -tau * acc;
    }
    if (lane == jj) {
      Tw[jj * B + jj] = tau;
#pragma unroll
      for (int i = 0; i < jj; ++i) Tw[jj * B + i] = 0.0;
      Al[jj] = alpha;
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c)
#pragma unroll
    for (int r = 0; r < RPL; ++r)
      T[(lane + 32 * r) * sh.ldt + j0 + c] = t[c][r];
  if (lane < B)
#pragma unroll
    for (int i = 0; i < B; ++i) R[(j0 + i) * sh.ldr + j0 + lane] = rc[i];
  __syncwarp();
}

// One warp applies panel j0's WY block, I - V Tw V^T with V = [diag(Al);
// U], to the trailing slice of columns c0..c0+7 of [R rows j0..j0+7; T],
// on the tensor cores; Wb holds the slice's 8 x 8 W between the products.
template <int M>
__device__ __forceinline__ void trail_slice(double* T, double* R,
                                            const double* Tw,
                                            const double* Al, double* Wb,
                                            int j0, int c0, const Shape& sh,
                                            int lane) {
  const int g = lane >> 2, q = lane & 3;
  double* Rr = R + (j0 + g) * sh.ldr + c0 + 2 * q;
  const double ag = Al[g];
  // W = diag(Al) R + U^T T, the tile's rows dealt to ACC independent sums
  // so that no mma waits on the one before
  double w[ACC][2];
#pragma unroll
  for (int a = 0; a < ACC; ++a) w[a][0] = w[a][1] = 0.0;
  w[0][0] = ag * Rr[0];
  w[0][1] = ag * Rr[1];
#pragma unroll 2
  for (int kk = 0; kk < M; kk += 4 * ACC) {
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const double* row = T + (kk + 4 * a + q) * sh.ldt;
      mma_884(w[a], row[j0 + g], row[c0 + g]);
    }
  }
#pragma unroll
  for (int a = 1; a < ACC; ++a) {
    w[0][0] += w[a][0];
    w[0][1] += w[a][1];
  }
  double* Wr = Wb + g * sh.ldt + c0 + 2 * q;
  Wr[0] = w[0][0];
  Wr[1] = w[0][1];
  __syncwarp();
  double u[2] = {0.0, 0.0};
#pragma unroll
  for (int ks = 0; ks < 8; ks += 4)  // W = Tw^T W
    mma_884(u, Tw[(ks + q) * 8 + g], Wb[(ks + q) * sh.ldt + c0 + g]);
  __syncwarp();
  Rr[0] -= ag * u[0];
  Rr[1] -= ag * u[1];
  Wr[0] = u[0];
  Wr[1] = u[1];
  __syncwarp();
  const double b0 = Wb[q * sh.ldt + c0 + g];
  const double b1 = Wb[(4 + q) * sh.ldt + c0 + g];
#pragma unroll 2
  for (int mt = 0; mt < M; mt += 8) {  // T = T - V W
    double* row = T + (mt + g) * sh.ldt;
    double c[2] = {row[c0 + 2 * q], row[c0 + 2 * q + 1]};
    mma_884(c, -row[j0 + q], b0);
    mma_884(c, -row[j0 + 4 + q], b1);
    row[c0 + 2 * q] = c[0];
    row[c0 + 2 * q + 1] = c[1];
  }
  __syncwarp();
}

// Fold the tile T (M rows, columns 0..k, zero beyond) into R.  Tw holds
// two blocks of TWB doubles (this panel's and the next's): Tw, then the
// reflectors' alphas; all threads of the block call this, and it ends with
// a __syncthreads.
template <int M, int WARPS>
__device__ __forceinline__ void fold_tile(double* T, double* R, double* Tw,
                                          double* Wb, const Shape& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int np = (sh.k + NB - 1) / NB;
  if (warp == 0) panel_factor<M>(T, R, Tw, Tw + NB * NB, 0, sh, lane);
  __syncthreads();
  for (int b = 0; b < np; ++b) {
    const int j0 = b * NB;
    const double* tw = Tw + (b & 1) * TWB;
    const int nq = (sh.kp - j0 - NB) / 8;  // 8-column slices right of it
    const bool ahead = b + 1 < np;
    if (ahead && warp == 0) {  // the next panel first, then factor it
      trail_slice<M>(T, R, tw, tw + NB * NB, Wb, j0, j0 + NB, sh, lane);
      double* tw1 = Tw + ((b + 1) & 1) * TWB;
      panel_factor<M>(T, R, tw1, tw1 + NB * NB, j0 + NB, sh, lane);
    }
    const int w = ahead ? warp - 1 : warp;
    const int stride = ahead ? WARPS - 1 : WARPS;
    if (w >= 0)
      for (int u = (ahead ? 1 : 0) + w; u < nq; u += stride)
        trail_slice<M>(T, R, tw, tw + NB * NB, Wb, j0, j0 + NB + 8 * u, sh,
                       lane);
    __syncthreads();
  }
}

// Rows rs..rs+m-1 of a point's [Aw | rw] into the tile T by cp.async,
// rows m..TILE-1 as zeros.
template <int WARPS>
__device__ __forceinline__ void load_tile(double* T, const double* A,
                                          const double* b, int rs, int m,
                                          int k, const Shape& sh, int warp,
                                          int lane) {
  for (int r = warp; r < TILE; r += WARPS) {
    double* dst = T + r * sh.ldt;
    if (r < m) {
      const double* src = A + (long)(rs + r) * k;
      for (int c = lane; c < k; c += 32) cp_async8(dst + c, src + c);
      if (lane == 0) cp_async8(dst + k, b + rs + r);
    } else {
      for (int c = lane; c <= k; c += 32) dst[c] = 0.0;
    }
  }
  cp_async_commit();
}

// Aw's rows rs..rs+m-1 into L2, a 128-byte line a thread at a time.
__device__ __forceinline__ void prefetch_rows(const double* A, int rs,
                                              int m, int k, int tid) {
  const char* a = (const char*)(A + (long)rs * k);
  for (long o = 128L * tid; o < 8L * m * k; o += 128L * FOLD_THREADS)
    prefetch_l2(a + o);
}

// one block an SM (its shared memory), so up to 255 registers a thread
__global__ void __launch_bounds__(FOLD_THREADS, 1)
    wls_tsqr_fold(const double* __restrict__ Aw,
                  const double* __restrict__ rw, int N, int k,
                  double* __restrict__ ws) {
  constexpr int WARPS = FOLD_THREADS / 32;
  extern __shared__ double smem[];
  const Shape sh(k);
  double* R = smem;
  double* T = R + sh.kp * sh.ldr;
  double* Wb = T + TILE * sh.ldt;
  double* Tw = Wb + 8 * sh.ldt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long p = blockIdx.x;
  const double* A = Aw + p * N * k;
  const double* b = rw + p * N;
  for (int e = tid; e < sh.fold_smem(); e += FOLD_THREADS) smem[e] = 0.0;
  __syncthreads();

  // column sums of squares: thread (grp, col) sums rows grp, grp + G, ...
  const int cw = k + 1, G = FOLD_THREADS / cw, col = tid % cw, grp = tid / cw;
  double acc = 0.0;
  int bad = 0;
  // rows r0..r0+TILE-1 in T; the next tile's lines are fetched into L2
  // while this one is folded, and copied in once it is spent
  if (N > 0) load_tile<WARPS>(T, A, b, 0, min(TILE, N), k, sh, warp, lane);
  for (int r0 = 0; r0 < N; r0 += TILE) {
    const int r1 = r0 + TILE;
    cp_async_wait<0>();
    if (r1 < N) prefetch_rows(A, r1, min(TILE, N - r1), k, tid);
    __syncthreads();
    if (grp < G)
      for (int r = grp; r < TILE; r += G) {
        const double a = T[r * sh.ldt + col];
        bad |= !isfinite(a);
        acc += a * a;
      }
    __syncthreads();
    fold_tile<TILE, WARPS>(T, R, Tw, Wb, sh);
    if (r1 < N)
      load_tile<WARPS>(T, A, b, r1, min(TILE, N - r1), k, sh, warp, lane);
  }
  if (grp < G) T[grp * cw + col] = acc;  // the tile is spent
  bad = __syncthreads_or(bad);
  double* out = ws + p * sh.ws_doubles();
  for (int e = tid; e < k * cw; e += FOLD_THREADS)
    out[e] = R[(e / cw) * sh.ldr + e % cw];
  for (int c = tid; c < k; c += FOLD_THREADS) {
    double v = 0.0;
    for (int g = 0; g < G; ++g) v += T[g * cw + c];
    out[k * cw + c] = v;
  }
  if (tid == 0) out[k * cw + k] = bad ? 1.0 : 0.0;
}

// Sum over the JG lanes of a Jacobi group, returned to each of them.
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = JG / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per point on its fold's triangle: the column norms, the
// poisoning of a point with a NaN, R D^-1, the Jacobi, the mask and x.
__global__ void __launch_bounds__(SVD_THREADS, SVD_BLOCKS)
    wls_tsqr_svd(const double* __restrict__ ws, int N, int k,
                 double* __restrict__ x, double* __restrict__ sv,
                 double* __restrict__ norms, int* __restrict__ sweeps_out) {
  constexpr int WARPS = SVD_THREADS / 32;
  constexpr int GROUPS = SVD_THREADS / JG;
  extern __shared__ double smem[];
  __shared__ int rotated;
  const Shape sh(k);
  double* R = smem;
  double* nrm = R + sh.kp * sh.ldr;
  double* sigma = nrm + sh.kp;
  double* coef = sigma + sh.kp;
  double* y = coef + sh.kp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long p = blockIdx.x;
  const int cw = k + 1, ld = sh.ldr;
  const double* wp = ws + p * sh.ws_doubles();
  const bool bad = wp[k * cw + k] != 0.0;
  for (int c = tid; c < k; c += SVD_THREADS) {
    const double n = sqrt(wp[k * cw + c]);
    nrm[c] = n == 0.0 ? 1.0 : n;
    norms[p * k + c] = nrm[c];
  }
  if (bad) {
    for (int j = tid; j < k; j += SVD_THREADS) {
      x[p * k + j] = nan("");
      sv[p * k + j] = nan("");
    }
    if (tid == 0) sweeps_out[p] = 0;
    return;
  }
  for (int e = tid; e < k * cw; e += SVD_THREADS)
    R[(e / cw) * ld + e % cw] = wp[e];
  __syncthreads();
  // R D^-1 (column k, c, is not scaled); y = c
  for (int e = tid; e < k * k; e += SVD_THREADS) {
    const int i = e / k, c = e % k;
    R[i * ld + c] = R[i * ld + c] / nrm[c];
  }
  for (int i = tid; i < k; i += SVD_THREADS) y[i] = R[i * ld + k];
  if (tid == 0) rotated = 0;
  __syncthreads();

  // One-sided Jacobi on the columns of M = (R D^-1)^T, R's rows, in place:
  // M J = W, so R D^-1 = J W^T.  J itself is not kept: x needs only
  // J^T c, and the rotations of J's columns a and b rotate entries a and b
  // of y = J^T c alike.  A group of JG lanes per pair, every pair of a
  // round at once.
  const int kk = k + (k & 1);  // an odd k pairs its last row with a bye
  const double tol2 = EPS * EPS * (double)k;  // (sqrt(k) eps)^2
  const int grp = tid / JG, gl = tid % JG;
  bool converged = false;
  int sweep = 0;
  while (sweep < MAX_SWEEPS && !converged) {
    ++sweep;
    for (int r = 0; r < kk - 1; ++r) {
      for (int m0 = 0; m0 < kk / 2; m0 += GROUPS) {
        const int m = m0 + grp;
        const int pa = m == 0 ? 0 : 1 + (m - 1 + r) % (kk - 1);
        const int pb = 1 + (kk - 2 - m + r) % (kk - 1);
        const bool pair = m < kk / 2 && pa < k && pb < k;
        double* Ma = R + pa * ld;
        double* Mb = R + pb * ld;
        double u[JPL], v[JPL];  // the lane's entries, read once
        double al = 0.0, bt = 0.0, ga = 0.0;
#pragma unroll
        for (int n = 0; n < JPL; ++n) {
          const int i = gl + JG * n;
          u[n] = pair && i < k ? Ma[i] : 0.0;
          v[n] = pair && i < k ? Mb[i] : 0.0;
          al += u[n] * u[n];
          bt += v[n] * v[n];
          ga += u[n] * v[n];
        }
        al = group_sum(al);
        bt = group_sum(bt);
        ga = group_sum(ga);
        if (pair && ga * ga > tol2 * al * bt) {
          // t = tan(theta) of the rotation that zeroes ga, the smaller root
          // of ga t^2 + (bt - al) t - ga = 0
          const double d = bt - al;
          const double h = sqrt(d * d + 4.0 * ga * ga);
          const double t = (d >= 0.0 ? 2.0 * ga : -2.0 * ga) / (fabs(d) + h);
          const double cs = rsqrt(1.0 + t * t);
          const double sn = cs * t;
#pragma unroll
          for (int n = 0; n < JPL; ++n) {
            const int i = gl + JG * n;
            if (i < k) {
              Ma[i] = cs * u[n] - sn * v[n];
              Mb[i] = sn * u[n] + cs * v[n];
            }
          }
          if (gl == 0) {
            const double u = y[pa], v = y[pb];
            y[pa] = cs * u - sn * v;
            y[pb] = sn * u + cs * v;
            rotated = 1;
          }
        }
      }
      __syncthreads();
    }
    converged = rotated == 0;
    __syncthreads();
    if (tid == 0) rotated = 0;
    __syncthreads();
  }

  // s_a = ||W_a||; R D^-1 = J W^T = sum_a J_a s_a (W_a / s_a)^T, so
  // x = sum_a W_a (mask_a / s_a^2) (J^T c)_a
  for (int j = warp; j < k; j += WARPS) {
    double s = 0.0;
    for (int i = lane; i < k; i += 32) s += R[j * ld + i] * R[j * ld + i];
    s = warp_sum(s);
    if (lane == 0) sigma[j] = sqrt(s);
  }
  __syncthreads();
  double smax = 0.0;
  for (int i = 0; i < k; ++i) smax = fmax(smax, sigma[i]);
  const double cut = EPS * (double)(N > k ? N : k) * smax;
  for (int j = tid; j < k; j += SVD_THREADS) {
    const double s = sigma[j];
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const double t = sigma[i];
      rank += (t > s) || (t == s && i < j);
    }
    sv[p * k + rank] = converged ? s : nan("");
    coef[j] = (s > 0.0 && s >= cut) ? y[j] / s / s : 0.0;
  }
  __syncthreads();
  for (int l = tid; l < k; l += SVD_THREADS) {
    double a = 0.0;
    for (int i = 0; i < k; ++i) a += coef[i] * R[i * ld + l];
    x[p * k + l] = converged ? a : nan("");
  }
  if (tid == 0) sweeps_out[p] = sweep;
}

// ---------------------------------------------------------------------------
// Global path: the untiled kernel, for k > wls_lstsq_tiled_max_k()
// ---------------------------------------------------------------------------
namespace global_path {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

// shared memory, in doubles: scratch, four k-vectors and hh, then R and V
// unless they live in the rv_global workspace
__host__ int smem_doubles(int k, bool rv_in_smem) {
  return WARPS + 1 + 4 * k + 1 + (rv_in_smem ? 2 * k * k : 0);
}

// Sum over the block, returned to every thread; `scratch` holds WARPS + 1.
__device__ double block_sum(double v, double* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < WARPS ? scratch[lane] : 0.0;
    t = warp_sum(t);
    if (lane == 0) scratch[WARPS] = t;
  }
  __syncthreads();
  const double r = scratch[WARPS];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
    wls_lstsq_global(const double* __restrict__ Aw,
                     const double* __restrict__ rw, int N, int k,
                     double* __restrict__ work, double* __restrict__ rwork,
                     double* __restrict__ rv_global, double* __restrict__ x,
                     double* __restrict__ sv, double* __restrict__ norms,
                     int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  __shared__ int rotated;
  double* scratch = smem;               // WARPS + 1
  double* alpha = scratch + WARPS + 1;  // k: R's diagonal
  double* cvec = alpha + k;             // k: (Q^T rw)[:k]
  double* sigma = cvec + k;             // k
  double* coef = sigma + k;             // k
  double* hh = coef + k;                // 1: 2 / v^T v of the reflector
  const long p = blockIdx.x;
  double* R = rv_global != nullptr ? rv_global + p * 2 * k * k : hh + 1;
  double* V = R + (long)k * k;          // both column-major, k x k
  const double* A = Aw + p * N * k;
  const double* b = rw + p * N;
  double* W = work + p * N * k;
  double* c = rwork + p * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 0. transpose into W; copy rw
  int bad = 0;
  const int nk = N * k;
  for (int e = tid; e < nk; e += THREADS) {
    const double a = A[e];
    bad |= !isfinite(a);
    W[(long)(e % k) * N + e / k] = a;
  }
  for (int i = tid; i < N; i += THREADS) {
    const double v = b[i];
    bad |= !isfinite(v);
    c[i] = v;
  }
  bad = __syncthreads_or(bad);
  // 1. column norms, then normalized columns
  for (int j = warp; j < k; j += WARPS) {
    double* col = W + (long)j * N;
    double s = 0.0;
    for (int i = lane; i < N; i += 32) s += col[i] * col[i];
    s = sqrt(warp_sum(s));
    const double nrm = s == 0.0 ? 1.0 : s;
    if (lane == 0) norms[p * k + j] = nrm;
    for (int i = lane; i < N; i += 32) col[i] = col[i] / nrm;
  }
  if (bad) {
    for (int j = tid; j < k; j += THREADS) {
      x[p * k + j] = nan("");
      sv[p * k + j] = nan("");
    }
    if (tid == 0) sweeps_out[p] = 0;
    return;
  }
  __syncthreads();

  // 2. Householder QR; reflector j is stored over column j's rows j..N-1
  for (int j = 0; j < k; ++j) {
    double* vj = W + (long)j * N;
    double s = 0.0;
    for (int i = j + tid; i < N; i += THREADS) s += vj[i] * vj[i];
    s = block_sum(s, scratch);
    if (tid == 0) {
      const double x0 = vj[j];
      const double nrm = sqrt(s);
      double a = 0.0, be = 0.0;
      if (nrm > 0.0) {
        a = x0 >= 0.0 ? -nrm : nrm;
        vj[j] = x0 - a;
        be = 1.0 / (nrm * (nrm + fabs(x0)));  // 2 / v^T v
      }
      alpha[j] = a;
      hh[0] = be;
    }
    __syncthreads();
    const double be = hh[0];
    if (be != 0.0) {
      for (int l = j + 1 + warp; l <= k; l += WARPS) {
        double* col = l < k ? W + (long)l * N : c;
        double d = 0.0;
        for (int i = j + lane; i < N; i += 32) d += vj[i] * col[i];
        d = warp_sum(d) * be;
        for (int i = j + lane; i < N; i += 32) col[i] -= d * vj[i];
      }
    }
    __syncthreads();
  }

  // 3. R and V = I; the Jacobi sweeps
  for (int e = tid; e < k * k; e += THREADS) {
    const int col = e / k, row = e % k;
    R[e] = row < col ? W[(long)col * N + row]
                     : (row == col ? alpha[col] : 0.0);
    V[e] = row == col ? 1.0 : 0.0;
  }
  for (int i = tid; i < k; i += THREADS) cvec[i] = c[i];
  if (tid == 0) rotated = 0;
  __syncthreads();
  const int kk = k + (k & 1);  // an odd k pairs its last column with a bye
  const double tol = EPS * sqrt((double)k);
  bool converged = false;
  int sweep = 0;
  while (sweep < MAX_SWEEPS && !converged) {
    ++sweep;
    for (int r = 0; r < kk - 1; ++r) {
      for (int m = warp; m < kk / 2; m += WARPS) {
        const int pa = m == 0 ? 0 : 1 + (m - 1 + r) % (kk - 1);
        const int pb = 1 + (kk - 2 - m + r) % (kk - 1);
        if (pa >= k || pb >= k) continue;
        double* Ra = R + (long)pa * k;
        double* Rb = R + (long)pb * k;
        double al = 0.0, bt = 0.0, ga = 0.0;
        for (int i = lane; i < k; i += 32) {
          const double u = Ra[i], v = Rb[i];
          al += u * u;
          bt += v * v;
          ga += u * v;
        }
        al = warp_sum(al);
        bt = warp_sum(bt);
        ga = warp_sum(ga);
        if (fabs(ga) > tol * sqrt(al * bt)) {
          const double zeta = (bt - al) / (2.0 * ga);
          const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                           (fabs(zeta) + sqrt(1.0 + zeta * zeta));
          const double cs = 1.0 / sqrt(1.0 + t * t);
          const double sn = cs * t;
          double* Va = V + (long)pa * k;
          double* Vb = V + (long)pb * k;
          for (int i = lane; i < k; i += 32) {
            const double u = Ra[i], v = Rb[i];
            Ra[i] = cs * u - sn * v;
            Rb[i] = sn * u + cs * v;
            const double pu = Va[i], pv = Vb[i];
            Va[i] = cs * pu - sn * pv;
            Vb[i] = sn * pu + cs * pv;
          }
          if (lane == 0) rotated = 1;
        }
      }
      __syncthreads();
    }
    converged = rotated == 0;
    __syncthreads();
    if (tid == 0) rotated = 0;
    __syncthreads();
  }

  // 4. s, the mask, the kept directions' coefficients, x
  for (int j = warp; j < k; j += WARPS) {
    const double* Rj = R + (long)j * k;
    double s = 0.0, d = 0.0;
    for (int i = lane; i < k; i += 32) {
      s += Rj[i] * Rj[i];
      d += Rj[i] * cvec[i];
    }
    s = warp_sum(s);
    d = warp_sum(d);
    if (lane == 0) {
      sigma[j] = sqrt(s);
      coef[j] = d;
    }
  }
  __syncthreads();
  double smax = 0.0;
  for (int i = 0; i < k; ++i) smax = fmax(smax, sigma[i]);
  const double cut = EPS * (double)(N > k ? N : k) * smax;
  for (int j = tid; j < k; j += THREADS) {
    const double s = sigma[j];
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const double t = sigma[i];
      rank += (t > s) || (t == s && i < j);
    }
    sv[p * k + rank] = converged ? s : nan("");
    coef[j] = (s > 0.0 && s >= cut) ? coef[j] / s / s : 0.0;
  }
  __syncthreads();
  for (int l = tid; l < k; l += THREADS) {
    double acc = 0.0;
    for (int i = 0; i < k; ++i) acc += coef[i] * V[(long)i * k + l];
    x[p * k + l] = converged ? acc : nan("");
  }
  if (tid == 0) sweeps_out[p] = sweep;
}

}  // namespace global_path

}  // namespace

extern "C" int wls_lstsq_tiled_max_k() {
  int k = 1;
  while (Shape(k + 1).fold_smem() * 8 <= SMEM_BYTES && k + 1 < JPL * JG) ++k;
  return k;
}

// on the global path, the largest k whose R and V stay in shared memory
extern "C" int wls_lstsq_global_smem_max_k() {
  int k = 1;
  while (8 * global_path::smem_doubles(k + 1, true) <= SMEM_BYTES) ++k;
  return k;
}

// The design, as "NAME=value" words: the tiled path's tile rows, WY block,
// sums a slice, Jacobi lanes a pair, threads and blocks an SM, the sweep
// cap and the two limits on k.
extern "C" const char* wls_lstsq_design() {
  static char text[256];
  snprintf(text, sizeof text,
           "TILE=%d NB=%d ACC=%d JG=%d FOLD_THREADS=%d SVD_THREADS=%d "
           "SVD_BLOCKS=%d MAX_SWEEPS=%d TILED_MAX_K=%d SMEM_MAX_K=%d",
           TILE, NB, ACC, JG, FOLD_THREADS, SVD_THREADS, SVD_BLOCKS,
           MAX_SWEEPS, wls_lstsq_tiled_max_k(), wls_lstsq_global_smem_max_k());
  return text;
}

extern "C" int wls_lstsq_ws_doubles(int k) { return Shape(k).ws_doubles(); }

// The tiled path; ws holds P wls_lstsq_ws_doubles(k) doubles.  stage 1
// launches wls_tsqr_fold, 2 wls_tsqr_svd, 3 both.
extern "C" int wls_lstsq_launch(const double* Aw, const double* rw, int P,
                                int N, int k, double* ws, double* x,
                                double* sv, double* norms, int* sweeps,
                                int stage, void* stream) {
  if (P == 0) return 0;
  const Shape sh(k);
  if (k > wls_lstsq_tiled_max_k() || stage < 1 || stage > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (stage & 1) {
    const int bytes = sh.fold_smem() * 8;
    err = cudaFuncSetAttribute(
        wls_tsqr_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    wls_tsqr_fold<<<P, FOLD_THREADS, bytes, st>>>(Aw, rw, N, k, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stage & 2) {
    const int bytes = sh.svd_smem() * 8;
    err = cudaFuncSetAttribute(
        wls_tsqr_svd, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    wls_tsqr_svd<<<P, SVD_THREADS, bytes, st>>>(ws, N, k, x, sv, norms,
                                                sweeps);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" int wls_lstsq_global_launch(const double* Aw, const double* rw,
                                       int P, int N, int k, double* work,
                                       double* rwork, double* rv_global,
                                       double* x, double* sv, double* norms,
                                       int* sweeps, void* stream) {
  using namespace global_path;
  if (P == 0) return 0;
  const int bytes = 8 * smem_doubles(k, rv_global == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      wls_lstsq_global, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wls_lstsq_global<<<P, THREADS, bytes, (cudaStream_t)stream>>>(
      Aw, rw, N, k, work, rwork, rv_global, x, sv, norms, sweeps);
  return (int)cudaGetLastError();
}

extern "C" const char* wls_lstsq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
