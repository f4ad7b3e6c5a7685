// K10 hd_cross_lnlike: the Hellings-Downs cross term of the joint PTA
// log-likelihood at a batch of walker points, as a blocked right-looking
// Cholesky spread over many CTAs per walker.
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
//   L L^T = M, z = L^-1 v
//   out_b  = 0.5 sum_j z_j^2 - sum_j log L_jj
// At log10_A = -inf the amplitude is exactly 0: M = I, v = 0, and the
// result is exactly 0.0 (the reference's factorization pin).
//
// The factor lives in a global workspace (B, R, R + 1), column-major per
// walker: column j's rows j..R at W[j (R + 1) + i], row R the augmented
// row that carries v and becomes z.  Only the lower triangle is written or
// read.  One call, per chunk of walkers the wrapper hands it:
//   hd_cross_form    M's lower triangle and v into the workspace, in 32 x
//                    32 tiles (G read row-wise, written column-wise);
//   per panel of NB = 64 columns [k0, k1):
//   hd_cross_panel   grid (row blocks of RB = 128 below the panel's
//                    diagonal block) x walkers, one thread a row, its
//                    panel entries in registers: the CTA factors the NB x
//                    NB diagonal block right-looking (the pivot sqrt(a_jj),
//                    each row's entry divided, each row's later entries
//                    updated by one product each) and carries its RB rows
//                    along, one barrier a column.  Every CTA of a walker
//                    factors the diagonal block itself (the same bits), so
//                    no CTA waits for another; block 0 keeps the pivots.
//   hd_cross_trail   grid (64 x 64 tiles of the trailing lower triangle,
//                    the augmented row included) x walkers, 128 threads,
//                    an 8 x 4 register tile a thread: the tile's running
//                    values stay in registers while the panel's columns
//                    stream through shared memory KC = 32 at a time, and
//                    each entry takes a = a - L_ik L_lk, one rounded
//                    product at a time, in ascending k.
//   hd_cross_sum     one CTA a walker: log L_jj and z_j^2 formed in
//                    parallel, then both sums taken by one thread in column
//                    order.
//
// Bitwise with the plain version (kernels/hd_cross_lnlike.py), an
// unblocked right-looking loop: built with -fmad=false (and no DMMA, whose
// f64 tensor cores fuse the multiply-add), every entry receives the same
// sequence of rounded products and differences in ascending column order,
// each column is divided by its pivot after all earlier columns' updates,
// and the two sums run in column order.  No partial sum of a panel's
// products is ever formed apart from the entry's running value.
//
// What bounds it: the R^3 / 6 multiply-subtracts per walker, each a
// separate float64 multiply and subtract on the CUDA cores (16.7e12
// float64 instructions/s on an H100 SXM).  The trailing update holds most
// of them: its register tile does 64 float64 instructions for every 12
// shared-memory loads, and its tiles of all walkers fill the card; it also
// streams the trailing triangle through HBM once a panel.  The panel
// factor is NB / R of the work but a chain of R dependent columns a chunk
// of walkers, each a sqrt, a division and a barrier: the larger the chunk,
// the fewer chains (tools/torch_chol_probe.py times the blockings).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FT = 32;         // formation tile edge
// the blocking (tools/torch_chol_probe.py --variants times others)
constexpr int NB = 64;         // panel width
constexpr int RB = 128;        // panel rows a CTA below the diagonal block
constexpr int PT = NB + RB;    // panel CTA threads, one a row
constexpr int TILE = 64;       // trailing tile edge
constexpr int TM = 8;          // a thread's rows of the tile
constexpr int TN = 4;          // a thread's columns of the tile
constexpr int TX = TILE / TM;  // threads along the tile's rows
constexpr int TY = TILE / TN;
constexpr int TT = TX * TY;    // trailing CTA threads
constexpr int KC = 32;         // panel columns staged at a time
constexpr int ST = 256;        // sum CTA threads

__device__ __forceinline__ double sqrt_phi(int r, int two_m, double la,
                                           double g, const double* freqs,
                                           double scale, double ln10,
                                           double lnfyr) {
  const int k = (r % two_m) >> 1;
  const double amp = exp(la * ln10);
  const double phi = (((amp * amp) * scale) * exp((g - 3.0) * lnfyr))
                     * exp((-g) * log(freqs[k]));
  return sqrt(phi);
}

__global__ void __launch_bounds__(FT * 8)
hd_cross_form(const double* __restrict__ G, const double* __restrict__ u,
              const double* __restrict__ log10_A,
              const double* __restrict__ gamma,
              const double* __restrict__ freqs, int R, int m, double scale,
              double ln10, double lnfyr, double* __restrict__ W) {
  __shared__ double tile[FT][FT + 1];
  __shared__ double dr[FT], dc[FT];
  const int ntc = (R + FT - 1) / FT;
  const int ti = blockIdx.x / ntc, tj = blockIdx.x % ntc;
  if (tj > ti) return;
  const int b = blockIdx.y, tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = ti * FT, j0 = tj * FT, two_m = 2 * m;
  const long LD = (long)R + 1;
  double* w = W + (long)b * R * LD;
  const double la = log10_A[b], g = gamma[b];
  // d of the tile's rows (ty 0) and columns (ty 1)
  const int di = (ty == 0 ? i0 : j0) + tx;
  if (ty < 2 && di < R)
    (ty == 0 ? dr : dc)[tx] =
        sqrt_phi(di, two_m, la, g, freqs, scale, ln10, lnfyr);
  for (int r = ty; r < FT; r += 8) {
    const int i = i0 + r, j = j0 + tx;
    tile[r][tx] = (i < R && j < R) ? G[(long)i * R + j] : 0.0;
  }
  __syncthreads();
  for (int c = ty; c < FT; c += 8) {
    const int j = j0 + c, i = i0 + tx;
    if (j >= R || i > R || i < j) continue;
    w[(long)j * LD + i] = i < R
        ? (dr[tx] * tile[tx][c]) * dc[c] + (i == j ? 1.0 : 0.0)
        : dc[c] * u[j];
  }
}

// The panel [k0, k0 + nbw): thread t < NB holds the diagonal block's row
// k0 + t, thread NB + q the row r0 + q below it (r0 = k0 + nbw + RB
// blockIdx.x), its panel entries in registers, x[0] the current column's
// and x[l] column jj + l's, shifted along after each column so that one
// column's code (not unrolled over the columns) serves them all.  Per
// column jj: every thread takes the pivot sqrt(L_jj) published before the
// last barrier and divides its entry; the diagonal block's rows publish
// theirs (column jj, double-buffered), and row jj + 1 its next diagonal
// entry, already updated by its own product; a row below stores its
// finished entry; a barrier; each row's later panel entries take their
// product.  One barrier a column.
__global__ void __launch_bounds__(PT)
hd_cross_panel(double* __restrict__ W, double* __restrict__ piv_out, int R,
               int k0, int nbw, double* __restrict__ diag_out) {
  __shared__ double cj[2][NB];  // column jj of the diagonal block, divided
  __shared__ double pd[2];      // the next pivot's entry
  const int t = threadIdx.x, b = blockIdx.y;
  const long LD = (long)R + 1;
  double* w = W + (long)b * R * LD;
  const bool diag = t < NB;
  const int row = diag ? k0 + t : k0 + nbw + RB * blockIdx.x + t - NB;
  const bool live = diag ? t < nbw : row <= R;
  double x[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c)
    x[c] = (live && c < nbw && (!diag || c <= t))
        ? w[(long)(k0 + c) * LD + row] : 0.0;
  if (t == 0) pd[0] = x[0];
  __syncthreads();
  for (int jj = 0; jj < nbw; ++jj) {
    const double piv = sqrt(pd[jj & 1]);
    const int rel = t - jj;
    const bool below = live && (!diag || rel > 0);
    if (below) x[0] = x[0] / piv;
    if (diag && below) {
      cj[jj & 1][t] = x[0];
      if (diag_out != nullptr && blockIdx.x == 0)
        diag_out[((long)b * R + row) * NB + jj] = x[0];
      if (rel == 1) {
        x[1] = x[1] - x[0] * x[0];
        pd[(jj + 1) & 1] = x[1];
      }
    }
    if (t == 0 && blockIdx.x == 0) piv_out[(long)b * R + k0 + jj] = piv;
    if (!diag && live) w[(long)(k0 + jj) * LD + row] = x[0];
    __syncthreads();
    if (below) {
#pragma unroll
      for (int l = 1; l < NB; ++l)
        if (jj + l < nbw && (!diag || (l <= rel && !(l == 1 && rel == 1))))
          x[l] = x[l] - x[0] * cj[jj & 1][jj + l];
    }
#pragma unroll
    for (int l = 0; l < NB - 1; ++l) x[l] = x[l + 1];
  }
}

// The trailing lower triangle after the panel [k0, k1): rows k1..R,
// columns k1..R-1, each entry minus L_ik L_lk for k = k0..k1-1 in turn.
// Thread (tx, ty) holds rows i0 + tx + TX a and columns l0 + ty + TY c.
__global__ void __launch_bounds__(TT)
hd_cross_trail(double* __restrict__ W, int R, int k0, int k1) {
  __shared__ double Li[KC][TILE], Ll[KC][TILE];
  const int ntc = (R - k1 + TILE - 1) / TILE;
  const int ti = blockIdx.x / ntc, tl = blockIdx.x % ntc;
  if (tl > ti) return;
  const int b = blockIdx.y, t = threadIdx.x, tx = t % TX, ty = t / TX;
  const long LD = (long)R + 1;
  double* w = W + (long)b * R * LD;
  const int i0 = k1 + ti * TILE, l0 = k1 + tl * TILE;
  auto in = [&](int i, int l) { return i <= R && l < R && i >= l; };
  double acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int i = i0 + tx + TX * a, l = l0 + ty + TY * c;
      acc[a][c] = in(i, l) ? w[(long)l * LD + i] : 0.0;
    }
  for (int kc = k0; kc < k1; kc += KC) {
    const int kn = min(KC, k1 - kc);
    __syncthreads();
    for (int e = t; e < KC * TILE; e += TT) {
      const int kk = e / TILE, r = e % TILE;
      const double* col = w + (long)(kc + kk) * LD;
      Li[kk][r] = (kk < kn && i0 + r <= R) ? col[i0 + r] : 0.0;
      Ll[kk][r] = (kk < kn && l0 + r < R) ? col[l0 + r] : 0.0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      double li[TM], ll[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) li[a] = Li[kk][tx + TX * a];
#pragma unroll
      for (int c = 0; c < TN; ++c) ll[c] = Ll[kk][ty + TY * c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[a][c] = acc[a][c] - li[a] * ll[c];
    }
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int i = i0 + tx + TX * a, l = l0 + ty + TY * c;
      if (in(i, l)) w[(long)l * LD + i] = acc[a][c];
    }
}

__global__ void __launch_bounds__(ST)
hd_cross_sum(const double* __restrict__ W, const double* __restrict__ piv,
             int R, double* __restrict__ out) {
  __shared__ double lg[ST * 4], zz[ST * 4];
  const int t = threadIdx.x, b = blockIdx.x;
  const long LD = (long)R + 1;
  const double* w = W + (long)b * R * LD;
  double acc_log = 0.0, acc_zz = 0.0;
  for (int j0 = 0; j0 < R; j0 += ST * 4) {
    const int n = min(ST * 4, R - j0);
    for (int q = t; q < n; q += ST) {
      const double z = w[(long)(j0 + q) * LD + R];
      lg[q] = log(piv[(long)b * R + j0 + q]);
      zz[q] = z * z;
    }
    __syncthreads();
    if (t == 0)
      for (int q = 0; q < n; ++q) {
        acc_log = acc_log + lg[q];
        acc_zz = acc_zz + zz[q];
      }
    __syncthreads();
  }
  if (t == 0) out[b] = 0.5 * acc_zz - acc_log;
}


// ---- K12 hd_cross_grad: the backward of the cross term -------------------
// d out / d theta = sum_k e_k (w_k^2 + (M^-1)_kk - 1), w = M^-1 v = L^-T z,
// e_k = d log d_k / d theta: ln 10 for log10_A, 0.5 (ln fyr - ln f_j(k))
// for gamma.  It runs in the same launch sequence as the value, on the
// factor the value was read from (jax.value_and_grad's shape): K10's form,
// panel and trailing kernels with the diagonal blocks' L entries kept in
// DL (B, R, NB), hd_cross_sum for the value, then X = L^-1 in the
// workspace's upper triangle, X[i][k] (i > k) at W[i (R + 1) + k] and
// X[k][k] in the diagonal slot, which the factor leaves free (L_kk is the
// pivot).  Every entry X[i][k] = (delta_ik - sum_{j<i} L_ij X_jk) / L_ii,
// its products rounded alone and subtracted in ascending j, then divided:
//   hd_cross_inv_left  one launch a row block [i0, i0 + NB) (left-looking),
//                      grid (64-column tiles of columns 0..i0 + NB) x
//                      walkers, 128 threads: the tile's entries stay in an
//                      8 x 4 register tile a thread while every earlier row
//                      j in [c0, i0) streams through a two-stage cp.async
//                      ring in shared memory (L's column j below the block
//                      and X's row j, both contiguous in the workspace's
//                      column j), one rounded product subtracted at a time
//                      in ascending j; then the tile goes to shared
//                      memory, one thread a column takes its NB rows into
//                      registers, and the in-block triangle (the diagonal
//                      block of L staged in the same shared memory) and
//                      the divisions by the pivots finish each entry, which
//                      is written once;
//   hd_cross_colsum    one thread a column: s_k = sum_i X_ik^2, wz_k =
//                      sum_i X_ik z_i (= w_k) in ascending i, then c_k =
//                      (wz_k wz_k + s_k) - 1;
//   hd_cross_bins      one CTA a walker: c summed into the m frequency
//                      bins in ascending k, then the two sums over the
//                      bins in ascending j (log10_A's times ln 10 last).
// What bounds it: the R^3 / 6 multiply-subtracts of the inverse and the
// factor's R^3 / 6 again, each a float64 multiply and a subtract on the
// CUDA cores (no DMMA: a fused multiply-add would change the bits that
// hold the kernel to its plain version).  The inverse reads L's and X's
// earlier rows once a row block (R / NB times) and writes X once.
constexpr int KS = 16;         // rows j a stage of the inverse's ring
constexpr int IT = 128;        // inverse CTA threads
constexpr int ITC = 64;        // the inverse's column tile, one column a
                               // thread in the in-block phase
constexpr int IM = 8;          // a thread's rows of the register tile
constexpr int IX = NB / IM;    // threads along the tile's rows
constexpr int IN = ITC * IX / IT;  // a thread's columns of the register tile
static_assert(IN * IT == ITC * IX && ITC <= IT, "the register tile");
constexpr int IRING = 2 * KS * (NB + ITC);     // the ring's doubles
constexpr int ISQ = NB * ((ITC > NB ? ITC : NB) + 1);  // the tile's, L's
constexpr int INV_SMEM = 8 * (IRING > ISQ ? IRING : ISQ);

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

// Rows [i0, i0 + nbw) of X, columns c0..c0 + ITC - 1 (c0 = ITC
// blockIdx.x, up to the block's last row).  Thread (tx, ty) of the
// register tile holds rows i0 + tx + IX a and columns c0 + ty + (ITC / IN)
// c; in the in-block phase thread t < ITC holds column c0 + t.  Dynamic
// shared memory of INV_SMEM bytes (hd_cross_lnlike_init raises the limit
// where it passes 48 KB).
__global__ void __launch_bounds__(IT)
hd_cross_inv_left(double* __restrict__ W, const double* __restrict__ piv,
                  const double* __restrict__ DL, int R, int i0, int nbw) {
  // the ring: stage s holds L's rows [jj][r] (NB) then X's [jj][c] (ITC);
  // after it, the tile's rows S[l][c] (NB x (ITC + 1)) and then the
  // diagonal block of L, Ld[l][jj] (NB x (NB + 1)), in the same memory
  extern __shared__ __align__(16) double sm[];
  __shared__ double pv[NB];
  constexpr int CY = ITC / IN;
  const int t = threadIdx.x, b = blockIdx.y, tx = t % IX, ty = t / IX;
  const int c0 = blockIdx.x * ITC;
  const long LD = (long)R + 1;
  double* w = W + (long)b * R * LD;
  for (int l = t; l < NB; l += IT)
    pv[l] = l < nbw ? piv[(long)b * R + i0 + l] : 1.0;
  double acc[IM][IN];
#pragma unroll
  for (int a = 0; a < IM; ++a)
#pragma unroll
    for (int c = 0; c < IN; ++c) acc[a][c] = 0.0;
  // stage the rows [jc, jc + KS) of L (below the block) and X (this tile),
  // both contiguous in the workspace's column j
  auto stage = [&](int buf, int jc) {
    double* Li = sm + buf * KS * (NB + ITC);
    double* Xj = Li + KS * NB;
    for (int e = t; e < KS * NB; e += IT) {
      const int jj = e / NB, r = e % NB, j = jc + jj;
      const bool on = j < i0 && r < nbw;
      cp_async8(Li + e, on ? w + (long)j * LD + i0 + r : w, on);
    }
    for (int e = t; e < KS * ITC; e += IT) {
      const int jj = e / ITC, r = e % ITC, j = jc + jj;
      const bool on = j < i0 && c0 + r <= j;
      cp_async8(Xj + e, on ? w + (long)j * LD + c0 + r : w, on);
    }
    cp_async_commit();
  };
  if (c0 < i0) stage(0, c0);
  for (int jc = c0, s = 0; jc < i0; jc += KS, ++s) {
    if (jc + KS < i0) {
      stage((s + 1) & 1, jc + KS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const double* Li = sm + (s & 1) * KS * (NB + ITC);
    const double* Xj = Li + KS * NB;
    const int kn = min(KS, i0 - jc);
#pragma unroll 2
    for (int jj = 0; jj < kn; ++jj) {
      double li[IM], xk[IN];
#pragma unroll
      for (int a = 0; a < IM; ++a) li[a] = Li[jj * NB + tx + IX * a];
#pragma unroll
      for (int c = 0; c < IN; ++c) xk[c] = Xj[jj * ITC + ty + CY * c];
#pragma unroll
      for (int a = 0; a < IM; ++a)
#pragma unroll
        for (int c = 0; c < IN; ++c) acc[a][c] = acc[a][c] - li[a] * xk[c];
    }
    __syncthreads();
  }
  // the tile to shared memory, then one column a thread
#pragma unroll
  for (int a = 0; a < IM; ++a)
#pragma unroll
    for (int c = 0; c < IN; ++c)
      sm[(tx + IX * a) * (ITC + 1) + ty + CY * c] = acc[a][c];
  __syncthreads();
  const int k = c0 + t;
  const bool own = t < ITC && k < i0 + nbw;
  // x[l] holds row i0 + l of column k
  double x[NB];
#pragma unroll
  for (int l = 0; l < NB; ++l) {
    const int row = i0 + l;
    x[l] = (!own || l >= nbw) ? 0.0
        : row == k ? 1.0 : (k < row ? sm[l * (ITC + 1) + t] : 0.0);
  }
  __syncthreads();
  for (int e = t; e < NB * NB; e += IT) {
    const int l = e / NB, jj = e % NB;
    sm[l * (NB + 1) + jj] = (l < nbw && jj < l)
        ? DL[((long)b * R + i0 + l) * NB + jj] : 0.0;
  }
  __syncthreads();
  if (!own) return;
  if (nbw == NB) {
    // a whole block: every index known, so x stays in registers unmoved
#pragma unroll
    for (int jj = 0; jj < NB; ++jj) {
      x[jj] = x[jj] / pv[jj];
      if (i0 + jj >= k) w[(long)(i0 + jj) * LD + k] = x[jj];
#pragma unroll
      for (int l = jj + 1; l < NB; ++l)
        x[l] = x[l] - sm[l * (NB + 1) + jj] * x[jj];
    }
    return;
  }
  // the last, partial block: row jj + l in x[l], shifted along after each
  for (int jj = 0; jj < nbw; ++jj) {
    const int i = i0 + jj;
    x[0] = x[0] / pv[jj];
    if (i >= k) w[(long)i * LD + k] = x[0];
#pragma unroll
    for (int l = 1; l < NB; ++l)
      if (jj + l < nbw) x[l] = x[l] - sm[(jj + l) * (NB + 1) + jj] * x[0];
#pragma unroll
    for (int l = 0; l < NB - 1; ++l) x[l] = x[l + 1];
  }
}

__global__ void __launch_bounds__(ST)
hd_cross_colsum(const double* __restrict__ W, int R, double* __restrict__ cb) {
  const int b = blockIdx.y, k = blockIdx.x * ST + threadIdx.x;
  if (k >= R) return;
  const long LD = (long)R + 1;
  const double* w = W + (long)b * R * LD;
  double s = 0.0, wz = 0.0;
  for (int i = k; i < R; ++i) {
    const double x = w[(long)i * LD + k];
    s = s + x * x;
    wz = wz + x * w[(long)i * LD + R];
  }
  cb[(long)b * R + k] = (wz * wz + s) - 1.0;
}

constexpr int BT = 128;        // bins CTA threads, one a bin (m <= BT)

__global__ void __launch_bounds__(BT)
hd_cross_bins(const double* __restrict__ cb, const double* __restrict__ eg,
              int R, int m, double ln10, double* __restrict__ out) {
  __shared__ double S[BT];
  const int b = blockIdx.x, j = threadIdx.x, two_m = 2 * m;
  const double* c = cb + (long)b * R;
  if (j < m) {
    double acc = 0.0;
    for (int a = 0; a < R / two_m; ++a) {
      acc = acc + c[a * two_m + 2 * j];
      acc = acc + c[a * two_m + 2 * j + 1];
    }
    S[j] = acc;
  }
  __syncthreads();
  if (j == 0) {
    double ga = 0.0, gg = 0.0;
    for (int q = 0; q < m; ++q) {
      ga = ga + S[q];
      gg = gg + eg[q] * S[q];
    }
    out[2 * b] = ga * ln10;
    out[2 * b + 1] = gg;
  }
}

// The factor of one chunk: M and v formed, then per panel its factor and
// the trailing update (diag_out: the diagonal blocks' L entries, or null).
cudaError_t factor(const double* G, const double* u, const double* log10_A,
                   const double* gamma, const double* freqs, int B, int R,
                   int m, double scale, double ln10, double lnfyr,
                   double* workspace, double* pivots, double* diag_out,
                   int* counts, cudaStream_t st) {
  cudaError_t e;
  const int nf = (R + 1 + FT - 1) / FT, nfc = (R + FT - 1) / FT;
  hd_cross_form<<<dim3(nf * nfc, B), dim3(FT, 8), 0, st>>>(
      G, u, log10_A, gamma, freqs, R, m, scale, ln10, lnfyr, workspace);
  ++counts[0];
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int k0 = 0; k0 < R; k0 += NB) {
    const int nbw = R - k0 < NB ? R - k0 : NB, k1 = k0 + nbw;
    const int nrb = (R + 1 - k1 + RB - 1) / RB;
    hd_cross_panel<<<dim3(nrb, B), PT, 0, st>>>(workspace, pivots, R, k0,
                                                nbw, diag_out);
    ++counts[1];
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (k1 == R) break;
    const int ntr = (R + 1 - k1 + TILE - 1) / TILE;
    const int ntc = (R - k1 + TILE - 1) / TILE;
    hd_cross_trail<<<dim3(ntr * ntc, B), TT, 0, st>>>(workspace, R, k0, k1);
    ++counts[2];
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// One chunk of B walkers: G (R, R) row-major, u (R,), log10_A and gamma
// (B,), freqs (m,) with R a multiple of 2 m; workspace (B, R, R + 1),
// pivots (B, R), out (B,).  scale = 1 / (12 pi^2 Tspan), ln10 = log(10),
// lnfyr = log(1 / yr in Hz), from the caller.  counts[0..3] += the
// launches of hd_cross_form, _panel, _trail and _sum.
extern "C" int hd_cross_lnlike_launch(const double* G, const double* u,
                                      const double* log10_A,
                                      const double* gamma,
                                      const double* freqs, int B, int R,
                                      int m, double scale, double ln10,
                                      double lnfyr, double* workspace,
                                      double* pivots, double* out,
                                      int* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || B > 65535 || R <= 0 || m <= 0 || R % (2 * m) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = factor(G, u, log10_A, gamma, freqs, B, R, m, scale, ln10,
                         lnfyr, workspace, pivots, nullptr, counts, st);
  if (e != cudaSuccess) return (int)e;
  hd_cross_sum<<<B, ST, 0, st>>>(workspace, pivots, R, out);
  ++counts[3];
  return (int)cudaGetLastError();
}

// K10 and K12 on one chunk of B walkers from one factor: the inputs and
// workspace as above, diag (B, R, NB) and cb (B, R) scratch, eg (m,)
// gamma's e per bin, 0.5 (lnfyr - log f_j); value (B,) the cross terms
// (K10's bitwise: the same kernels on the same inputs) and grad (B, 2)
// d value_b / d (log10_A_b, gamma_b).  counts[0..6] += the launches of
// hd_cross_form, _panel, _trail, _sum, _inv_left, _colsum and _bins.
extern "C" int hd_cross_value_and_grad_launch(
    const double* G, const double* u, const double* log10_A,
    const double* gamma, const double* freqs, const double* eg, int B, int R,
    int m, double scale, double ln10, double lnfyr, double* workspace,
    double* pivots, double* diag, double* cb, double* value, double* grad,
    int* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || B > 65535 || R <= 0 || m <= 0 || m > BT || R % (2 * m) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = factor(G, u, log10_A, gamma, freqs, B, R, m, scale, ln10,
                         lnfyr, workspace, pivots, diag, counts, st);
  if (e != cudaSuccess) return (int)e;
  hd_cross_sum<<<B, ST, 0, st>>>(workspace, pivots, R, value);
  ++counts[3];
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int i0 = 0; i0 < R; i0 += NB) {
    const int nbw = R - i0 < NB ? R - i0 : NB;
    hd_cross_inv_left<<<dim3((i0 + nbw + ITC - 1) / ITC, B), IT, INV_SMEM,
                        st>>>(workspace, pivots, diag, R, i0, nbw);
    ++counts[4];
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  hd_cross_colsum<<<dim3((R + ST - 1) / ST, B), ST, 0, st>>>(workspace, R,
                                                            cb);
  ++counts[5];
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  hd_cross_bins<<<B, BT, 0, st>>>(cb, eg, R, m, ln10, grad);
  ++counts[6];
  return (int)cudaGetLastError();
}

// Once a process, before the first launch (and outside any CUDA-graph
// capture): the inverse's dynamic shared memory above 48 KB.
extern "C" int hd_cross_lnlike_init() {
  return (int)cudaFuncSetAttribute(
      hd_cross_inv_left, cudaFuncAttributeMaxDynamicSharedMemorySize,
      INV_SMEM);
}

extern "C" const char* hd_cross_lnlike_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
