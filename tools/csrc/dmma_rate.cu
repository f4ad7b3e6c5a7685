// The float64 tensor-core products a Hopper card offers to mma.sync, for
// choosing K11's instruction: m8n8k4 (sm_80 and later) and m16n8k4, m16n8k8,
// m16n8k16 (sm_90).  dmma_check_launch: one warp multiplies a 16 x 16 A by
// a 16 x 8 B (row-major, float64) in k-steps of the shape's depth, reading
// and writing the fragments by the layouts K11 assumes, so the caller can
// hold D against A @ B.  dmma_rate_launch: every warp of `blocks` CTAs of
// 256 threads issues `iters` rounds of 8 independent products on register
// fragments; the caller times it and counts 2 m n k flops a product.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma884(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}
__device__ __forceinline__ void mma1684(double (&d)[4], const double (&a)[2],
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}
__device__ __forceinline__ void mma1688(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma16816(double (&d)[4], const double (&a)[8],
                                         const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A (16 x 16), B (16 x 8), D (16 x 8) row-major; g = lane / 4, t = lane % 4.
// m16n8kK: a_i row g + 8 (i % 2), column t + 4 (i / 2); b_i row t + 4 i,
// column g; d_i row g + 8 (i / 2), column 2 t + i % 2.  m8n8k4: rows 0..7
// only (the rows 8..15 of D come from a second product).
__global__ void dmma_check(int shape, const double* A, const double* B,
                           double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  if (shape == 884) {
    for (int h = 0; h < 2; ++h) {
      double d[2] = {0.0, 0.0};
      for (int k0 = 0; k0 < 16; k0 += 4)
        mma884(d, A[(8 * h + g) * 16 + k0 + t], B[(k0 + t) * 8 + g]);
      D[(8 * h + g) * 8 + 2 * t] = d[0];
      D[(8 * h + g) * 8 + 2 * t + 1] = d[1];
    }
    return;
  }
  double d[4] = {0.0, 0.0, 0.0, 0.0};
  const int K = shape == 1684 ? 4 : shape == 1688 ? 8 : 16;
  for (int k0 = 0; k0 < 16; k0 += K) {
    double a[8], b[4];
    for (int i = 0; i < K / 2; ++i)
      a[i] = A[(g + 8 * (i % 2)) * 16 + k0 + t + 4 * (i / 2)];
    for (int i = 0; i < K / 4; ++i) b[i] = B[(k0 + t + 4 * i) * 8 + g];
    if (shape == 1684) {
      const double aa[2] = {a[0], a[1]};
      mma1684(d, aa, b[0]);
    } else if (shape == 1688) {
      const double aa[4] = {a[0], a[1], a[2], a[3]};
      const double bb[2] = {b[0], b[1]};
      mma1688(d, aa, bb);
    } else {
      const double aa[8] = {a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]};
      const double bb[4] = {b[0], b[1], b[2], b[3]};
      mma16816(d, aa, bb);
    }
  }
  for (int i = 0; i < 4; ++i)
    D[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = d[i];
}

template <int SHAPE>
__global__ void __launch_bounds__(256) dmma_rate(int iters, double* out) {
  const double x = 1.0 + 1e-3 * threadIdx.x;
  double acc[8][4];
  for (int q = 0; q < 8; ++q)
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.0;
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = x + i;
  for (int i = 0; i < 4; ++i) b[i] = x - i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if constexpr (SHAPE == 884) {
        double d[2] = {acc[q][0], acc[q][1]};
        mma884(d, a[0], b[0]);
        acc[q][0] = d[0];
        acc[q][1] = d[1];
      } else if constexpr (SHAPE == 1684) {
        const double aa[2] = {a[0], a[1]};
        mma1684(acc[q], aa, b[0]);
      } else if constexpr (SHAPE == 1688) {
        const double aa[4] = {a[0], a[1], a[2], a[3]};
        const double bb[2] = {b[0], b[1]};
        mma1688(acc[q], aa, bb);
      } else {
        mma16816(acc[q], a, b);
      }
    }
  }
  double s = 0.0;
  for (int q = 0; q < 8; ++q)
    for (int i = 0; i < 4; ++i) s = s + acc[q][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int dmma_check_launch(int shape, const double* A, const double* B,
                                 double* D) {
  dmma_check<<<1, 32>>>(shape, A, B, D);
  return (int)cudaGetLastError();
}

extern "C" int dmma_rate_launch(int shape, int blocks, int iters,
                                double* out) {
  if (shape == 884) dmma_rate<884><<<blocks, 256>>>(iters, out);
  else if (shape == 1684) dmma_rate<1684><<<blocks, 256>>>(iters, out);
  else if (shape == 1688) dmma_rate<1688><<<blocks, 256>>>(iters, out);
  else dmma_rate<16816><<<blocks, 256>>>(iters, out);
  return (int)cudaGetLastError();
}
