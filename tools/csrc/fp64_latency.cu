// Latency probes for tools/torch_chol_probe.py --micro: clock cycles per
// dependent float64 division, square root, multiply-subtract and per
// block barrier on the current GPU, built with the kernels' own flags
// (-fmad=false).  out[0..4] = cycles of n divisions, sqrts, multiply-
// subtracts, barriers (of the launch's threads) and adds; the caller
// times the launch for the SM clock.
#include <cuda_runtime.h>

namespace {

__global__ void latency(double a, double b, int n, double* sink,
                        long long* out) {
  double x = a;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = x / b + 1.0;
  long long t1 = clock64();
  double y = a;
  for (int i = 0; i < n; ++i) y = sqrt(y) + 1.0;
  long long t2 = clock64();
  double z = a;
  for (int i = 0; i < n; ++i) z = z - z * b;
  long long t3 = clock64();
  for (int i = 0; i < n; ++i) __syncthreads();
  long long t4 = clock64();
  double v = a;
  for (int i = 0; i < n; ++i) v = v + 1.0;
  long long t5 = clock64();
  if (threadIdx.x == 0) {
    sink[0] = x + y + z + v;
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t5 - t4;
  }
}

}  // namespace

extern "C" int fp64_latency_launch(int n, int threads, double* sink,
                                   long long* out) {
  latency<<<1, threads>>>(1.5, 1.0000001, n, sink, out);
  return (int)cudaDeviceSynchronize();
}
