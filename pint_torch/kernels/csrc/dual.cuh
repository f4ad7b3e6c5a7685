// Forward-mode dual numbers for the port's hand kernels.
//
// A kernel's arithmetic is written once as a template over its number type
// T and instantiated twice: with `double` for the primal alone, and with
// `Dual<K>` when the caller asks for the local partials with respect to
// the kernel's own K inputs.  The derivative rules below are the ones the
// plain PyTorch twin applies (pint_torch/kernels/dual.py) -- the same
// formulas in the same operand order -- so kernel and twin agree to
// rounding, and both follow the chain rule JAX's forward mode applies to
// the reference functions.
//
// Every source that includes this header is compiled with -fmad=false: the
// double-double and folded-product arithmetic assumes each product is
// rounded on its own.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

template <int K>
struct Dual {
  double v;
  double d[K];
};

template <int K>
__device__ __forceinline__ Dual<K> dconst(double x) {
  Dual<K> r;
  r.v = x;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = 0.0;
  return r;
}

// x seeded as the i-th independent variable
template <int K>
__device__ __forceinline__ Dual<K> dvar(double x, int i) {
  Dual<K> r = dconst<K>(x);
  r.d[i] = 1.0;
  return r;
}

// a constant of the kernel's number type T
template <typename T>
struct Lift {
  __device__ static T of(double x);
};
template <>
struct Lift<double> {
  __device__ static double of(double x) { return x; }
};
template <int K>
struct Lift<Dual<K>> {
  __device__ static Dual<K> of(double x) { return dconst<K>(x); }
};

__device__ __forceinline__ double val(double x) { return x; }
template <int K>
__device__ __forceinline__ double val(const Dual<K>& x) { return x.v; }

// ---- arithmetic -----------------------------------------------------------
template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator+(const Dual<K>& a, double b) {
  Dual<K> r = a;
  r.v = a.v + b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator+(double a, const Dual<K>& b) {
  Dual<K> r = b;
  r.v = a + b.v;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a) {
  Dual<K> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = -a.d[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(const Dual<K>& a, double b) {
  Dual<K> r = a;
  r.v = a.v - b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator-(double a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = -b.d[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator*(const Dual<K>& a, double b) {
  Dual<K> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator*(double a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a * b.d[i];
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator/(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator/(const Dual<K>& a, double b) {
  Dual<K> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] / b;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> operator/(double a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = (-(r.v * b.d[i])) / b.v;
  return r;
}

// round half to even, like jnp.round / torch.round (CUDA round() rounds
// half away from zero)
__device__ __forceinline__ double rne(double x) { return rint(x); }
