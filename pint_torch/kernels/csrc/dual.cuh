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

// ---- elementary functions (double and Dual overloads) --------------------
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ double datan2(double y, double x) { return atan2(y, x); }

template <int K>
__device__ __forceinline__ Dual<K> dsin(const Dual<K>& a) {
  Dual<K> r;
  r.v = sin(a.v);
  const double c = cos(a.v);
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * c;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> dcos(const Dual<K>& a) {
  Dual<K> r;
  r.v = cos(a.v);
  const double s = -sin(a.v);
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * s;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> dsqrt(const Dual<K>& a) {
  Dual<K> r;
  r.v = sqrt(a.v);
  const double h = 0.5 / r.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] * h;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> dlog(const Dual<K>& a) {
  Dual<K> r;
  r.v = log(a.v);
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = a.d[i] / a.v;
  return r;
}
template <int K>
__device__ __forceinline__ Dual<K> datan2(const Dual<K>& y, const Dual<K>& x) {
  Dual<K> r;
  r.v = atan2(y.v, x.v);
  const double den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int i = 0; i < K; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}

// clip to [lo, hi] that keeps NaN (fmin/fmax would drop it): a NaN input
// fails both comparisons and passes through with its tangent
__device__ __forceinline__ double dclip(double x, double lo, double hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
template <int K>
__device__ __forceinline__ Dual<K> dclip(const Dual<K>& a, double lo, double hi) {
  if (a.v < lo) return dconst<K>(lo);
  if (a.v > hi) return dconst<K>(hi);
  return a;
}

// round half to even, like jnp.round / torch.round (CUDA round() rounds
// half away from zero)
__device__ __forceinline__ double rne(double x) { return rint(x); }
