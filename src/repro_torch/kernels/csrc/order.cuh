// MIN and MAX in the reference's order, shared by the port's CUDA sources
// (kernels/rmw/csrc/rmw.cu, kernels/serial/csrc/serial.cu).
//
// Integers order as they are.  fp32 follows core/rmw.py's `order_key`: −0
// below +0, and a NaN wins and stays.  A float's key is its bits with the
// magnitude bits of a negative value flipped, so signed int order is float
// order with −0 just below +0; every NaN keys past all numbers in the op's
// direction.  The result comes back from the winning key, so these give the
// plain versions' bits, NaN included.

#pragma once

#include <climits>

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) { return b > a ? b : a; }

__device__ __forceinline__ bool is_nan_bits(unsigned b) {
  return (b & 0x7fffffffu) > 0x7f800000u;
}
__device__ __forceinline__ int order_key(float x, bool nan_low) {
  const int k = __float_as_int(x);
  if (is_nan_bits((unsigned)k)) return nan_low ? INT_MIN : INT_MAX;
  return k ^ ((k >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}
__device__ __forceinline__ float min_of(float a, float b) {
  return from_order_key(min(order_key(a, true), order_key(b, true)));
}
__device__ __forceinline__ float max_of(float a, float b) {
  return from_order_key(max(order_key(a, false), order_key(b, false)));
}
