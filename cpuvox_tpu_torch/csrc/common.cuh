// Float helpers shared by the kernels.  They reproduce the reference's
// (XLA's) semantics where plain CUDA differs; see each helper.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace cpuvox {

// jnp.minimum/maximum and torch.minimum/amin propagate NaN; fminf/fmaxf
// drop it.  Axis-parallel rays make inf - inf = NaN in the DDA, so every
// min/max of the ported code goes through these.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

// f32 -> i32 as XLA converts: truncate toward zero, saturate, NaN -> 0.
// A C cast of an out-of-range float promises nothing, so range and NaN are
// settled explicitly; __float2int_rz is exact for the rest.
__device__ __forceinline__ int to_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x < -2147483648.0f) return INT_MIN;
  return __float2int_rz(x);
}

// int32 add that wraps like XLA's and torch's (signed overflow is UB in C).
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

}  // namespace cpuvox
