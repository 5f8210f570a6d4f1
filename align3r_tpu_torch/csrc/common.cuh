// Shared helpers for the align3r_tpu_torch Hopper kernels.
//
// Every kernel is reached through a plain C entry point (extern "C") that
// launches on the caller's stream and returns cudaGetLastError(), so the
// Python wrapper (ops/_lib.py, loaded with ctypes) can raise on a refused
// launch. Kernels allocate nothing: the wrapper passes outputs and scratch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define A3R_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf16r(float x) {
  // round to bf16 and back: the rounding point of a bf16 op in the reference
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
