// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on its storage type (float or __nv_bfloat16)
// and computes in float32; these helpers convert at load and store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace e2fgvi {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

inline unsigned int blocks_for(long long total, int threads) {
  return static_cast<unsigned int>((total + threads - 1) / threads);
}

}  // namespace e2fgvi
