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

// One aligned load of U: through the read-only cache, or streamed past L2
// (ld.global.cs) where STREAM, for data read once
template <bool STREAM, typename U>
__device__ __forceinline__ U load_unit(const U* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return __ldg(p);
}

// One aligned store of U: plain, or streamed past L2 (st.global.cs)
template <bool STREAM, typename U>
__device__ __forceinline__ void store_unit(U* p, U v) {
  if constexpr (STREAM) __stcs(p, v);
  else *p = v;
}

// `BYTES` (2, 4, 8 or 16) bytes at p, aligned to BYTES, by one load, as
// 32-bit words (2 bytes fill the low half of one)
template <int BYTES, bool STREAM = false>
__device__ __forceinline__ void load_words(const void* p, unsigned* w) {
  if constexpr (BYTES == 16) {
    const uint4 v = load_unit<STREAM>(static_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (BYTES == 8) {
    const uint2 v = load_unit<STREAM>(static_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (BYTES == 4) {
    w[0] = load_unit<STREAM>(static_cast<const unsigned*>(p));
  } else {
    static_assert(BYTES == 2, "2, 4, 8 or 16 bytes");
    w[0] = load_unit<STREAM>(static_cast<const unsigned short*>(p));
  }
}

// the words of load_words back to `BYTES` bytes at p by one store
template <int BYTES, bool STREAM = false>
__device__ __forceinline__ void store_words(void* p, const unsigned* w) {
  if constexpr (BYTES == 16) {
    store_unit<STREAM>(static_cast<uint4*>(p), make_uint4(w[0], w[1], w[2],
                                                          w[3]));
  } else if constexpr (BYTES == 8) {
    store_unit<STREAM>(static_cast<uint2*>(p), make_uint2(w[0], w[1]));
  } else if constexpr (BYTES == 4) {
    store_unit<STREAM>(static_cast<unsigned*>(p), w[0]);
  } else {
    static_assert(BYTES == 2, "2, 4, 8 or 16 bytes");
    store_unit<STREAM>(static_cast<unsigned short*>(p),
                       static_cast<unsigned short>(w[0]));
  }
}

// 32-bit words that V elements of T fill (a lone bf16 takes the low half
// of one)
template <typename T, int V>
__host__ __device__ constexpr int words_of() {
  return V * (int)sizeof(T) >= 4 ? V * (int)sizeof(T) / 4 : 1;
}

// cvt.rna.tf32.f32 (nearest, ties away from zero) on finite x, in two
// integer instructions: ptxas expands the cvt with NaN/Inf checks into
// about five
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both tf32, for 3xTF32 products (small*small dropped by
// the caller)
struct Split {
  unsigned big, small;
};

__device__ __forceinline__ Split split(float x) {
  const unsigned big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// Make `device` current for an entry point's launch: cudaSetDevice only
// where another device is current (as PyTorch's c10::cuda::SetDevice
// does), so a call on the current device costs one cudaGetDevice.
inline cudaError_t use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

inline unsigned int blocks_for(long long total, int threads) {
  return static_cast<unsigned int>((total + threads - 1) / threads);
}

}  // namespace e2fgvi
