// E1, E5, E6: the banded DCN sampler's inner-loop variants.
//
// Replaces the TPU experiment kernels scripts/exp_dcn_inner_r04.py
// (E5: base_kernel, bf16_kernel, cbatch_kernel, run at :54; E6:
// packed_kernel, run_packed at :246 and its base baseline at :272) and
// scripts/exp_dcn_pack.py (E1: _packed_kernel, _build_packed at :96). They
// all compute e2fgvi_tpu/kernels/dcn_band.py::_sampler_kernel's function
// (kernels/band_sampler.py states it): per output element, a band of
// candidate source rows weighted by relu(1 - |py - row|), each a two-corner
// linear interpolation along x, times the mask.
//
// On the TPU the band sweep exists because a lane gather is the only
// dynamic read: every row of the band is gathered and most get weight 0.
// Here a thread reads its own addresses, so it computes floor(py) and adds
// only the two rows that can have a nonzero weight, each gated by the band
// test. For finite inputs that equals the sweep (the skipped terms are
// exact zeros). What bounds these kernels on the H100: bytes. At the E5
// shape (224*9*16*64*128 = 264M bf16 outputs, 0.53 GB written, 2.1 GB of
// corner reads, mostly L2 hits) a kernel is a store-and-gather stream;
// threads run x fastest so the position, mask and output accesses are
// coalesced and neighbouring threads read neighbouring corners.
//
// The variants keep the TPU experiments' questions in CUDA terms:
//   band_sample          E5 base/bf16: one thread per output element;
//                        float32 or bfloat16 source (the gather width).
//   band_sample_cbatch   E5 cbatch: one thread per (i, t, y, x) computes
//                        the weights once and loops over the channels.
//   band_sample_xpair    E6: one 32-bit load per (channel, row) gives both
//                        x corners (src[x] << 16 | src[x+1]).
//   band_sample_cpair    E1: one 32-bit load per (corner, row) gives two
//                        channels (low half = channel 2c).
// All four sum in one fixed order with the rounding intrinsics (no FMA
// contraction), so xpair and cpair are bit-equal to band_sample on the same
// bfloat16 source, and the float32 sums equal the plain version's.
#include <cmath>

#include "common.cuh"

namespace e2fgvi {

// The two candidate rows of one output element: slab rows (-1 = outside
// the band) and the per-row weights of the x0 and x0+1 corners.
struct BandTaps {
  int row[2];
  float w0[2], w1[2];
  int x0;
};

__device__ __forceinline__ BandTaps band_taps(float py, float px, int y,
                                              int dy_lo, int band, int wp) {
  BandTaps b;
  const float x0f = fminf(fmaxf(floorf(px), 0.f), (float)(wp - 2));
  b.x0 = (int)x0f;
  const float wx0 = fmaxf(1.f - fabsf(px - x0f), 0.f);
  const float wx1 = fmaxf(1.f - fabsf(px - (x0f + 1.f)), 0.f);
  const float yr0 = floorf(py);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float yr = yr0 + (float)s;           // image row
    const float r = yr - (float)(y + dy_lo);   // its band index
    const bool ok = r >= 0.f && r < (float)band;
    const float wy = fmaxf(1.f - fabsf(py - yr), 0.f);
    b.row[s] = ok ? y + (int)r : -1;
    b.w0[s] = __fmul_rn(wy, wx0);
    b.w1[s] = __fmul_rn(wy, wx1);
  }
  return b;
}

// acc + (g0 * w0 + g1 * w1), rounded in that order
__device__ __forceinline__ float band_term(float acc, float g0, float g1,
                                           float w0, float w1) {
  return __fadd_rn(acc, __fadd_rn(__fmul_rn(g0, w0), __fmul_rn(g1, w1)));
}

template <typename TO>
__device__ __forceinline__ TO band_out(float acc, float m);
template <>
__device__ __forceinline__ float band_out<float>(float acc, float m) {
  return __fmul_rn(acc, m);
}
// bf16(acc) * bf16(mask): the product of two bf16 values is exact in f32,
// so one more rounding gives the correctly rounded bf16 product
template <>
__device__ __forceinline__ __nv_bfloat16 band_out<__nv_bfloat16>(float acc,
                                                                float m) {
  const float a = __bfloat162float(__float2bfloat16(acc));
  const float mb = __bfloat162float(__float2bfloat16(m));
  return __float2bfloat16(__fmul_rn(a, mb));
}

__device__ __forceinline__ float bf16_hi(unsigned g) {
  return __uint_as_float(g & 0xffff0000u);
}
__device__ __forceinline__ float bf16_lo(unsigned g) {
  return __uint_as_float(g << 16);
}

// ---------------------------------------------------------------------------
// E5 base / bf16: out (NG, K, CG, HP, WP), one thread per element, x fastest
// ---------------------------------------------------------------------------
template <typename TS, typename TO>
__global__ void __launch_bounds__(256)
band_sample_kernel(const TS* __restrict__ src, const float* __restrict__ py,
                   const float* __restrict__ px,
                   const float* __restrict__ mask, TO* __restrict__ out,
                   int NG, int K, int CG, int HP, int WP, int band,
                   int dy_lo) {
  const long long total = (long long)NG * K * CG * HP * WP;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int x = (int)(e % WP);
  long long r = e / WP;
  const int y = (int)(r % HP);
  r /= HP;
  const int c = (int)(r % CG);
  r /= CG;                                   // r = i*K + t
  const int i = (int)(r / K);
  const long long pos = (r * HP + y) * WP + x;
  const BandTaps b = band_taps(py[pos], px[pos], y, dy_lo, band, WP);
  const int HS = HP + band;
  const TS* s = src + ((long long)i * CG + c) * HS * WP;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (b.row[k] < 0) continue;
    const TS* p = s + (long long)b.row[k] * WP + b.x0;
    acc = band_term(acc, to_f32(p[0]), to_f32(p[1]), b.w0[k], b.w1[k]);
  }
  out[e] = band_out<TO>(acc, mask[pos]);
}

// ---------------------------------------------------------------------------
// E5 cbatch: one thread per (i, t, y, x), loop over CG; bf16(acc * mask)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
band_sample_cbatch_kernel(const T* __restrict__ src,
                          const float* __restrict__ py,
                          const float* __restrict__ px,
                          const float* __restrict__ mask,
                          T* __restrict__ out, int NG, int K, int CG, int HP,
                          int WP, int band, int dy_lo) {
  const long long total = (long long)NG * K * HP * WP;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int x = (int)(e % WP);
  long long r = e / WP;
  const int y = (int)(r % HP);
  r /= HP;                                   // r = i*K + t
  const int i = (int)(r / K);
  const BandTaps b = band_taps(py[e], px[e], y, dy_lo, band, WP);
  const float m = mask[e];
  const long long plane = (long long)(HP + band) * WP;
  const T* s = src + (long long)i * CG * plane;
  T* o = out + (r * CG * HP + y) * WP + x;
  for (int c = 0; c < CG; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (b.row[k] < 0) continue;
      const T* p = s + c * plane + (long long)b.row[k] * WP + b.x0;
      acc = band_term(acc, to_f32(p[0]), to_f32(p[1]), b.w0[k], b.w1[k]);
    }
    o[(long long)c * HP * WP] = from_f32<T>(__fmul_rn(acc, m));
  }
}

// ---------------------------------------------------------------------------
// E6 xpair: psrc word = src[x] << 16 | src[x+1]; bf16 output
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
band_sample_xpair_kernel(const unsigned* __restrict__ psrc,
                         const float* __restrict__ py,
                         const float* __restrict__ px,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, int NG, int K,
                         int CG, int HP, int WP, int band, int dy_lo) {
  const long long total = (long long)NG * K * CG * HP * WP;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int x = (int)(e % WP);
  long long r = e / WP;
  const int y = (int)(r % HP);
  r /= HP;
  const int c = (int)(r % CG);
  r /= CG;
  const int i = (int)(r / K);
  const long long pos = (r * HP + y) * WP + x;
  const BandTaps b = band_taps(py[pos], px[pos], y, dy_lo, band, WP);
  const int HS = HP + band;
  const unsigned* s = psrc + ((long long)i * CG + c) * HS * WP;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (b.row[k] < 0) continue;
    const unsigned g = s[(long long)b.row[k] * WP + b.x0];
    acc = band_term(acc, bf16_hi(g), bf16_lo(g), b.w0[k], b.w1[k]);
  }
  out[e] = band_out<__nv_bfloat16>(acc, mask[pos]);
}

// ---------------------------------------------------------------------------
// E1 cpair: psrc (NG, CG/2, HS, WP), word = channel 2c (low) | 2c+1 (high);
// one thread per (i, t, channel pair, y, x) writes both channels
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
band_sample_cpair_kernel(const unsigned* __restrict__ psrc,
                         const float* __restrict__ py,
                         const float* __restrict__ px,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, int NG, int K,
                         int CGP, int HP, int WP, int band, int dy_lo) {
  const long long total = (long long)NG * K * CGP * HP * WP;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int x = (int)(e % WP);
  long long r = e / WP;
  const int y = (int)(r % HP);
  r /= HP;
  const int cp = (int)(r % CGP);
  r /= CGP;
  const int i = (int)(r / K);
  const long long pos = (r * HP + y) * WP + x;
  const BandTaps b = band_taps(py[pos], px[pos], y, dy_lo, band, WP);
  const int HS = HP + band;
  const unsigned* s = psrc + ((long long)i * CGP + cp) * HS * WP;
  float acc_e = 0.f, acc_o = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (b.row[k] < 0) continue;
    const unsigned* p = s + (long long)b.row[k] * WP + b.x0;
    const unsigned g0 = p[0], g1 = p[1];
    acc_e = band_term(acc_e, bf16_lo(g0), bf16_lo(g1), b.w0[k], b.w1[k]);
    acc_o = band_term(acc_o, bf16_hi(g0), bf16_hi(g1), b.w0[k], b.w1[k]);
  }
  const float m = mask[pos];
  const long long plane = (long long)HP * WP;
  __nv_bfloat16* o = out + ((r * 2 * CGP + 2 * cp) * HP + y) * WP + x;
  o[0] = band_out<__nv_bfloat16>(acc_e, m);
  o[plane] = band_out<__nv_bfloat16>(acc_o, m);
}

template <typename TS, typename TO>
void launch_band(const void* src, const void* py, const void* px,
                 const void* mask, void* out, int NG, int K, int CG, int HP,
                 int WP, int band, int dy_lo, cudaStream_t s) {
  const long long total = (long long)NG * K * CG * HP * WP;
  if (total == 0) return;
  band_sample_kernel<TS, TO><<<blocks_for(total, 256), 256, 0, s>>>(
      static_cast<const TS*>(src), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(mask),
      static_cast<TO*>(out), NG, K, CG, HP, WP, band, dy_lo);
}

template <typename T>
void launch_cbatch(const void* src, const void* py, const void* px,
                   const void* mask, void* out, int NG, int K, int CG,
                   int HP, int WP, int band, int dy_lo, cudaStream_t s) {
  const long long total = (long long)NG * K * HP * WP;
  if (total == 0) return;
  band_sample_cbatch_kernel<T><<<blocks_for(total, 256), 256, 0, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(mask),
      static_cast<T*>(out), NG, K, CG, HP, WP, band, dy_lo);
}

}  // namespace e2fgvi

// Plain C entry points, loaded with ctypes (kernels/build.py). Each makes
// `device` current, launches on `stream` and returns cudaGetLastError().
// dtype codes: 0 float32, 1 bfloat16. band_sample takes (src, out) in
// (f32, f32), (bf16, bf16) or (f32, bf16); the wrapper refuses the rest.
extern "C" int e2fgvi_band_sample(int src_dtype, int out_dtype,
                                  const void* src, const void* py,
                                  const void* px, const void* mask, void* out,
                                  int NG, int K, int CG, int HP, int WP,
                                  int band, int dy_lo, int device,
                                  void* stream) {
  using e2fgvi::kBFloat16;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dtype == kBFloat16 && out_dtype == kBFloat16) {
    e2fgvi::launch_band<__nv_bfloat16, __nv_bfloat16>(src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, s);
  } else if (src_dtype != kBFloat16 && out_dtype == kBFloat16) {
    e2fgvi::launch_band<float, __nv_bfloat16>(src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, s);
  } else if (src_dtype != kBFloat16 && out_dtype != kBFloat16) {
    e2fgvi::launch_band<float, float>(src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int e2fgvi_band_sample_cbatch(int dtype, const void* src,
                                         const void* py, const void* px,
                                         const void* mask, void* out, int NG,
                                         int K, int CG, int HP, int WP,
                                         int band, int dy_lo, int device,
                                         void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    e2fgvi::launch_cbatch<__nv_bfloat16>(src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, s);
  } else {
    e2fgvi::launch_cbatch<float>(src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int e2fgvi_band_sample_xpair(const void* psrc, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int NG, int K, int CG,
                                        int HP, int WP, int band, int dy_lo,
                                        int device, void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long total = (long long)NG * K * CG * HP * WP;
  if (total > 0) {
    e2fgvi::band_sample_xpair_kernel<<<e2fgvi::blocks_for(total, 256), 256,
                                       0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(psrc), static_cast<const float*>(py),
        static_cast<const float*>(px), static_cast<const float*>(mask),
        static_cast<__nv_bfloat16*>(out), NG, K, CG, HP, WP, band, dy_lo);
  }
  return (int)cudaGetLastError();
}

extern "C" int e2fgvi_band_sample_cpair(const void* psrc, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int NG, int K, int CGP,
                                        int HP, int WP, int band, int dy_lo,
                                        int device, void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long total = (long long)NG * K * CGP * HP * WP;
  if (total > 0) {
    e2fgvi::band_sample_cpair_kernel<<<e2fgvi::blocks_for(total, 256), 256,
                                       0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(psrc), static_cast<const float*>(py),
        static_cast<const float*>(px), static_cast<const float*>(mask),
        static_cast<__nv_bfloat16*>(out), NG, K, CGP, HP, WP, band, dy_lo);
  }
  return (int)cudaGetLastError();
}
