// K1 deform_im2col and K2 flow_warp: the bilinear samplers of the
// flow-guided propagation (models/feat_prop.py).
//
// Replaces the TPU kernel e2fgvi_tpu/kernels/dcn_band.py::_sampler_kernel
// (built by _build_sampler, reached through
// modulated_deform_conv2d_banded_head for K1 and flow_warp_banded for K2).
// The TPU kernel could only gather along the 128-lane axis, so it swept a
// static band of rows and needed a per-video band contract. Here every
// thread computes its own sample positions and reads the four bilinear
// corners directly, so any offset is exact and there is no band.
//
// What bounds it on the H100: gather bytes. At serving shapes (N=14,
// 60x108 quarter-res, Cin=256, G=16 groups, 9 taps) K1 reads four corners
// of 16 contiguous channels for 14*6480*16*9 samples (~1.7 GB of corner
// reads at bf16, mostly L2 hits because neighbouring pixels share corners)
// and writes a 0.42 GB bf16 im2col matrix. Design against that: inputs are
// NHWC, so one group's 16 channels are one contiguous 32/64-byte run; one
// thread owns one (pixel, group, tap) sample and writes its 16 outputs as a
// contiguous run, so consecutive threads write consecutive memory; the
// offset/mask prelude (10*tanh + flow, sigmoid) is fused in, so the
// (N,H,W,G,K,2) offset tensor never exists. The 3x3 weight contraction is
// a plain GEMM on the im2col matrix outside the kernel, as the JAX package
// also leaves it outside its kernel (dcn_band.py:_sample_and_contract).
#include "common.cuh"

namespace e2fgvi {

// Element offsets and weights of the four bilinear corners of (py, px) in
// an (H, W, C) NHWC plane. Corners outside the image get weight 0, which is
// mmcv's dmcn_im2col_bilinear rule (zeros padding, align_corners=True).
struct Corners {
  long long off[4];
  float w[4];
};

__device__ __forceinline__ Corners corners_of(int H, int W, int C, float py,
                                              float px, float scale) {
  Corners c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c.off[i] = 0;
    c.w[i] = 0.f;
  }
  // also rejects NaN and keeps the int conversions below in range
  if (!(py > -1.f && px > -1.f && py < (float)H && px < (float)W)) return c;
  const float fy = floorf(py), fx = floorf(px);
  const int y0 = (int)fy, x0 = (int)fx;
  const float ly = py - fy, lx = px - fx;
  const float hy = 1.f - ly, hx = 1.f - lx;
  const float wy[2] = {hy, ly}, wx[2] = {hx, lx};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int y = y0 + a, x = x0 + b;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        c.off[a * 2 + b] = ((long long)y * W + x) * C;
        c.w[a * 2 + b] = wy[a] * wx[b] * scale;
      }
    }
  }
  return c;
}

// acc[0..NC) += sum over corners of w * img[corner, c0 .. c0+NC)
template <typename T, int NC>
__device__ __forceinline__ void gather_corners(const T* __restrict__ img,
                                               const Corners& c, int c0,
                                               float* acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (c.w[i] != 0.f) {
      const T* p = img + c.off[i] + c0;
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[k] += c.w[i] * to_f32(p[k]);
    }
  }
}

// One thread per (n, output pixel, group g, tap k). Writes
// col[n*P + p, (g*K + k)*CG + c] for c in [0, CG), P = Ho*Wo.
// head: (N, Ho, Wo, 3*K*G) raw offset-head output; channel (g*K+k)*2 + 0/1
// is the (dy, dx) residual, channel 2*K*G + g*K + k the mask logit.
// flow1/flow2: (N, Ho, Wo, 2) float32, (dx, dy) order; groups g < G/2 take
// flow1 and the rest flow2 (the second-order deformable alignment).
template <typename T, int NC>
__global__ void __launch_bounds__(256)
deform_im2col_kernel(const T* __restrict__ x, const T* __restrict__ head,
                     const float* __restrict__ flow1,
                     const float* __restrict__ flow2, T* __restrict__ col,
                     int N, int H, int W, int Cin, int Ho, int Wo, int G,
                     int K, int kw, int pad, float max_residue) {
  const int CG = Cin / G;
  const long long P = (long long)Ho * Wo;
  const long long total = (long long)N * P * G * K;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int k = (int)(i % K);
  long long r = i / K;
  const int g = (int)(r % G);
  r /= G;                       // r = n*P + p
  const int p = (int)(r % P);
  const int n = (int)(r / P);
  const int oy = p / Wo, ox = p % Wo;

  const T* hp = head + r * (3LL * K * G);
  const int oc = (g * K + k) * 2;
  const float* fl = (g < G / 2 ? flow1 : flow2) + r * 2;
  const float off_y = max_residue * tanhf(to_f32(hp[oc])) + fl[1];
  const float off_x = max_residue * tanhf(to_f32(hp[oc + 1])) + fl[0];
  const float m = 1.f / (1.f + expf(-to_f32(hp[2 * K * G + g * K + k])));
  const int ky = k / kw, kx = k % kw;
  const float py = (float)(oy - pad + ky) + off_y;
  const float px = (float)(ox - pad + kx) + off_x;

  const Corners c = corners_of(H, W, Cin, py, px, 1.f);
  const T* img = x + (long long)n * H * W * Cin + g * CG;
  T* out = col + i * CG;
  for (int c0 = 0; c0 < CG; c0 += NC) {
    float acc[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] = 0.f;
    gather_corners<T, NC>(img, c, c0, acc);
#pragma unroll
    for (int q = 0; q < NC; ++q) out[c0 + q] = from_f32<T>(acc[q] * m);
  }
}

// One thread per (n, y, x, chunk of NC channels): backward warp of an NHWC
// map by a dense (dx, dy) float32 flow, bilinear, zeros outside.
template <typename T, int NC>
__global__ void __launch_bounds__(256)
flow_warp_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                 T* __restrict__ out, int N, int H, int W, int C) {
  const int chunks = C / NC;
  const long long total = (long long)N * H * W * chunks;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ch = (int)(i % chunks);
  const long long r = i / chunks;  // n*H*W + pixel
  const int pix = (int)(r % ((long long)H * W));
  const int n = (int)(r / ((long long)H * W));
  const int y = pix / W, xx = pix % W;
  const float px = (float)xx + flow[r * 2];
  const float py = (float)y + flow[r * 2 + 1];
  const Corners c = corners_of(H, W, C, py, px, 1.f);
  float acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) acc[q] = 0.f;
  gather_corners<T, NC>(x + (long long)n * H * W * C, c, ch * NC, acc);
  T* o = out + r * C + ch * NC;
#pragma unroll
  for (int q = 0; q < NC; ++q) o[q] = from_f32<T>(acc[q]);
}

template <typename T, int NC>
void launch_im2col(const void* x, const void* head, const void* flow1,
                   const void* flow2, void* col, int N, int H, int W,
                   int Cin, int Ho, int Wo, int G, int K, int kw, int pad,
                   float max_residue, cudaStream_t stream) {
  const long long total = (long long)N * Ho * Wo * G * K;
  if (total == 0) return;
  deform_im2col_kernel<T, NC><<<blocks_for(total, 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(head),
      static_cast<const float*>(flow1), static_cast<const float*>(flow2),
      static_cast<T*>(col), N, H, W, Cin, Ho, Wo, G, K, kw, pad,
      max_residue);
}

template <typename T>
void dispatch_im2col(int nc, const void* x, const void* head,
                     const void* flow1, const void* flow2, void* col, int N,
                     int H, int W, int Cin, int Ho, int Wo, int G, int K,
                     int kw, int pad, float max_residue, cudaStream_t s) {
  switch (nc) {
    case 16: launch_im2col<T, 16>(x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    case 8: launch_im2col<T, 8>(x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    case 4: launch_im2col<T, 4>(x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    case 2: launch_im2col<T, 2>(x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    default: launch_im2col<T, 1>(x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
  }
}

template <typename T, int NC>
void launch_warp(const void* x, const void* flow, void* out, int N, int H,
                 int W, int C, cudaStream_t stream) {
  const long long total = (long long)N * H * W * (C / NC);
  if (total == 0) return;
  flow_warp_kernel<T, NC><<<blocks_for(total, 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(flow),
      static_cast<T*>(out), N, H, W, C);
}

template <typename T>
void dispatch_warp(int nc, const void* x, const void* flow, void* out, int N,
                   int H, int W, int C, cudaStream_t s) {
  switch (nc) {
    case 8: launch_warp<T, 8>(x, flow, out, N, H, W, C, s); break;
    case 4: launch_warp<T, 4>(x, flow, out, N, H, W, C, s); break;
    case 2: launch_warp<T, 2>(x, flow, out, N, H, W, C, s); break;
    default: launch_warp<T, 1>(x, flow, out, N, H, W, C, s); break;
  }
}

}  // namespace e2fgvi

// Plain C entry points, loaded with ctypes (kernels/build.py). Each makes
// `device` (the tensors' CUDA device) current for this library's runtime,
// launches on `stream`, and returns cudaGetLastError(); nonzero means the
// launch was refused.
// `nc` is the channel chunk per thread (16, 8, 4, 2 or 1) and must divide
// the group width (K1) or the channel count (K2); the wrapper picks it.
extern "C" int e2fgvi_deform_im2col(int dtype, int nc, const void* x,
                                    const void* head, const void* flow1,
                                    const void* flow2, void* col, int N,
                                    int H, int W, int Cin, int Ho, int Wo,
                                    int G, int K, int kw, int pad,
                                    float max_residue, int device,
                                    void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    e2fgvi::dispatch_im2col<__nv_bfloat16>(nc, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s);
  } else {
    e2fgvi::dispatch_im2col<float>(nc, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int e2fgvi_flow_warp(int dtype, int nc, const void* x,
                                const void* flow, void* out, int N, int H,
                                int W, int C, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    e2fgvi::dispatch_warp<__nv_bfloat16>(nc, x, flow, out, N, H, W, C, s);
  } else {
    e2fgvi::dispatch_warp<float>(nc, x, flow, out, N, H, W, C, s);
  }
  return (int)cudaGetLastError();
}
