// E3 row_gather and E4 bilinear4_sample: the gather formulations of the
// DCN sampler that scripts/exp_gather.py measured on the TPU.
//
// Replaces the TPU experiment kernels scripts/exp_gather.py `v2` (inner
// `kernel` at :123, pallas_call :127: a per-lane row gather from a VMEM
// resident (P, 128) table, Mosaic's tpu.dynamic_gather) and `v3` (inner
// `kernel` at :171, pallas_call :194: four such gathers fused with the
// bilinear weights). On the TPU the table had to sit in VMEM and the index
// array had to match the table's shape. Here each thread reads its own row
// address from the (P, C) table in device memory; at P = 6480 rows of 128
// lanes the table (3.3 MB in float32) stays in the 50 MB L2.
//
// What bounds them on the H100: bytes. E3 at (9, 6480, 128) writes 30 MB
// (float32) and reads 30 MB of int32 indices, and its table reads hit L2.
// Threads run lane fastest, so index reads and output writes are
// coalesced. In the experiment's inputs the 8 lanes of a group share one
// index (as a real DCN's do); E3 keeps per-lane indices as its contract.
// E4 reads the (T, P, G) positions once per (t, p, group), computes the
// corners and weights once, and writes the group's C/G lanes g, g+G, ...;
// a warp covers 32 consecutive (p, group) pairs, so each of its stores
// writes 16 consecutive floats of two rows.
#include "common.cuh"

namespace e2fgvi {

template <typename T>
__global__ void __launch_bounds__(256)
row_gather_kernel(const T* __restrict__ tab, const int* __restrict__ idx,
                  T* __restrict__ out, int rows, int P, int C) {
  const long long total = (long long)rows * C;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int j = (int)(e % C);
  const int r = idx[e];
  out[e] = (r >= 0 && r < P) ? tab[(long long)r * C + j] : from_f32<T>(0.f);
}

// one thread per (t*P + p, group g): lanes g, g+G, ..., g+(C/G-1)*G
__global__ void __launch_bounds__(256)
bilinear4_kernel(const float* __restrict__ tab, const float* __restrict__ py,
                 const float* __restrict__ px, float* __restrict__ out,
                 int rows, int G, int C, int H, int W) {
  const long long total = (long long)rows * G;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int g = (int)(e % G);
  const long long row = e / G;
  const float fy = py[e], fx = px[e];
  const float y0 = fminf(fmaxf(floorf(fy), 0.f), (float)(H - 2));
  const float x0 = fminf(fmaxf(floorf(fx), 0.f), (float)(W - 2));
  const float wy0 = fmaxf(1.f - fabsf(fy - y0), 0.f);
  const float wy1 = fmaxf(1.f - fabsf(fy - (y0 + 1.f)), 0.f);
  const float wx0 = fmaxf(1.f - fabsf(fx - x0), 0.f);
  const float wx1 = fmaxf(1.f - fabsf(fx - (x0 + 1.f)), 0.f);
  const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
  const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
  const float* t0 = tab + ((long long)y0 * W + (long long)x0) * C;
  const float* t1 = t0 + (long long)W * C;
  float* o = out + row * C;
  for (int j = g; j < C; j += G) {
    float acc = __fmul_rn(t0[j], w00);
    acc = __fadd_rn(acc, __fmul_rn(t0[C + j], w01));
    acc = __fadd_rn(acc, __fmul_rn(t1[j], w10));
    acc = __fadd_rn(acc, __fmul_rn(t1[C + j], w11));
    o[j] = acc;
  }
}

}  // namespace e2fgvi

// Plain C entry points, loaded with ctypes (kernels/build.py). Each makes
// `device` current, launches on `stream` and returns cudaGetLastError().
extern "C" int e2fgvi_row_gather(int dtype, const void* tab, const void* idx,
                                 void* out, int rows, int P, int C,
                                 int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)rows * C;
  if (total == 0) return (int)cudaGetLastError();
  const unsigned blocks = e2fgvi::blocks_for(total, 256);
  if (dtype == e2fgvi::kBFloat16) {
    e2fgvi::row_gather_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(tab), static_cast<const int*>(idx),
        static_cast<__nv_bfloat16*>(out), rows, P, C);
  } else {
    e2fgvi::row_gather_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(tab), static_cast<const int*>(idx),
        static_cast<float*>(out), rows, P, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int e2fgvi_bilinear4_sample(const void* tab, const void* py,
                                       const void* px, void* out,
                                       int rows, int G, int C, int H,
                                       int W, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const long long total = (long long)rows * G;
  if (total > 0) {
    e2fgvi::bilinear4_kernel<<<e2fgvi::blocks_for(total, 256), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tab), static_cast<const float*>(py),
        static_cast<const float*>(px), static_cast<float*>(out), rows, G, C,
        H, W);
  }
  return (int)cudaGetLastError();
}
