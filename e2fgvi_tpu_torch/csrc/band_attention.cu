// E2 band_attention: focal window attention whose keys are read in place
// from the qkv maps, with no key gather.
//
// Replaces the TPU experiment kernel scripts/exp_attn_band_r04.py::_kernel
// (built by _build, pallas_call at :107). On the TPU a key gather is a
// slow row-issue take, so that kernel received overlapping row bands of the
// wrap-padded k/v maps (bulk DMA) and assembled each window's keys from
// static rectangles of the band into VMEM. A Hopper thread reads any
// address, so here there are no bands either: the static geometry is a
// per-slot (dy, dx) offset table (kernels/band_attention.py:slot_offsets:
// own window, the rolled rectangles of tfocal._rolled_rects, the pooled
// unfold window), and each key tile's 64 row addresses are computed from it
// per block:
//   own / rolled:  token ((wy*wh + dy) mod H, (wx*ww + dx) mod W) of the
//                  qkv map, the torch.roll wrap;
//   pooled:        cell (wy + dy, wx + dx) of the pooled qkv map, or a zero
//                  key with bias -100 outside the grid.
// Every key of a frame with frame_valid false gets bias -1e9; keys past the
// end get -inf. q, k and v rows are read straight from the (B, T, H, W, 3C)
// output of the qkv GEMM (and the pooled (B, nWh, nWw, T, 3C) one): each
// row is a contiguous 256-byte run, so no partition, roll or gather copy
// exists. The 1/sqrt(hd) scale is folded into q as it loads, rounded to
// bf16 as the port's q * hd**-0.5 is.
//
// The product loop (flash_mma.cuh) is the one K3's bf16 kernel ran on
// before it moved to wgmma: one block per (64-query tile,
// head, b*nWin + window), 4 warps, mma.sync m16n8k16 with an online
// softmax in registers. What bounds it on the H100 at the serving shape
// (B=14, T=17, 16 windows, 4 heads, 765 queries, 17*210 keys, hd 128): the
// ~1.26 TFLOP of q.k and p.v, 24% more than K3's deduplicated 765 +
// 17*125 keys, against the k/v gather and partition copies it removes.
#include <cmath>

#include "common.cuh"
#include "flash_mma.cuh"

namespace e2fgvi {

constexpr int kBandSmemBase = 3 * mma::kTileBytes + mma::kBK * 4 +
                              mma::kBK * (int)sizeof(void*);

__global__ void __launch_bounds__(mma::kThreads)
band_attention_kernel(const mma::bf16* __restrict__ qkv,
                      const mma::bf16* __restrict__ pqkv,
                      const int2* __restrict__ slots,
                      const unsigned char* __restrict__ fvalid,
                      mma::bf16* __restrict__ out, int T, int H, int W,
                      int heads, int wh, int ww, int nwh, int nww, int S,
                      int n_fine, float scale) {
  using mma::bf16;
  using mma::kBK;
  using mma::kBQ;
  using mma::kHD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * mma::kLd;
  bf16* Vs = Ks + kBK * mma::kLd;
  const bf16** Kp = reinterpret_cast<const bf16**>(Vs + kBK * mma::kLd);
  float* Bs = reinterpret_cast<float*>(Kp + kBK);
  int2* Sl = reinterpret_cast<int2*>(Bs + kBK);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;                    // b * nWin + wy * nwx + wx
  const int nwx = W / ww, nwin = (H / wh) * nwx;
  const int b = bw / nwin, w = bw % nwin;
  const int wy = w / nwx, wx = w % nwx;
  const int C = heads * kHD;
  const long long ld = 3LL * C;                 // qkv elements per token
  const int nwa = wh * ww, nq = T * nwa, nk = T * S;

  for (int i = tid; i < S; i += mma::kThreads) Sl[i] = slots[i];

  // the block's 64 queries, scaled as they load
  for (int c = tid; c < kBQ * (kHD / 8); c += mma::kThreads) {
    const int r = c / (kHD / 8), cc = c % (kHD / 8);
    const int n = q0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < nq) {
      const int t = n / nwa, rem = n % nwa;
      const long long tok =
          (((long long)b * T + t) * H + wy * wh + rem / ww) * W + wx * ww +
          rem % ww;
      v = *reinterpret_cast<const uint4*>(qkv + tok * ld + h * kHD + cc * 8);
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(p2[k]);
        p2[k] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + r * mma::kLd + cc * 8) = v;
  }
  __syncthreads();
  mma::Flash f;
  f.start(Qs);

  for (int j0 = 0; j0 < nk; j0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < kBK) {
      const int jj = j0 + tid;
      const bf16* kp = nullptr;
      float bj = -INFINITY;
      if (jj < nk) {
        const int t = jj / S, s = jj % S;
        const int2 d = Sl[s];
        bj = 0.f;
        if (s < n_fine) {
          const int yy = ((wy * wh + d.x) % H + H) % H;
          const int xx = ((wx * ww + d.y) % W + W) % W;
          kp = qkv + ((((long long)b * T + t) * H + yy) * W + xx) * ld;
        } else {
          const int py = wy + d.x, px = wx + d.y;
          if (py >= 0 && py < nwh && px >= 0 && px < nww) {
            kp = pqkv + ((((long long)b * nwh + py) * nww + px) * T + t) * ld;
          } else {
            bj = -100.f;                        // zero key outside the grid
          }
        }
        if (kp != nullptr) kp += C + h * kHD;
        if (!fvalid[(long long)b * T + t]) bj = -1e9f;
      }
      Kp[tid] = kp;
      Bs[tid] = bj;
    }
    __syncthreads();
    mma::load_tile(Ks, [&](int r) -> const bf16* { return Kp[r]; });
    mma::load_tile(Vs, [&](int r) -> const bf16* {
      return Kp[r] != nullptr ? Kp[r] + C : nullptr;
    });
    __syncthreads();
    f.tile(Ks, Vs, Bs);
  }
  f.finish(out, bw, q0, nq, C, h * kHD);
}

}  // namespace e2fgvi

// Plain C entry point, loaded with ctypes (kernels/build.py). Makes `device`
// current, launches on `stream` and returns cudaGetLastError(); bfloat16
// only, hd must be 128. slots: (S, 2) int32 (dy, dx); fvalid: (B, T) uint8.
extern "C" int e2fgvi_band_attention(const void* qkv, const void* pqkv,
                                     const void* slots, const void* fvalid,
                                     void* out, int B, int T, int H, int W,
                                     int heads, int wh, int ww, int nwh,
                                     int nww, int S, int n_fine, int hd,
                                     float scale, int device, void* stream) {
  using e2fgvi::mma::bf16;
  if (hd != e2fgvi::mma::kHD) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const int smem = e2fgvi::kBandSmemBase + S * (int)sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      e2fgvi::band_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = T * wh * ww;
  const int nwin = (H / wh) * (W / ww);
  if (B == 0 || nq == 0) return (int)cudaGetLastError();
  const dim3 grid((nq + e2fgvi::mma::kBQ - 1) / e2fgvi::mma::kBQ, heads,
                  B * nwin);
  e2fgvi::band_attention_kernel<<<grid, e2fgvi::mma::kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(pqkv),
      static_cast<const int2*>(slots),
      static_cast<const unsigned char*>(fvalid), static_cast<bf16*>(out), T,
      H, W, heads, wh, ww, nwh, nww, S, n_fine, scale);
  return (int)cudaGetLastError();
}
