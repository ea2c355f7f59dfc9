// C1: the float32 3x3 convolutions of the flow-guided propagation
// (models/feat_prop.py: the offset head's four, 388->128, 128->128,
// 128->128, 128->432, and the backbone's two, 256 or 384->128 and
// 128->128), stride 1, padding 1, as one implicit-GEMM kernel on 3xTF32
// wgmma, with the bias, an optional LeakyReLU and an optional residual add
// (the backbone's `feat_prop + conv(...)`) in its epilogue.
//
// Replaces no TPU kernel: the JAX package left these convolutions to XLA.
// On the card cuDNN ran them in float32 (TF32 off) as FFT convolutions
// (complex-float32 GEMMs) at about 1% of the 3xTF32 rate, three quarters
// of the f32 serving time.
//
// The GEMM: M = N*H*W output pixels x K = 9*Cin x Cout. Precision as the
// f32 K1 (deform.cu, namespace fused_tf32): each operand splits into tf32
// big and small parts, each product is small*big + big*small + big*big
// (small*small, ~2^-22 relative, dropped), and, since the tensor cores
// truncate the float32 sums they chain, each 32-wide K chunk's 12 wgmma
// start from zero in one accumulator that joins the running sum by a
// rounded add. K runs to 9*416 = 3,744 at Cin 388 (117 chunks).
//
// What bounds it on the H100: operations. At the base serving shapes
// (60x108 maps, N = 4 windows) the six convolutions of one propagation
// step are 91 GFLOP of float32 work, 273 GFLOP of TF32 products: 0.55 ms
// at 495 TFLOP/s. Beside the tensor cores:
// * L2: every block streams its N-tile's whole weight, big and small, 8
//   bytes per (k, n) for its 128 pixels: ~21 bytes a clock an SM at the
//   TF32 peak, near L2's rate card-wide. Hence 128-pixel tiles (a 64-pixel
//   tile would double it).
// * Shared memory's 128 bytes a clock: wgmma reads B from shared memory
//   (big twice and small once a k-step, per warpgroup). A is read once a
//   chunk by plain loads and split in registers, never written back.
//
// The design:
// * One block per 16 x 8-pixel tile of one image and one N-tile of Cout
//   (128, or 144 = 432 / 3: m64n144 is a width wgmma takes, and 432
//   leaves no ragged tile; on the H100 a 128 -> 432 call took 0.26-0.28
//   ms at 60x108, N = 4, against 0.30-0.31 for 128-wide tiles with a
//   ragged fourth), blockIdx.x the N-tile, so a tile's N-tiles run side by
//   side and share its input in L2. At 60x108 a map is 7 x 8 tiles (9.6%
//   of the rows fall past the edges and are computed as zeros, not
//   stored), 56 blocks an image: at N = 4, 224 blocks on 132 SMs; at
//   N = 1 the card is under half full (that 128 -> 432 call reads 35% of
//   its bound there, 56-59% at N = 4). Smaller tiles would fill it but
//   read the weight from L2 once more per pixel; the f32 serving batches
//   are mostly N = 4 (54 windows in 15 batches a DAVIS pass), so the
//   tile stays.
// * A, the input, arrives by TMA once per 32-channel chunk as the tile's
//   halo: one 4-D box {32 channels, 18, 10, 1} of a (C, W, H, N) tensor
//   map at (c0, x0 - 1, y0 - 1, n), 23 KB, double-buffered. TMA fills the
//   box's elements outside the image with zeros, which is the padding,
//   and its channels past Cin (388 = 12 x 32 + 4) too. The nine taps of a
//   chunk read the same halo, shifted: 1/9 of the L2 reads of one box per
//   (tap, chunk).
// * A from registers (wgmma's RS form): a thread's rows are pixels g and
//   g + 8 of its warp's tile row, and for every tap it loads its two rows'
//   32 bytes of channels 8t .. 8t + 7 (two 16-byte loads a row, free of
//   bank conflicts under the 128-byte swizzle), splits them in registers,
//   and hands k-step kk channels 8t + 2kk (k-column t) and 8t + 2kk + 1
//   (k-column t + 4). The sum over K is order-free, so B's columns are
//   permuted to match on the host (kernels/conv.py conv_operands).
// * B, the weight, reordered once per pass to (2, Cout, 9 * Cin_pad),
//   K-major, chunk q = c * 9 + tap, big then small, zero past Cin: a 3-D
//   TMA box {32, BN, 2} a chunk into a 4-stage ring.
// * A producer warpgroup (setmaxnreg 24) whose thread 0 issues the halo and
//   weight copies, and two consumer warpgroups (setmaxnreg 240) of 64 rows:
//   each holds the chunk's accumulator and the running sum (2 x BN / 2
//   registers) and the chunk's A fragments (big, small and the next
//   chunk's raw values). While chunk q's 12 wgmma run, the warpgroup loads
//   chunk q + 1's raw values; the two warpgroups' gaps (the split, the
//   rounded join) fill each other's tensor time.
// * Epilogue: bias, LeakyReLU, residual, float2 stores of the pixels inside
//   the map (32-byte sectors a warp row; a small share of the time, so no
//   shared-memory staging).
// * mbar_wait traps a broken pipeline instead of hanging the card.
#include "hopper.cuh"

namespace e2fgvi {
namespace conv_tf32 {

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait;

constexpr int kTW = 16, kTH = 8;             // output tile, pixels
constexpr int kHW = kTW + 2, kHH = kTH + 2;  // its halo
constexpr int kBK = 32;                      // K chunk: 32 channels of a tap
constexpr int kHalo = kHW * kHH * kBK * 4;   // 23,040 bytes
constexpr int kHaloStage = (kHalo + 1023) / 1024 * 1024;
constexpr int kStages = 4;                   // the weight's ring
constexpr int kConsumers = 256;
constexpr int kThreads = 128 + kConsumers;

template <int BN>
struct Layout {
  static constexpr int kBTile = BN * kBK * 4;       // big or small
  static constexpr int kBStage = 2 * kBTile;
  static constexpr int kBOff = 2 * kHaloStage;
  static constexpr int kBarOff = kBOff + kStages * kBStage;
  // full and empty of each weight stage and halo buffer; + 1 KB to align
  // the base to the 128-byte swizzle's 1024-byte period
  static constexpr int kSmem = kBarOff + 8 * 2 * (kStages + 2) + 1024;
  static_assert(kSmem <= 232448, "227 KB a block");
};

struct Params {
  const float* bias;   // (Cout,)
  const float* res;    // (N, H, W, Cout) or null
  float* out;          // (N, H, W, Cout)
  int H, W, Cout, chunks, tiles_x;
  float slope;         // LeakyReLU's; 1 is none
};

__device__ __forceinline__ void ld_shared_v4(uint32_t addr, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (BN == 128)
    hopper::wgmma_tf32_rs(d, a, db, accumulate);
  else
    hopper::wgmma_tf32_rs_n144(d, a, db, accumulate);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ Params p) {
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sH = base, sB = base + L::kBOff;
  const uint32_t bfull = base + L::kBarOff, bempty = bfull + 8 * kStages;
  const uint32_t hfull = bempty + 8 * kStages, hempty = hfull + 16;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % p.tiles_x) * kTW;
  const int y0 = (blockIdx.y / p.tiles_x) * kTH;
  const int n = blockIdx.z;
  const int Q = 9 * p.chunks;               // K chunks: (channel chunk, tap)

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bfull + 8 * s, 1);
      mbar_init(bempty + 8 * s, kConsumers);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(hfull + 8 * h, 1);
      mbar_init(hempty + 8 * h, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: thread 0 issues every copy, a channel chunk's
    // halo ahead of its first tap's weight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int q = 0; q < Q; ++q) {
        const int c = q / 9;
        if (q == 9 * c) {
          const int hb = c & 1;
          mbar_wait(hempty + 8 * hb, ((c >> 1) & 1) ^ 1);
          mbar_expect_tx(hfull + 8 * hb, kHalo);
          hopper::tma_load_4d(sH + hb * kHaloStage, &xmap, hfull + 8 * hb,
                              c * kBK, x0 - 1, y0 - 1, n);
        }
        const int s = q % kStages;
        mbar_wait(bempty + 8 * s, ((q / kStages) & 1) ^ 1);
        mbar_expect_tx(bfull + 8 * s, L::kBStage);
        hopper::tma_load(sB + s * L::kBStage, &wmap, bfull + 8 * s, q * kBK,
                         n0, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int wg = (tid >> 7) - 1;           // consumer warpgroup: rows 64wg ..
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // rows g and g + 8 of the warp's 16 are pixels (ty, g) and (ty, g + 8)
  const int ty = 4 * wg + warp;

  // chunk q's raw values of this thread: v[8r + j] = channel 8t + j of
  // row r's pixel shifted by the tap
  auto load_raw = [&](int q, float (&v)[16]) {
    const int c = q / 9, tap = q - 9 * c;
    const int ky = tap / 3, kx = tap - 3 * ky;
    const uint32_t halo = sH + (c & 1) * kHaloStage;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hr = (ty + ky) * kHW + g + 8 * r + kx;
      const uint32_t row = halo + hr * 128;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        ld_shared_v4(row + (((2 * t + hf) ^ (hr & 7)) << 4), v + 8 * r + 4 * hf);
    }
  };

  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  float v[16];
  // k-step kk's A fragments: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  // = channels 8t + 2kk, 8t + 2kk + 1 of rows g and g + 8
  uint32_t ab[4][4], as[4][4];

  mbar_wait(hfull, 0);
  load_raw(0, v);
  for (int q = 0; q < Q; ++q) {
    const int c = q / 9;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const Split s0 = split(v[2 * kk]), s1 = split(v[8 + 2 * kk]),
                  s2 = split(v[2 * kk + 1]), s3 = split(v[9 + 2 * kk]);
      ab[kk][0] = s0.big, ab[kk][1] = s1.big, ab[kk][2] = s2.big,
      ab[kk][3] = s3.big;
      as[kk][0] = s0.small, as[kk][1] = s1.small, as[kk][2] = s2.small,
      as[kk][3] = s3.small;
    }
    const int s = q % kStages;
    mbar_wait(bfull + 8 * s, (q / kStages) & 1);
    const uint32_t b_st = sB + s * L::kBStage;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b_big = desc_sw128(b_st + kk * 32, 16, 1024);
      const uint64_t b_small = desc_sw128(b_st + L::kBTile + kk * 32, 16, 1024);
      wgmma_rs<BN>(acc, as[kk], b_big, kk > 0);
      wgmma_rs<BN>(acc, ab[kk], b_small, 1);
      wgmma_rs<BN>(acc, ab[kk], b_big, 1);
    }
    wg_commit();
    // chunk q + 1's raw values while chunk q's products run
    if (q + 1 < Q) {
      const int cn = (q + 1) / 9;
      if (q + 1 == 9 * cn) mbar_wait(hfull + 8 * (cn & 1), (cn >> 1) & 1);
      load_raw(q + 1, v);
    }
    wg_wait<0>();
    fence_regs(acc);
    // the fragments stay in their registers until the wgmma reading them
    // are done
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" ::"r"(ab[kk][e]), "r"(as[kk][e]) : "memory");
    mbar_arrive(bempty + 8 * s);               // chunk q's weight stage
    if (q == 9 * c + 8) mbar_arrive(hempty + 8 * (c & 1));  // its halo
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sum[j] += acc[j];
  }

  // sum[4i + e]: row g (e < 2) or g + 8, column 8i + 2t + (e & 1)
  const int y = y0 + ty;
  if (y >= p.H) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int x = x0 + g + 8 * r;
    if (x >= p.W) continue;
    const long long at = (((long long)n * p.H + y) * p.W + x) * p.Cout + n0 +
                         2 * t;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 b =
          __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * i + 2 * t));
      float v0 = sum[4 * i + 2 * r] + b.x, v1 = sum[4 * i + 2 * r + 1] + b.y;
      v0 = v0 > 0.f ? v0 : v0 * p.slope;
      v1 = v1 > 0.f ? v1 : v1 * p.slope;
      if (p.res != nullptr) {
        const float2 rv =
            __ldg(reinterpret_cast<const float2*>(p.res + at + 8 * i));
        v0 = rv.x + v0;
        v1 = rv.y + v1;
      }
      *reinterpret_cast<float2*>(p.out + at + 8 * i) = make_float2(v0, v1);
    }
  }
}

template <int BN>
int launch(const CUtensorMap& xmap, const float* wk, const Params& prm,
           int N, int K, cudaStream_t stream) {
  using L = Layout<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_tf32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)prm.Cout, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4,
                                 (cuuint64_t)K * 4 * prm.Cout};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)BN, 2};
  CUtensorMap wmap;
  if (!hopper::encode_sw128(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wk, dims,
                           strides, box))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)prm.tiles_x * ((prm.H + kTH - 1) / kTH);
  if (tiles > 65535 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(prm.Cout / BN, (unsigned)tiles, N);
  conv3x3_tf32_kernel<BN><<<grid, kThreads, L::kSmem, stream>>>(xmap, wmap,
                                                                 prm);
  return (int)cudaGetLastError();
}

}  // namespace conv_tf32
}  // namespace e2fgvi

// C1: out (N, H, W, Cout) = conv3x3(x) + bias, then LeakyReLU(slope) (1:
// none), then + res where res is not null; float32 throughout. x (N, H, W,
// Cin) with Cin a multiple of 4, 16-byte aligned; wk (2, Cout, 9 * Cin_pad)
// (kernels/conv.py conv_operands; Cin_pad = Cin rounded up to 32), 16-byte
// aligned; bias (Cout,); res and out (N, H, W, Cout), 8-byte aligned; Cout
// 128 or 432. Makes `device` current, launches on `stream`, returns
// cudaGetLastError() (nonzero: the launch was refused).
extern "C" int e2fgvi_conv3x3(const void* x, const void* wk,
                              const void* bias, const void* res, void* out,
                              int N, int H, int W, int Cin, int Cout,
                              float slope, int device, void* stream) {
  using namespace e2fgvi::conv_tf32;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= 0 || Cin % 4 != 0 || (Cout != 128 && Cout != 432))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  Params prm;
  prm.bias = static_cast<const float*>(bias);
  prm.res = static_cast<const float*>(res);
  prm.out = static_cast<float*>(out);
  prm.H = H, prm.W = W, prm.Cout = Cout;
  prm.chunks = (Cin + kBK - 1) / kBK;
  prm.tiles_x = (W + kTW - 1) / kTW;
  prm.slope = slope;
  // x as (C, W, H, N): the halo box {32, 18, 10, 1}
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 4,
                                 (cuuint64_t)W * Cin * 4,
                                 (cuuint64_t)H * W * Cin * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kBK, (cuuint32_t)kHW,
                             (cuuint32_t)kHH, 1};
  CUtensorMap xmap;
  if (!e2fgvi::hopper::encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x,
                                    dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const int K = 9 * prm.chunks * kBK;
  if (Cout == 128)
    return launch<128>(xmap, static_cast<const float*>(wk), prm, N, K, s);
  return launch<144>(xmap, static_cast<const float*>(wk), prm, N, K, s);
}
