// C: the port's float32 convolutions, stride 1, "same" padding, as one
// implicit-GEMM kernel on 3xTF32 wgmma, templated on the tap geometry
// (KH, KW) and the N-tile BN. Its callers:
// * feat_prop (models/feat_prop.py), and ProPainter's propagation through
//   it: the offset head's four 3x3 convolutions, 388->128, 128->128,
//   128->128, 128->432, and the backbone's two, 256 or 384->128 and
//   128->128 (ProPainter's 261 and 258 padded to 264 and 260), with
//   LeakyReLU and the backbone's residual add (`feat_prop + conv(...)`);
// * RAFT's update block (models/raft.py update and refine): the motion
//   encoder's convc1 (1x1, 324->256), convc2 (3x3, 256->192), convf2
//   (3x3, 128->64) and conv (3x3, 256->126), the separable GRU's 1x5 and
//   5x1 z and r (stacked: 384->256) and q (384->128), the flow head's two
//   3x3 (128->256, 256->2) and the mask head's 3x3 (128->256) and 1x1
//   (256->576), reading and writing channel ranges of one state buffer;
// * the E2FGVI encoder's seven stride-1 3x3 convolutions, with LeakyReLU
//   (models/e2fgvi.py Encoder): 64->64 at 1/2 resolution, then 128->256,
//   256->384 and 512->128 at 1/4, and the grouped 640->512 (2 groups),
//   768->384 (4) and 640->256 (8) as one launch a group, each reading and
//   writing its group's channel range of one input and one output.
//
// Replaces no TPU kernel: the JAX package left feat_prop's and the
// encoder's convolutions to XLA and has no RAFT. On the card cuDNN ran
// feat_prop's in float32 (TF32 off) as FFT convolutions (complex-float32
// GEMMs) at about 1% of the 3xTF32 rate, three quarters of the f32 serving
// time, and the encoder's the same way (the encode stage at 2.7% of that
// rate, 44% of the f32 serving time once feat_prop was on C); RAFT's ran
// as a pad copy, a copy of the whole (kh*kw*Cin)-wide patch matrix and
// cuBLAS's float32 GEMM (the SIMT FFMA path at 67 TFLOP/s at best), about
// four fifths of ProPainter's serving time.
//
// The GEMM: M = N*H*W output pixels x K = kh*kw*Cin x Cout. Precision as
// the f32 K1 (deform.cu, namespace fused_tf32): each operand splits into
// tf32 big and small parts, each product is small*big + big*small +
// big*big (small*small, ~2^-22 relative, dropped), and, since the tensor
// cores truncate the float32 sums they chain, each 32-wide K chunk's 12
// wgmma start from zero in one accumulator that joins the running sum by a
// rounded add. K runs to 9*416 = 3,744 at Cin 388 (117 chunks).
//
// What bounds it on the H100: operations. At feat_prop's serving shapes
// (60x108 maps, N = 4 windows) the six convolutions of one propagation
// step are 91 GFLOP of float32 work, 273 GFLOP of TF32 products: 0.55 ms
// at 495 TFLOP/s. One field's update-block iteration at 60x106 (848x480 /
// 8) is ~34 GFLOP of float32 work, 102 GFLOP of TF32 products; 40 a frame
// (two fields, 20 iterations) 8.2 ms at 495 TFLOP/s. Beside the tensor
// cores:
// * L2: every block streams its N-tile's whole weight, big and small, 8
//   bytes per (k, n) for its 128 pixels: ~21 bytes a clock an SM at the
//   TF32 peak, near L2's rate card-wide. Hence 128-pixel tiles (a 64-pixel
//   tile would double it).
// * Shared memory's 128 bytes a clock: wgmma reads B from shared memory
//   (big twice and small once a k-step, per warpgroup). A is read once a
//   chunk by plain loads and split in registers, never written back.
//
// The design:
// * One block per 16 x 8-pixel tile of one map and one N-tile of Cout,
//   blockIdx.x the N-tile, so a tile's N-tiles run side by side and share
//   its input in L2. N-tiles: 128; 144 (432 = 3 x 144, 576 = 4 x 144:
//   m64n144 is a width wgmma takes, and 432 leaves no ragged tile; on the
//   H100 a 128 -> 432 call took 0.26-0.28 ms at 60x108, N = 4, against
//   0.30-0.31 for 128-wide tiles with a ragged fourth); 96 (192 = 2 x 96),
//   64, 32 (the encoder's 8-group layer: 32 outputs a group) and 8 (Cout
//   2). A ragged tile (126 on 128) stores only the columns below Cout. At
//   60x108 a map is 7 x 8 tiles (9.6% of the rows fall past the edges and
//   are computed as zeros, not stored), 56 blocks a map: at
//   N = 4, 224 blocks on 132 SMs; at N = 1 the card is under half full
//   (that 128 -> 432 call reads 35% of its bound there, 56-59% at N = 4).
//   Smaller tiles would fill it but read the weight from L2 once more per
//   pixel; the f32 serving batches are mostly N = 4 (54 windows in 15
//   batches a DAVIS pass), so the tile stays. At N = 16 fields of 60x106 a
//   launch has 896 blocks of 128 pixels.
// * Chunk q = c * kh * kw + tap takes channels 32c .. 32c + 31 of one tap.
//   A, the input, arrives by TMA once per 32-channel chunk as the tile's
//   halo, a 4-D box {32, 16 + kw - 1, 8 + kh - 1, 1} of a (C, W, H, N)
//   tensor map at (32c, x0 - kw/2, y0 - kh/2, n) (3x3: {32, 18, 10, 1},
//   23 KB). TMA fills the box's elements outside the map with zeros, which
//   is the padding, and its channels past Cin (388 = 12 x 32 + 4) too. The
//   map's pixel pitch may exceed Cin: the input may be a channel range of a
//   wider buffer (the GRU's [net, x] and [x, r*net] are ranges of one state
//   buffer), so nothing is padded, copied or concatenated on the host side.
//   Every tap of a chunk reads the same halo, shifted: 1/9 of the L2 reads
//   of one box per (tap, chunk) at 3x3. The halo is double-buffered (four
//   deep for 1x1, where a chunk is one tap).
// * A from registers (wgmma's RS form): a thread's rows are pixels g and
//   g + 8 of its warp's tile row, and for every tap it loads its two rows'
//   32 bytes of channels 8t .. 8t + 7 (two 16-byte loads a row, free of
//   bank conflicts under the 128-byte swizzle), splits them in registers,
//   and hands k-step kk channels 8t + 2kk (k-column t) and 8t + 2kk + 1
//   (k-column t + 4). The sum over K is order-free, so B's columns are
//   permuted to match on the host (kernels/conv.py conv_weight).
// * B, the weight, reordered and split once per pass (feat_prop), refine
//   (RAFT) or call (the encoder) to (2, Cout_pad, kh * kw * Cin_pad),
//   K-major, big then small, zero past Cin and rows past Cout: a 3-D TMA
//   box {32, BN, 2} a chunk into a 4-stage ring.
// * A producer warpgroup (setmaxnreg 24) whose thread 0 issues the halo and
//   weight copies, and two consumer warpgroups (setmaxnreg 240) of 64 rows:
//   each holds the chunk's accumulator and the running sum (2 x BN / 2
//   registers) and the chunk's A fragments (big, small and the next
//   chunk's raw values). While chunk q's 12 wgmma run, the warpgroup loads
//   chunk q + 1's raw values; the two warpgroups' gaps (the split, the
//   rounded join) fill each other's tensor time.
// * Epilogue (Mode): bias, then none, ReLU, LeakyReLU(slope), the GRU's
//   stacked z and r (sigmoid; columns below `half` store z, the rest
//   r * net), or the GRU's q (net = (1 - z) * net + z * tanh(q), written
//   over net); then, where given, a residual added (none, ReLU and
//   LeakyReLU only, whole N-tiles only). float2 stores at a pixel pitch of
//   their own: outputs may land in channel ranges of a wider buffer. The
//   GRU's two run a loop of their own, the others straight-line ones (see
//   there). A small share of the time, so no shared-memory staging.
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

constexpr int kTW = 16, kTH = 8;  // output tile, pixels
constexpr int kBK = 32;           // K chunk: 32 channels of a tap
constexpr int kStages = 4;        // the weight's ring
constexpr int kConsumers = 256;
constexpr int kThreads = 128 + kConsumers;

enum Mode : int { kNone = 0, kRelu = 1, kZR = 2, kGRU = 3, kLeaky = 4 };

template <int KH, int KW, int BN>
struct Layout {
  static constexpr int kTaps = KH * KW;
  static constexpr int kHW = kTW + KW - 1, kHH = kTH + KH - 1;  // halo
  static constexpr int kHalo = kHW * kHH * kBK * 4;
  static constexpr int kHaloStage = (kHalo + 1023) / 1024 * 1024;
  static constexpr int kHStages = kTaps == 1 ? 4 : 2;
  static constexpr int kBTile = BN * kBK * 4;       // big or small
  static constexpr int kBStage = 2 * kBTile;
  static constexpr int kBOff = kHStages * kHaloStage;
  static constexpr int kBarOff = kBOff + kStages * kBStage;
  // full and empty of each weight stage and halo buffer; + 1 KB to align
  // the base to the 128-byte swizzle's 1024-byte period
  static constexpr int kSmem = kBarOff + 8 * 2 * (kStages + kHStages) + 1024;
  static_assert(kSmem <= 232448, "227 KB a block");
  static_assert(kBTile % 1024 == 0, "B tiles on the swizzle's period");
};

struct Params {
  const float* bias;   // (Cout_pad,)
  float* out;          // pixel p, column j at out[p * ldo + j]
  float* z;            // kZR: z's destination; kGRU: z; pixel pitch ldz
  const float* net;    // kZR, kGRU: the hidden state; pixel pitch ldn
  const float* res;    // the residual or null; pixel pitch ldr
  int ldo, ldz, ldn, ldr;
  int H, W, Cout, chunks, tiles_x, mode, half;
  float slope;         // kLeaky's
};

__device__ __forceinline__ void ld_shared_v4(uint32_t addr, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (BN == 8)
    hopper::wgmma_tf32_rs_n8(d, a, db, accumulate);
  else if constexpr (BN == 32)
    hopper::wgmma_tf32_rs_n32(d, a, db, accumulate);
  else if constexpr (BN == 64)
    hopper::wgmma_tf32_rs_n64(d, a, db, accumulate);
  else if constexpr (BN == 96)
    hopper::wgmma_tf32_rs_n96(d, a, db, accumulate);
  else if constexpr (BN == 128)
    hopper::wgmma_tf32_rs(d, a, db, accumulate);
  else
    hopper::wgmma_tf32_rs_n144(d, a, db, accumulate);
}

template <int KH, int KW, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ Params p) {
  using L = Layout<KH, KW, BN>;
  constexpr int T = L::kTaps, HS = L::kHStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sH = base, sB = base + L::kBOff;
  const uint32_t bfull = base + L::kBarOff, bempty = bfull + 8 * kStages;
  const uint32_t hfull = bempty + 8 * kStages, hempty = hfull + 8 * HS;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int x0 = (blockIdx.y % p.tiles_x) * kTW;
  const int y0 = (blockIdx.y / p.tiles_x) * kTH;
  const int n = blockIdx.z;
  const int Q = T * p.chunks;               // K chunks: (channel chunk, tap)

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bfull + 8 * s, 1);
      mbar_init(bempty + 8 * s, kConsumers);
    }
    for (int h = 0; h < HS; ++h) {
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
        const int c = q / T;
        if (q == T * c) {
          const int hb = c % HS;
          mbar_wait(hempty + 8 * hb, ((c / HS) & 1) ^ 1);
          mbar_expect_tx(hfull + 8 * hb, L::kHalo);
          hopper::tma_load_4d(sH + hb * L::kHaloStage, &xmap, hfull + 8 * hb,
                              c * kBK, x0 - KW / 2, y0 - KH / 2, n);
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
    const int c = q / T, tap = q - T * c;
    const int ky = tap / KW, kx = tap - KW * ky;
    const uint32_t halo = sH + (c % HS) * L::kHaloStage;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hr = (ty + ky) * L::kHW + g + 8 * r + kx;
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
    const int c = q / T;
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
      const int cn = (q + 1) / T;
      if (q + 1 == T * cn) mbar_wait(hfull + 8 * (cn % HS), (cn / HS) & 1);
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
    mbar_arrive(bempty + 8 * s);                       // chunk q's weight
    if (q == T * c + T - 1) mbar_arrive(hempty + 8 * (c % HS));  // its halo
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sum[j] += acc[j];
  }

  // sum[4i + e]: row g (e < 2) or g + 8, column 8i + 2t + (e & 1)
  const int y = y0 + ty;
  if (y >= p.H) return;
  // The bias (padded to Cout_pad) is loaded up front, each row's output
  // and residual addresses formed once, and the modes but the GRU's two
  // picked by selects. A loop that branched on the mode and on Cout at
  // every column and loaded the bias behind those branches, one column's
  // load latency after another, cost feat_prop's launches 10-19% of their
  // device time against a straight-line loop (H100, 60x108, N = 4).
  float2 bias[BN / 8];
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
    bias[i] = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * i +
                                                     2 * t));
  const bool gru = p.mode == kZR || p.mode == kGRU, relu = p.mode == kRelu;
  const float slope = p.mode == kLeaky ? p.slope : 1.f;   // 1: none
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int x = x0 + g + 8 * r;
    if (x >= p.W) continue;
    const long long pix = ((long long)n * p.H + y) * p.W + x;
    if (gru) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * t;
        if (col >= p.Cout) continue;     // a ragged N-tile's last columns
        float v0 = sum[4 * i + 2 * r] + bias[i].x,
              v1 = sum[4 * i + 2 * r + 1] + bias[i].y;
        float* dst = p.out + pix * p.ldo + col;
        if (p.mode == kZR) {
          v0 = sigmoid(v0);
          v1 = sigmoid(v1);
          if (col < p.half) {
            dst = p.z + pix * p.ldz + col;
          } else {
            const float2 h = *reinterpret_cast<const float2*>(
                p.net + pix * p.ldn + col - p.half);
            v0 *= h.x;
            v1 *= h.y;
            dst = p.out + pix * p.ldo + col - p.half;
          }
        } else {
          // net is read here and overwritten by the same thread
          const float2 zz =
              *reinterpret_cast<const float2*>(p.z + pix * p.ldz + col);
          const float2 h =
              *reinterpret_cast<const float2*>(p.net + pix * p.ldn + col);
          v0 = (1.f - zz.x) * h.x + zz.x * tanhf(v0);
          v1 = (1.f - zz.y) * h.y + zz.y * tanhf(v1);
        }
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      }
      continue;
    }
    // this row's columns 2t, 2t + 1 of the N-tile, then every eighth
    float* o = p.out + pix * p.ldo + n0 + 2 * t;
    if (p.res != nullptr) {
      // whole N-tiles only (the launcher refuses others): no guard between
      // the columns, so their residual loads issue together
      const float* rs = p.res + pix * p.ldr + n0 + 2 * t;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float2 rv = __ldg(reinterpret_cast<const float2*>(rs + 8 * i));
        float v0 = sum[4 * i + 2 * r] + bias[i].x,
              v1 = sum[4 * i + 2 * r + 1] + bias[i].y;
        const float a0 = v0 > 0.f ? v0 : v0 * slope,
                    a1 = v1 > 0.f ? v1 : v1 * slope;
        v0 = relu ? fmaxf(v0, 0.f) : a0;
        v1 = relu ? fmaxf(v1, 0.f) : a1;
        *reinterpret_cast<float2*>(o + 8 * i) =
            make_float2(rv.x + v0, rv.y + v1);
      }
      continue;
    }
    const int live = p.Cout - n0 - 2 * t;  // columns from here on: past Cout
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if (8 * i >= live) break;
      float v0 = sum[4 * i + 2 * r] + bias[i].x,
            v1 = sum[4 * i + 2 * r + 1] + bias[i].y;
      const float a0 = v0 > 0.f ? v0 : v0 * slope,
                  a1 = v1 > 0.f ? v1 : v1 * slope;
      v0 = relu ? fmaxf(v0, 0.f) : a0;
      v1 = relu ? fmaxf(v1, 0.f) : a1;
      *reinterpret_cast<float2*>(o + 8 * i) = make_float2(v0, v1);
    }
  }
}

template <int KH, int KW, int BN>
int launch(const CUtensorMap& xmap, const float* wk, const Params& prm,
           int N, int K, int cout_pad, cudaStream_t stream) {
  using L = Layout<KH, KW, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_tf32_kernel<KH, KW, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)cout_pad, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4,
                                 (cuuint64_t)K * 4 * cout_pad};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)BN, 2};
  CUtensorMap wmap;
  if (!hopper::encode_sw128(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wk, dims,
                           strides, box))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)prm.tiles_x * ((prm.H + kTH - 1) / kTH);
  if (tiles > 65535 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(cout_pad / BN, (unsigned)tiles, N);
  conv_tf32_kernel<KH, KW, BN><<<grid, kThreads, L::kSmem, stream>>>(
      xmap, wmap, prm);
  return (int)cudaGetLastError();
}

}  // namespace conv_tf32
}  // namespace e2fgvi

// The launch's arguments, eight bytes each, in this order (kernels/conv.py
// launch packs them into one int64 array: a call with 22 separate ctypes
// arguments cost more host time than some of these launches take).
struct LaunchArgs {
  const void* x;
  long long ldx;
  const void* wk;
  const void* bias;
  void* out;
  long long ldo;
  void* z;
  long long ldz;
  const void* net;
  long long ldn;
  const void* res;
  long long ldr;
  long long N, H, W, Cin, Cout, kh, kw, bn, mode;
};

// C: out = epilogue(conv(x) + bias) [+ res], float32 throughout. x: (N, H,
// W, Cin) with a pixel pitch of ldx channels (ldx >= Cin, both multiples of
// 4), 16-byte aligned; wk (2, Cout_pad, kh * kw * Cin_pad) (kernels/conv.py
// conv_operands; Cout_pad = Cout rounded up to bn, Cin_pad to 32), 16-byte
// aligned; bias (Cout_pad,); out, z, net and res at pixel pitches ldo, ldz,
// ldn, ldr (even), 8-byte aligned; Cout even; (kh, kw, bn) one of the
// instantiations below. mode 0: none; 1: ReLU; 2: sigmoid, columns below
// Cout / 2 to z, the others times net[column - Cout / 2] to out[column -
// Cout / 2]; 3: out = (1 - z) * net + z * tanh(.); 4: LeakyReLU(slope).
// res, where not null (modes 0, 1 and 4; Cout a multiple of bn), is added
// last. Makes `device` current, launches on `stream`, returns
// cudaGetLastError() (nonzero: the launch was refused).
extern "C" int e2fgvi_conv(const LaunchArgs* a, float slope, int device,
                           void* stream) {
  using namespace e2fgvi::conv_tf32;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = (int)a->N, H = (int)a->H, W = (int)a->W, Cin = (int)a->Cin,
            Cout = (int)a->Cout, kh = (int)a->kh, kw = (int)a->kw,
            bn = (int)a->bn, mode = (int)a->mode;
  const long long ldx = a->ldx;
  if (Cin <= 0 || Cin % 4 != 0 || ldx < Cin || ldx % 4 != 0 || Cout <= 0 ||
      Cout % 2 != 0 || bn <= 0 || mode < kNone || mode > kLeaky ||
      (a->res != nullptr && (mode == kZR || mode == kGRU || Cout % bn)))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  Params prm;
  prm.bias = static_cast<const float*>(a->bias);
  prm.out = static_cast<float*>(a->out);
  prm.z = static_cast<float*>(a->z);
  prm.net = static_cast<const float*>(a->net);
  prm.res = static_cast<const float*>(a->res);
  prm.ldo = (int)a->ldo, prm.ldz = (int)a->ldz, prm.ldn = (int)a->ldn;
  prm.ldr = (int)a->ldr;
  prm.H = H, prm.W = W, prm.Cout = Cout;
  prm.chunks = (Cin + kBK - 1) / kBK;
  prm.tiles_x = (W + kTW - 1) / kTW;
  prm.mode = mode, prm.half = Cout / 2;
  prm.slope = slope;
  // x as (C, W, H, N) at a pixel pitch of ldx: the halo box
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)ldx * 4,
                                 (cuuint64_t)W * ldx * 4,
                                 (cuuint64_t)H * W * ldx * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kBK, (cuuint32_t)(kTW + kw - 1),
                             (cuuint32_t)(kTH + kh - 1), 1};
  CUtensorMap xmap;
  if (!e2fgvi::hopper::encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                    a->x, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  const int K = kh * kw * prm.chunks * kBK;
  const int cout_pad = (Cout + bn - 1) / bn * bn;
  const float* w = static_cast<const float*>(a->wk);
#define E2FGVI_CONV(KH, KW, BN)                                    \
  if (kh == KH && kw == KW && bn == BN)                            \
    return launch<KH, KW, BN>(xmap, w, prm, N, K, cout_pad, s);
  E2FGVI_CONV(1, 1, 128)
  E2FGVI_CONV(1, 1, 144)
  E2FGVI_CONV(3, 3, 8)
  E2FGVI_CONV(3, 3, 32)
  E2FGVI_CONV(3, 3, 64)
  E2FGVI_CONV(3, 3, 96)
  E2FGVI_CONV(3, 3, 128)
  E2FGVI_CONV(3, 3, 144)
  E2FGVI_CONV(1, 5, 128)
  E2FGVI_CONV(5, 1, 128)
#undef E2FGVI_CONV
  return (int)cudaErrorInvalidValue;
}
