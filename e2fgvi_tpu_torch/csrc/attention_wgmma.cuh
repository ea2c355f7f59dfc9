// The bf16 focal attention consumer shared by K3 (focal_attention.cu) and
// E2 (band_attention.cu): one consumer warpgroup's 64 query rows of a
// 128-query block, walking a 2-stage ring of 128-key K and V tiles on
// wgmma. The two kernels differ only in their producers (K3: TMA boxes of
// a gathered key panel; E2: cp.async row gathers from the qkv maps) and
// in what they do once Q or a tile has landed (the q_ready and tile_ready
// hooks).
//
// Shared memory, 128-byte swizzled as a TMA box of 64 dims x 128 rows
// lands: a 128 x 128 bf16 tile is two 16 KB halves (dims 0-63, 64-127);
// 16-byte chunk c of row r of a half sits at r * 128 + 16 (c ^ (r & 7)).
// A stage also holds its tile's 128 float32 key biases (-inf past the
// keys' end), and completes on its full mbarrier; the consumers arrive on
// its empty mbarrier (256 arrivals) once the P V that read it is done.
//
// Per tile: S = Q K^T on 8 wgmma m64n128k16 (both operands K-major in
// shared memory); the bias and an online softmax in registers (base 2; a
// row's max and sum reduce over the 4 lanes of a quad); P rounded to bf16
// as the register A operand of P V (the row sums use the unrounded p); V
// MN-major from the same tile (the transpose bit). The epilogue normalizes
// by the row sum and writes the head's bf16 stripe of the (B*nWin, nq,
// heads*128) output; rows past nq are not written.
#pragma once

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace e2fgvi {

constexpr int kHD = 128;  // head width

namespace hopper {

constexpr int kBQ = 128;                 // queries per block
constexpr int kBK = 128;                 // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBox = 64;                 // dims per TMA box: 128 bytes
constexpr int kHalf = 128 * kBox * 2;    // one 128-row box, 16 KB
constexpr int kTileBytes = 2 * kHalf;    // a 128 x 128 bf16 tile, 32 KB

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Consumer warpgroup tid / 128 - 1 of a block (tid 128..383, after its
// setmaxnreg.inc): q_ready(c) returns once this warpgroup's 64 rows of Q
// (at sQ) are ready for wgmma; tile_ready() runs after each stage's full
// barrier. bias_s: the stages' bias rows (kBK floats each).
template <typename QReady, typename TileReady>
__device__ __forceinline__ void attention_consumer(
    int tid, uint32_t sQ, uint32_t sK, uint32_t sV, const float* bias_s,
    uint32_t full0, uint32_t empty0, int tiles, bf16* __restrict__ out,
    int bw, int q0, int nq, int heads, int h, QReady&& q_ready,
    TileReady&& tile_ready) {
  const int c = tid / 128 - 1;           // consumer: query rows 64c ..
  const int warp = (tid / 32) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr float kLog2e = 1.4426950408889634f;

  // A operand: this warpgroup's 64 rows of Q, row r at 128 bytes in each
  // 64-dim box; k-step kk reads dims 16kk.. (box kk / 4, byte 32 (kk % 4))
  const uint32_t qa = sQ + c * 64 * 128;
  float sc[64], o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 (scaled by log2 e)
  float l_r[2] = {0.f, 0.f};

  q_ready(c);
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full0 + 8 * s, (j / kStages) & 1);
    tile_ready();
    const uint32_t ks = sK + s * kTileBytes, vs = sV + s * kTileBytes;

    // S (64 x 128 keys) = Q K^T
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kHalf + (kk & 3) * 32;
      wgmma_ss(sc, desc_sw128(qa + off, 16, 1024),
               desc_sw128(ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // sc[4i + e]: row g (e < 2) or g + 8, key 8i + 2t + (e & 1); logits
    // go to base 2 here: exp(x - m) = 2^(x log2e - m log2e)
    const float* bt = bias_s + s * kBK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * t);
      sc[4 * i] = (sc[4 * i] + bb.x) * kLog2e;
      sc[4 * i + 1] = (sc[4 * i + 1] + bb.y) * kLog2e;
      sc[4 * i + 2] = (sc[4 * i + 2] + bb.x) * kLog2e;
      sc[4 * i + 3] = (sc[4 * i + 3] + bb.y) * kLog2e;
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2_approx(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // P, rounded to bf16 as the A operand of P V: k-step kk covers keys
    // 16kk .. 16kk + 15, i.e. key blocks 2kk and 2kk + 1
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p0 = exp2_approx(sc[4 * i] - m_r[0]);
      const float p1 = exp2_approx(sc[4 * i + 1] - m_r[0]);
      const float p2 = exp2_approx(sc[4 * i + 2] - m_r[1]);
      const float p3 = exp2_approx(sc[4 * i + 3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pa[i >> 1][(i & 1) * 2] = pack_bf16(p0, p1);
      pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }

    // O (64 x 128 dims) += P V; V's k-step kk is keys 16kk.., 2 KB on.
    // MN-major: 64 dims in a 128-byte row, the next 64 dims one box
    // (16 KB) on (LBO), the next 8 keys 1 KB on (SBO)
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(o, pa[kk], desc_sw128(vs + kk * 2048, kHalf, 1024));
    wg_commit();
    wg_wait_all();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * s);
  }

  // o[4i + e]: row g (e < 2) or g + 8, dim 8i + 2t + (e & 1)
  const int ldo = heads * kHD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / l_r[r];
    bf16* dst = out + ((long long)bw * nq + row) * ldo + h * kHD + 2 * t;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv,
                                o[4 * i + 2 * r + 1] * inv);
    }
  }
}

}  // namespace hopper
}  // namespace e2fgvi
