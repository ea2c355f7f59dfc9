// The bfloat16 flash-attention tile loop on tensor cores of E2
// (band_attention.cu). It names no source of its own: the kernel passes
// load_tile a function giving the source of tile row r. (K3's bfloat16
// kernel, focal_attention.cu, runs on wgmma and TMA instead.)
//
// FlashAttention-2 style: 4 warps, each owning 16 of the block's 64 query
// rows. Products are mma.sync m16n8k16 (bf16 in, f32 accumulate) with
// operands fetched by ldmatrix from padded shared-memory tiles. The
// fragment layouts are fixed by the PTX ISA, so the logits, the
// online-softmax state and the 16x128 output accumulator all stay in
// registers: a thread holds rows g and g+8 (g = lane/4) of each 8-column
// tile, the logit accumulator doubles as the bf16 A operand of P V, and the
// per-row max reduces over the 4 lanes of a quad. P is rounded to bfloat16
// for P V, as the JAX kernel rounds p to v's dtype; the row sums use the
// unrounded p.
#pragma once

#include <cmath>

#include "common.cuh"

namespace e2fgvi {
namespace mma {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kHD = 128;       // head width
constexpr int kThreads = 128;
constexpr int kLd = kHD + 8;   // bf16 tile rows: 272 B, conflict-free ldmatrix
constexpr int kTileBytes = 64 * kLd * 2;

using bf16 = __nv_bfloat16;

// rows [0, 64) of 128-wide bf16 rows into shared memory as 16-byte chunks;
// src_of(r) gives the first element of tile row r, or nullptr for zeros
template <typename SrcFn>
__device__ __forceinline__ void load_tile(bf16* dst, SrcFn src_of) {
  for (int c = threadIdx.x; c < kBQ * (kHD / 8); c += kThreads) {
    const int r = c / (kHD / 8), cc = c % (kHD / 8);
    const bf16* src = src_of(r);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + cc * 8) = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// One warp's running state: its 16 query rows as 8 A fragments, the
// 16x128 output accumulator, and the max and partial sum of rows g, g+8.
struct Flash {
  unsigned qa[kHD / 16][4];
  float o[kHD / 8][4];
  float m_r[2];
  float l_r[2];

  // Qs holds the block's 64 query rows (load_tile); call after a barrier
  __device__ __forceinline__ void start(const bf16* Qs) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int ks = 0; ks < kHD / 16; ++ks)
      ldmatrix_x4(qa[ks], Qs + (warp * 16 + lr + 8 * (lm & 1)) * kLd +
                              ks * 16 + 8 * (lm >> 1));
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m_r[0] = m_r[1] = -INFINITY;
    l_r[0] = l_r[1] = 0.f;
  }

  // One 64-key tile: Ks/Vs rows and the per-key bias Bs (-inf past the
  // end) in shared memory, after a barrier.
  __device__ __forceinline__ void tile(const bf16* Ks, const bf16* Vs,
                                       const float* Bs) {
    const int lane = threadIdx.x & 31;
    const int tg = lane & 3;                     // fragment column pair
    const int lm = lane >> 3, lr = lane & 7;     // ldmatrix matrix / row

    // S (16 x 64) = Q K^T: 8 n-tiles of 8 keys, 8 k-steps of 16 dims
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHD / 32; ++kk) {
        unsigned kb[4];
        ldmatrix_x4(kb, Ks + (n * 8 + lr) * kLd + kk * 32 + 8 * lm);
        mma_bf16(s[n], qa[2 * kk], kb[0], kb[1]);
        mma_bf16(s[n], qa[2 * kk + 1], kb[2], kb[3]);
      }
    }

    // online softmax over rows g (s[n][0..1]) and g + 8 (s[n][2..3])
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float b0 = Bs[n * 8 + 2 * tg], b1 = Bs[n * 8 + 2 * tg + 1];
      s[n][0] += b0;
      s[n][1] += b1;
      s[n][2] += b0;
      s[n][3] += b1;
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = __expf(s[n][0] - m_r[0]);
      s[n][1] = __expf(s[n][1] - m_r[0]);
      s[n][2] = __expf(s[n][2] - m_r[1]);
      s[n][3] = __expf(s[n][3] - m_r[1]);
      l_r[0] += s[n][0] + s[n][1];
      l_r[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O (16 x 128) += P (16 x 64) V: the logit tiles 2kb and 2kb + 1 are
    // the A fragment of key block kb
#pragma unroll
    for (int kb = 0; kb < kBK / 16; ++kb) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kb][0], s[2 * kb][1]),
          pack_bf16(s[2 * kb][2], s[2 * kb][3]),
          pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
          pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int np = 0; np < kHD / 16; ++np) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, Vs + (kb * 16 + lr + 8 * (lm & 1)) * kLd +
                                  np * 16 + 8 * (lm >> 1));
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Normalize and write rows q0 + warp*16 + {g, g+8} (those < nq) of
  // out[(bw * nq + row) * ld + col0 ...], 128 columns.
  __device__ __forceinline__ void finish(bf16* __restrict__ out,
                                         long long bw, int q0, int nq,
                                         int ld, int col0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + warp * 16 + g + 8 * i;
      if (r >= nq) continue;
      const float inv = 1.f / l_r[i];
      bf16* dst = out + (bw * nq + r) * ld + col0 + 2 * tg;
#pragma unroll
      for (int n = 0; n < kHD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    }
  }
};

}  // namespace mma
}  // namespace e2fgvi
