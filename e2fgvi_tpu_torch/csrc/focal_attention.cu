// K3 focal_attention: softmax over one key panel for every
// (batch, window, head) of the temporal focal transformer (models/tfocal.py).
//
// Replaces the TPU kernel e2fgvi_tpu/kernels/fused_attention.py::_kernel
// (built by _build, entry fused_focal_attention). The TPU kernel read the
// window's own keys and its gathered rolled + pooled keys as two panels;
// here the caller assembles both into one contiguous panel per (b, head,
// window): q is (B*heads*nWin, nq, hd), k and v are (B*heads*nWin, nk, hd)
// with nk = no + T*S, the float32 bias is one row per (b, window) of ld >= nk
// floats with -inf past nk, and each head writes its hd-wide stripe of the
// (B*nWin, nq, heads*hd) output, ready for the proj GEMM.
//
// Where the TPU kernel held a whole window's logits in VMEM (~100 MB
// scoped), a Hopper block has at most 227 KB of shared memory, so both
// dtypes run a flash loop: a block walks key tiles of the panel with a
// running max and sum per query row (online softmax). The work at serving
// shapes (B=14, 16 windows, 4 heads, nq=765, nk = 765 + 17*125, hd=128) is
// ~1.0 TFLOP of q.k and p.v per call against ~1.7 GB of inputs: compute
// bound on the tensor cores (~1.0 ms at 989 TFLOP/s bf16), in both dtypes.
//
// - bfloat16, the serving path (namespace hopper): wgmma fed by TMA, with a
//   producer warpgroup. See the note there.
// - float32, the parity path (namespace tf32): 3xTF32 on m16n8k8. One TF32
//   pass keeps 10 mantissa bits and lands ~1e-4 off; the port pins full
//   float32 precision. Each operand x splits into big = rna_tf32(x) and
//   small = rna_tf32(x - big), and each product is small*big + big*small +
//   big*big in float32 (small*small, ~2^-22 relative, is dropped). The
//   tensor cores truncate every float32 accumulation toward zero, so the
//   error also grows with the mma steps chained into one accumulator: the
//   logits keep big*big apart from the corrections, and each key tile's
//   P V sum starts from zero and joins O by a rounded add. Together this
//   lands closer to float64 than the plain float32 version does.
//   What bounds it: the TF32 work is 3x (3.0 TFLOP per serving call), and
//   every warp splits the K, V, Q and P values it reads, ~5 instructions
//   per value, 4 of them integer: the split's integer work and mma.sync's
//   TF32 rate share the time, not the loads. The design:
//   * 128 queries on 8 warps per block (16 rows each): a K/V tile in shared
//     memory serves 128 queries; 8 warps are resident per SM.
//   * K/V tiles land by 16-byte cp.async copies (the biases by 4-byte
//     ones), double-buffered: tile j+1 loads while tile j runs; one
//     barrier per tile.
//   * The logits, softmax state and the 16x128 output accumulator stay in
//     registers. P never goes through shared memory: the m16n8 accumulator
//     gives a thread keys 2t, 2t+1 and the tf32 A fragment wants k-columns
//     t, t+4, so V's rows are read in that permuted order (the sum over
//     keys is order-free). Likewise Q/K dims and V/output columns are
//     permuted so that every fragment load is one 16-byte ld.shared.
//   * Tiles are 128-float rows with an XOR swizzle of the 16-byte chunk, so
//     all three fragment loads are free of bank conflicts.
// Reading keys in place, with no gather, is E2 (band_attention.cu).
//
// The biases are finite (-100 outside the pooled grid, ln(multiplicity) on
// deduped slots, -1e9 on padding frames); keys past the panel's end get
// -inf. Every key tile holds at least one in-range key, so the running max
// is finite after the first tile and no row is ever all -inf.
#include <cmath>
#include <cstdint>

#include "attention_wgmma.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace e2fgvi {

// ---------------------------------------------------------------------------
// float32: 3xTF32 flash loop
// ---------------------------------------------------------------------------
namespace tf32 {

constexpr int kBQ = 128;            // queries per block: 8 warps x 16 rows
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = kBQ / 16 * 32;
constexpr int kRowStep = kThreads / 32;  // rows per pass of the copies
constexpr int kTile = kBK * kHD;    // floats in one K or V stage
constexpr int kSmemBytes =
    (kBQ * kHD + 2 * (2 * kTile + kBK)) * (int)sizeof(float);  // 197,120

// Float offset of 16-byte chunk `chunk` (0..31) of row r in a tile of
// 128-float rows. The chunk index is XORed with r's low three bits
// (bit 0 -> chunk bit 2, bits 1-2 -> chunk bits 0-1): the Q/K loads (rows
// g, chunk 4c+t) and the V loads (rows 2t+j, chunk 4g+qq) then each hit 8
// distinct 4-bank groups per quarter warp.
__device__ __forceinline__ int swz(int r, int chunk) {
  return r * kHD + ((chunk ^ (((r & 1) << 2) | ((r >> 1) & 3))) << 2);
}

// 16-byte copy to shared memory; src_ok false writes zeros and reads
// nothing from src
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a * b in 3xTF32 (a: the A fragment a0..a3, b = (b0, b1)): hi += big*big,
// lo += small*big + big*small. The tensor cores truncate each float32
// accumulation toward zero, so the error grows with the number of mma
// steps chained into one accumulator at full magnitude; the logits keep
// the corrections (~2^-11 of it) apart, which leaves big*big one step per
// k-step. P V passes one accumulator as both: its chains end every tile.
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const Split (&a)[4], Split b0,
                                     Split b1) {
  mma_tf32(lo, a[0].small, a[1].small, a[2].small, a[3].small, b0.big,
           b1.big);
  mma_tf32(lo, a[0].big, a[1].big, a[2].big, a[3].big, b0.small, b1.small);
  mma_tf32(hi, a[0].big, a[1].big, a[2].big, a[3].big, b0.big, b1.big);
}

__global__ void __launch_bounds__(kThreads, 1)
focal_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int heads, int nwin,
                            int nq, int nk, int ld) {
  extern __shared__ __align__(128) float smem[];
  float* Qs = smem;                   // [kBQ][kHD], swizzled
  float* Ks = Qs + kBQ * kHD;         // [2][kBK][kHD], swizzled
  float* Vs = Ks + 2 * kTile;         // [2][kBK][kHD], swizzled
  float* Bs = Vs + 2 * kTile;         // [2][kBK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group / column
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;              // b * nwin + w
  const int b = bw / nwin, w = bw % nwin;
  const long long panel = ((long long)b * heads + h) * nwin + w;
  const int tiles = (nk + kBK - 1) / kBK;
  const float* brow = bias + (long long)bw * ld;

  // the copies: thread tid moves chunk tid % 32 of rows
  // tid / 32 + kRowStep * i
  const int cc = tid & 31, cr = tid >> 5;
  for (int i = 0; i < kBQ / kRowStep; ++i) {
    const int r = cr + kRowStep * i;
    const bool ok = q0 + r < nq;
    cp_async16(Qs + swz(r, cc),
               ok ? q + (panel * nq + q0 + r) * kHD + cc * 4 : q, ok);
  }
  auto load_tile = [&](int it, int st) {
    const int j0 = it * kBK;
#pragma unroll
    for (int i = 0; i < kBK / kRowStep; ++i) {
      const int r = cr + kRowStep * i;
      const int jj = j0 + r;
      const bool ok = jj < nk;
      const long long off = ok ? (panel * nk + jj) * kHD + cc * 4 : 0;
      cp_async16(Ks + st * kTile + swz(r, cc), k + off, ok);
      cp_async16(Vs + st * kTile + swz(r, cc), v + off, ok);
    }
    if (tid < kBK) {
      const int jj = j0 + tid;
      const bool ok = jj < nk;
      cp_async4(Bs + st * kBK + tid, ok ? brow + jj : brow, ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // Per-thread fragment offsets. Q and K: row g (+8 for Q's second half),
  // dims 16c + 4t .. +3 of 16-dim chunk c; with the swizzle the chunk is
  // 4c + t XOR f(g), f(g) = ((g & 1) << 2) | (g >> 1): even and odd c take
  // two bases. V: rows 2t + j of each 8-key block, columns 16g + 4q .. +3.
  const int fq = ((g & 1) << 2) | (g >> 1);
  const int qk_base = g * kHD + ((t ^ (fq & 3)) << 2);
  const int qk_even = qk_base + ((fq & 4) << 2);
  const int qk_odd = qk_base - ((fq & 4) << 2);
  const float* Qw = Qs + warp * 16 * kHD;

  float o[kHD / 8][4];
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    // tile it (and Q) has landed and every warp is done with tile it - 1,
    // whose stage tile it + 1 now overwrites
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < tiles) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();

    const int st = it & 1;
    const float* Kt = Ks + st * kTile;
    const float* Vt = Vs + st * kTile;
    const float* Bt = Bs + st * kBK;
    const int lim = nk - it * kBK;

    // S (16 x 64) = Q K^T. In 16-dim chunk c, k-step 0 takes dims
    // 16c + 4t (A/B column t) and 16c + 4t + 1 (column t + 4), k-step 1
    // dims 16c + 4t + 2 and + 3: one float4 feeds both k-steps.
    float s[kBK / 8][4] = {}, sl[kBK / 8][4] = {};
#pragma unroll
    for (int c = 0; c < kHD / 16; ++c) {
      const int off = ((c & 1) ? qk_odd : qk_even) + c * 16;
      const float4 qa = *reinterpret_cast<const float4*>(Qw + off);
      const float4 qb = *reinterpret_cast<const float4*>(Qw + 8 * kHD + off);
      const Split a0[4] = {split(qa.x), split(qb.x), split(qa.y), split(qb.y)};
      const Split a1[4] = {split(qa.z), split(qb.z), split(qa.w), split(qb.w)};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Kt + n * 8 * kHD + off);
        mma3(s[n], sl[n], a0, split(kv.x), split(kv.y));
        mma3(s[n], sl[n], a1, split(kv.z), split(kv.w));
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];

    // online softmax over rows g (s[n][0..1]) and g + 8 (s[n][2..3]);
    // key n*8 + 2t (+1) of the tile, -inf past the panel's end
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const int k0 = n * 8 + 2 * t;
      const float b0 = k0 < lim ? Bt[k0] : -INFINITY;
      const float b1 = k0 + 1 < lim ? Bt[k0 + 1] : -INFINITY;
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

    // O (16 x 128) += P (16 x 64) V. Key block n: A column t is key
    // n*8 + 2t (s[n][0], s[n][2]), column t + 4 key n*8 + 2t + 1, so B row
    // t is V row n*8 + 2t and row t + 4 is V row n*8 + 2t + 1. B column g
    // of output tile np is V column 16g + np: a thread's float4 qq of a V
    // row holds its B values for np = 4qq .. 4qq + 3. The tile's sum for
    // those 4 output tiles builds in a fresh accumulator (24 mma steps) and
    // joins O by a rounded add, so no accumulator chains mma steps across
    // tiles.
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      // rows 2t (j = 0) and 2t + 1 (j = 1) of a block: f = (j << 2) | t
      const int ch = 4 * g + qq;
      const float* V0 = Vt + 2 * t * kHD + ((ch ^ t) << 2);
      const float* V1 = Vt + (2 * t + 1) * kHD + ((ch ^ (4 | t)) << 2);
      float acc[4][4] = {};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float4 va = *reinterpret_cast<const float4*>(V0 + n * 8 * kHD);
        const float4 vb = *reinterpret_cast<const float4*>(V1 + n * 8 * kHD);
        const Split pn[4] = {split(s[n][0]), split(s[n][2]), split(s[n][1]),
                             split(s[n][3])};
        mma3(acc[0], acc[0], pn, split(va.x), split(vb.x));
        mma3(acc[1], acc[1], pn, split(va.y), split(vb.y));
        mma3(acc[2], acc[2], pn, split(va.z), split(vb.z));
        mma3(acc[3], acc[3], pn, split(va.w), split(vb.w));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[4 * qq + e][r] += acc[e][r];
    }
  }

  // o[np][0..1] are row g, output columns 32t + np and 32t + 16 + np
  // (B column 2t, 2t + 1 of tile np); [2..3] the same for row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const int ldo = heads * kHD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= nq) continue;
    const float inv = 1.f / l_r[i];
    float* dst = out + ((long long)bw * nq + r) * ldo + h * kHD + 32 * t;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float4*>(dst + 16 * j + 4 * qq) = make_float4(
            o[4 * qq][2 * i + j] * inv, o[4 * qq + 1][2 * i + j] * inv,
            o[4 * qq + 2][2 * i + j] * inv, o[4 * qq + 3][2 * i + j] * inv);
      }
    }
  }
}

int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int heads, int nwin, int nq, int nk, int ld,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      focal_attention_tf32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || nq == 0) return (int)cudaGetLastError();
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, B * nwin);
  focal_attention_tf32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), heads, nwin, nq, nk, ld);
  return (int)cudaGetLastError();
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA with a producer warpgroup
//
// What bounds it: the tensor cores (1.0 TFLOP per serving call against
// ~1.7 GB of inputs; each K/V tile is reused by 128 queries in shared
// memory) and, beside them, the softmax's exponentials: 128x128 per tile
// at 16 a clock on the SM's MUFU is half the time of the tile's two
// products at the dense bf16 rate. The design:
// * One block per (128-query tile, head, b*window), 3 warpgroups. The
//   producer warpgroup gives its registers away (setmaxnreg 24); one of its
//   threads issues every copy. The two consumer warpgroups (setmaxnreg
//   240) own 64 query rows each.
// * Q (128 x 128 bf16, 32 KB) lands once by TMA. K and V run through a
//   2-stage ring of 128-key x 128-dim tiles (4 x 32 KB) with full/empty
//   mbarriers, so the next tile's copies are in flight while the consumers
//   compute; the tile's 128 biases (512 B, -inf padded) ride the same
//   barrier by a bulk copy. ~162 KB: one block per SM.
// * Tensor maps are 3-D (hd, rows, panels) with 64-dim boxes and 128-byte
//   swizzle (a 128-dim row is two boxes); the ragged last key or query
//   tile reads zeros out of bounds instead of the next panel's rows, and
//   the -inf bias masks those keys.
// * S = Q K^T: 8 wgmma m64n128k16 with both operands K-major in shared
//   memory. The bias is added and the online softmax runs in registers: a
//   row's max and sum reduce over the 4 lanes of a quad.
// * O += P V: P is rounded to bf16 in registers (as the JAX kernel rounds
//   p to v's dtype; the row sums use the unrounded p) and is the register
//   A operand of 8 wgmma m64n128k16; V is the B operand, MN-major from the
//   same shared-memory tile (the transpose bit).
// * A stage returns to the producer once wgmma.wait_group shows that the
//   P V which read it is done. The epilogue normalizes by the row sum and
//   writes the head's bf16 stripe; rows past nq are not written.
// Not done yet: FA3's ping-pong between the two consumers and overlapping
// one tile's softmax with the next tile's Q K^T.
// The mbarrier, TMA and wgmma helpers are in hopper.cuh, shared with the
// bf16 K1 (deform.cu); the consumer loop is attention_wgmma.cuh's, shared
// with E2 (band_attention.cu), whose producer gathers the key rows itself.
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kTileBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kBiasOff = kVOff + kStages * kTileBytes;
constexpr int kBarOff = kBiasOff + kStages * kBK * 4;
constexpr int kBars = 1 + 2 * kStages;   // q full, full[], empty[]
// + 1 KB to align the base to the 128-byte swizzle's 1024-byte period
constexpr int kSmemBytes = kBarOff + 8 * kBars + 1024;

__global__ void __launch_bounds__(kThreads, 1)
focal_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float* __restrict__ bias,
                             bf16* __restrict__ out, int heads, int nwin,
                             int nq, int nk, int ld) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + kQOff, sK = base + kKOff, sV = base + kVOff;
  const uint32_t sB = base + kBiasOff;
  const float* bias_s =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + kBiasOff);
  const uint32_t q_full = base + kBarOff;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;               // b * nwin + w
  const int b = bw / nwin, w = bw - b * nwin;
  const int panel = (b * heads + h) * nwin + w;
  const int tiles = (nk + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: thread 0 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load(sQ, &qmap, q_full, 0, q0, panel);
      tma_load(sQ + kHalf, &qmap, q_full, kBox, q0, panel);
      const float* brow = bias + (long long)bw * ld;
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * kTileBytes + kBK * 4);
        const int k0 = j * kBK;
        const uint32_t ks = sK + s * kTileBytes, vs = sV + s * kTileBytes;
        tma_load(ks, &kmap, full, 0, k0, panel);
        tma_load(ks + kHalf, &kmap, full, kBox, k0, panel);
        tma_load(vs, &vmap, full, 0, k0, panel);
        tma_load(vs + kHalf, &vmap, full, kBox, k0, panel);
        bulk_load(sB + s * kBK * 4, brow + k0, kBK * 4, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    attention_consumer(
        tid, sQ, sK, sV, bias_s, full0, empty0, tiles, out, bw, q0, nq,
        heads, h, [&](int) { mbar_wait(q_full, 0); }, [] {});
  }
}

// (hd, rows, panels) bf16 as 64-dim x 128-row boxes, 128-byte swizzle;
// rows past `rows` read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int panels) {
  const cuuint64_t dims[3] = {(cuuint64_t)kHD, (cuuint64_t)rows,
                              (cuuint64_t)panels};
  const cuuint64_t strides[2] = {(cuuint64_t)kHD * 2,
                                 (cuuint64_t)rows * kHD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, 128, 1};
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims,
                      strides, box);
}

int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int heads, int nwin, int nq, int nk, int ld,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      focal_attention_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || nq == 0) return (int)cudaGetLastError();
  if (encoder() == nullptr || ld % kBK != 0 || ld < nk)
    return (int)cudaErrorInvalidValue;
  const int panels = B * heads * nwin;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, nq, panels) || !make_map(&kmap, k, nk, panels) ||
      !make_map(&vmap, v, nk, panels))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, B * nwin);
  focal_attention_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      qmap, kmap, vmap, static_cast<const float*>(bias),
      static_cast<bf16*>(out), heads, nwin, nq, nk, ld);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace e2fgvi

// Plain C entry point, loaded with ctypes (kernels/build.py). Makes
// `device` current for this library's runtime, launches on `stream` and
// returns cudaGetLastError(); hd must be 128 and the bias row stride ld a
// multiple of 128 (-inf past nk). bfloat16 runs the wgmma kernel, float32
// the 3xTF32 kernel.
extern "C" int e2fgvi_focal_attention(int dtype, const void* q,
                                      const void* k, const void* v,
                                      const void* bias, void* out, int B,
                                      int heads, int nwin, int nq, int nk,
                                      int ld, int hd, int device,
                                      void* stream) {
  if (hd != e2fgvi::kHD) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    return e2fgvi::hopper::launch(q, k, v, bias, out, B, heads, nwin, nq, nk,
                                  ld, s);
  }
  return e2fgvi::tf32::launch(q, k, v, bias, out, B, heads, nwin, nq, nk, ld,
                              s);
}
