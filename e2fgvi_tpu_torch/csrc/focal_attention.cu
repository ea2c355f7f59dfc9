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
// - float32, the parity path (namespace attn_tf32): 3xTF32 on tf32 wgmma
//   fed by TMA, the operands split into tf32 big and small parts in
//   shared memory. See the note there.
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
// float32: 3xTF32 on wgmma
//
// Precision: the port pins full float32, and one TF32 pass (10 mantissa
// bits) lands ~1e-4 off. So each operand x splits into big = rna_tf32(x)
// and small = rna_tf32(x - big), and each product is small*big +
// big*small + big*big in float32 (small*small, ~2^-22 relative, is
// dropped), as the f32 K1 does (deform.cu, namespace fused_tf32). The
// tensor cores truncate every float32 accumulation toward zero, so the
// error also grows with the steps chained into one accumulator: the logits
// keep big*big, big*small and small*big in three accumulators (16 k8
// steps each), and each key tile's P V (12 steps) starts from zero and
// joins O by one rounding, O = fma(O, alpha, PV). This lands closer to
// float64 than the plain float32 version does.
//
// What bounds it: operations. At serving shapes (B=14) the three products
// are 3.04 TFLOP of TF32 work, 6.15 ms at 495 TFLOP/s, against ~3 GB of
// inputs (0.9 ms at 3.35 TB/s). Beside the tensor cores, shared memory's
// 128 bytes a clock: S = Q K^T has 32-key B operands, and an SS wgmma
// m64n32k8 reads 3 KB of operands in its 16 clocks (on the H100, with S
// as three of them, each product took ~1.6x its time at the TF32 peak;
// stacking K big over K small cuts a k-step's reads from 9 KB to 7); and
// every K and V value is split once a block, ~6 instructions and 3
// shared accesses a value.
//
// The design (the choices the earlier tf32 kernel, 3xTF32 on mma.sync
// m16n8k8, did not face):
// * One block per (128-query tile, head, b*window), two consumer
//   warpgroups of 64 query rows and no producer warpgroup: each thread
//   holds O and the tile's P V (64 + 64 floats), the logits' two
//   accumulators (16 + 16) and P's big and small A fragments (16 + 16),
//   ~200 registers of the 255 a thread of a 256-thread block may have.
//   Thread 0 issues the TMA copies between the block's barriers.
// * Shared memory (224 KB of the 227): Q split into big and small (2 x 64
//   KB, split in place once Q has landed), a 32-key K tile split (2 x 16
//   KB, each 32-dim box's big rows over its small ones), a 32-key V tile
//   split and transposed (2 x 16 KB) and one raw landing stage each for K
//   and V (2 x 16 KB). 64-key tiles would need
//   256 KB; 64-query blocks would halve the reuse of every split K and V
//   tile; a pre-pass writing split copies of q, k and v would move ~9 GB
//   more through device memory a call (~2.7 ms). So the tiles are 32
//   keys, and S's B operand is 32 keys wide: per k-step, m64n64k8 takes
//   Q big against K big stacked over K small (big*big and big*small in
//   the two halves of one accumulator) and m64n32k8 Q small against K
//   big. P V is m64n128k8 with k = 4 steps of 8 keys.
// * Everything lands by TMA in 128-byte-swizzled boxes of 32 floats
//   (3-D maps (hd, rows, panels): the ragged last key or query tile reads
//   zeros, not the next panel's rows, and the -inf bias masks those keys),
//   the tile's 32 biases by a bulk copy beside K. The split K and the
//   big/small Q sit in the layout TMA wrote, so their split is elementwise
//   and in place. tf32 wgmma has no transposed B, so V goes to a (128 dims
//   x 32 keys) K-major tile while it is split: warp w takes the 16-byte
//   key chunk w of every dim row (keys 8(w/2) + (w%2) + 2u), lane e dims e
//   + 32x; its reads are whole 128-byte rows and its writes hit 8 distinct
//   chunks a quarter warp, free of bank conflicts.
// * P is the register A operand of P V. The m64 accumulator gives a
//   thread keys 2t and 2t + 1 of each 8-key block, the tf32 A fragment
//   wants k-columns t and t + 4; so the transposed V puts key 2u + h of a
//   block at k-column u + 4h (the sum over keys is order-free), and P
//   needs no shuffle.
// * The split work runs beside the tensor cores: while S_j runs, the
//   threads split V_j; while P_j V_j runs, they split K_{j+1}. Two block
//   barriers a tile hand the split tiles over (after the softmax: V_j is
//   whole, S_j is done; after P V: K_{j+1} is whole, V_j is free), and
//   after each, thread 0 refills the raw stage just read (V_{j+1}, then
//   K_{j+2} with its biases), so each landing has half to one and a half
//   tiles of compute to hide behind.
// * No atomics, one fixed order of every sum: a call is deterministic.
// ---------------------------------------------------------------------------
namespace attn_tf32 {

using hopper::desc_sw128;
using hopper::fence_proxy_async;
using hopper::fence_regs;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait;

constexpr int kBQ = 128;                 // queries per block
constexpr int kBK = 32;                  // keys per tile
constexpr int kThreads = 256;            // two consumer warpgroups
constexpr int kBox = 32;                 // floats per TMA box row: 128 B
constexpr int kQBox = kBQ * 128;         // one 32-dim box of Q, 16 KB
constexpr int kQBytes = 4 * kQBox;       // Q, 64 KB (big or small)
constexpr int kKBox = kBK * 128;         // one 32-dim box of a K tile, 4 KB
constexpr int kTile = 4 * kKBox;         // a 32 x 128 float tile, 16 KB
constexpr int kQBig = 0;
constexpr int kQSmall = kQBig + kQBytes;
// split K: 4 boxes of 32 dims, each its 32 big rows over its 32 small ones
constexpr int kKSplit = kQSmall + kQBytes;
constexpr int kVBig = kKSplit + 2 * kTile;  // split V^T: 128 dims x 32 keys
constexpr int kVSmall = kVBig + kTile;
constexpr int kKRaw = kVSmall + kTile;     // landing stages, as TMA wrote
constexpr int kVRaw = kKRaw + kTile;
constexpr int kBiasOff = kVRaw + kTile;    // 2 x 32 floats
constexpr int kBarOff = kBiasOff + 2 * kBK * 4;
// + 1 KB to align the base to the 128-byte swizzle's 1024-byte period
constexpr int kSmemBytes = kBarOff + 3 * 8 + 1024;   // 230,680
static_assert(kSmemBytes <= 232448, "227 KB a block");

// one float4 x at src -> rna_tf32(x) at big, the rest at small (big may
// be src)
__device__ __forceinline__ void split4(const float4* src, float4* big,
                                       float4* small) {
  const float4 x = *src;
  const Split a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
  *reinterpret_cast<uint4*>(big) = make_uint4(a.big, b.big, c.big, d.big);
  *reinterpret_cast<uint4*>(small) =
      make_uint4(a.small, b.small, c.small, d.small);
}

__global__ void __launch_bounds__(kThreads, 1)
focal_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const float* __restrict__ bias,
                              float* __restrict__ out, int heads, int nwin,
                              int nq, int nk, int ld) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);   // generic view
  const uint32_t q_full = base + kBarOff, k_full = q_full + 8,
                 v_full = q_full + 16;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;               // b * nwin + w
  const int b = bw / nwin, w = bw - b * nwin;
  const int panel = (b * heads + h) * nwin + w;
  const int tiles = (nk + kBK - 1) / kBK;
  const float* brow = bias + (long long)bw * ld;

  // thread 0: raw K tile j (four 32-dim boxes) and its biases into bias
  // slot j & 1; raw V tile j
  auto load_k = [&](int j) {
    mbar_expect_tx(k_full, kTile + kBK * 4);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      hopper::tma_load(base + kKRaw + x * kKBox, &kmap, k_full, kBox * x,
                       j * kBK, panel);
    hopper::bulk_load(base + kBiasOff + (j & 1) * kBK * 4, brow + j * kBK,
                      kBK * 4, k_full);
  };
  auto load_v = [&](int j) {
    mbar_expect_tx(v_full, kTile);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      hopper::tma_load(base + kVRaw + x * kKBox, &vmap, v_full, kBox * x,
                       j * kBK, panel);
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, kQBytes);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      hopper::tma_load(base + kQBig + x * kQBox, &qmap, q_full, kBox * x, q0,
                       panel);
    load_k(0);
    load_v(0);
  }
  __syncthreads();

  // the landed raw K tile into split K, each box's 4 KB of big rows over
  // its small ones (TMA's layout: rows 32 apart share their swizzle)
  auto split_k = [&]() {
    const float4* kr = reinterpret_cast<const float4*>(sm + kKRaw);
    float4* ksp = reinterpret_cast<float4*>(sm + kKSplit);
#pragma unroll
    for (int i = tid; i < kTile / 16; i += kThreads) {
      float4* big = ksp + i + (i / (kKBox / 16)) * (kKBox / 16);
      split4(kr + i, big, big + kKBox / 16);
    }
  };
  // the landed raw V tile into split V^T: row d (dim) of 128 bytes holds
  // the tile's keys in k-column order, key 8i + 2u + hh at column 8i + 4hh
  // + u. Warp vw writes 16-byte chunk vw of every row (i = vw / 2, hh =
  // vw % 2: keys 8i + hh + 2u, u = 0..3); lane ve dims ve + 32x.
  const int vw = tid >> 5, ve = tid & 31;
  auto split_v = [&]() {
    float x[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kr = 8 * (vw >> 1) + (vw & 1) + 2 * u;
      const unsigned char* row = sm + kVRaw + kr * 128 +
                                 ((((ve >> 2) ^ (kr & 7)) << 4) |
                                  ((ve & 3) << 2));
#pragma unroll
      for (int xb = 0; xb < 4; ++xb)
        x[xb][u] = *reinterpret_cast<const float*>(row + xb * kKBox);
    }
#pragma unroll
    for (int xb = 0; xb < 4; ++xb) {
      const int d = ve + 32 * xb;
      const int off = d * 128 + ((vw ^ (d & 7)) << 4);
      const Split s0 = split(x[xb][0]), s1 = split(x[xb][1]),
                  s2 = split(x[xb][2]), s3 = split(x[xb][3]);
      *reinterpret_cast<uint4*>(sm + kVBig + off) =
          make_uint4(s0.big, s1.big, s2.big, s3.big);
      *reinterpret_cast<uint4*>(sm + kVSmall + off) =
          make_uint4(s0.small, s1.small, s2.small, s3.small);
    }
  };

  // Q: split in place, big over the raw values
  mbar_wait(q_full, 0);
  {
    float4* qb = reinterpret_cast<float4*>(sm + kQBig);
    float4* qs = reinterpret_cast<float4*>(sm + kQSmall);
#pragma unroll 4
    for (int i = tid; i < kQBytes / 16; i += kThreads)
      split4(qb + i, qb + i, qs + i);
  }
  mbar_wait(k_full, 0);
  split_k();
  fence_proxy_async();
  __syncthreads();
  if (tid == 0 && tiles > 1) load_k(1);

  const int c = tid >> 7;                  // warpgroup: query rows 64c ..
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // A operands: this warpgroup's 64 rows of each 32-dim box of Q
  const uint32_t qa = base + kQBig + c * 64 * 128;
  float o[64], acc[64], sh[32], sl[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sh[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) sl[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float l_r[2] = {0.f, 0.f};

  for (int j = 0; j < tiles; ++j) {
    // S (64 x 32 keys) = Q K^T. k-step kk reads dims 8kk.. (box kk / 4,
    // byte 32 (kk % 4) of each row). One n64 wgmma takes Q big against
    // K's stacked big and small rows: sh[0..15] = big*big, sh[16..31] =
    // big*small; sl = small*big. Stacked, B is read once for two products:
    // 7 KB of operands a k-step instead of 9.
    fence_regs(sh);
    fence_regs(sl);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
      const uint32_t oq = (kk >> 2) * kQBox + (kk & 3) * 32;
      const uint32_t ok = (kk >> 2) * 2 * kKBox + (kk & 3) * 32;
      const uint64_t qbig = desc_sw128(qa + oq, 16, 1024);
      const uint64_t qsmall = desc_sw128(qa + kQBytes + oq, 16, 1024);
      const uint64_t kst = desc_sw128(base + kKSplit + ok, 16, 1024);
      hopper::wgmma_tf32_n64(sh, qbig, kst, kk > 0);
      hopper::wgmma_tf32_n32(sl, qsmall, kst, kk > 0);
    }
    wg_commit();
    // V_j into split V^T while S_j runs (P_{j-1} V_{j-1} is done in both
    // warpgroups: the barrier at the end of tile j - 1)
    mbar_wait(v_full, j & 1);
    split_v();
    fence_proxy_async();
    wg_wait<0>();
    fence_regs(sh);
    fence_regs(sl);

    // sh[4i + e], sh[16 + 4i + e], sl[4i + e]: row g (e < 2) or g + 8, key
    // 8i + 2t + (e & 1); online softmax over the row's 32 keys (a quad's
    // 4 lanes)
    const float* bt =
        reinterpret_cast<const float*>(sm + kBiasOff) + (j & 1) * kBK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * i + e;
        sh[x] = (sh[x] + (sh[16 + x] + sl[x])) + ((e & 1) ? bb.y : bb.x);
      }
      mx[0] = fmaxf(mx[0], fmaxf(sh[4 * i], sh[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sh[4 * i + 2], sh[4 * i + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // P's A fragments, k-step i = keys 8i..8i+7: column t is key 8i + 2t
    // (sh[4i], row g; sh[4i + 2], row g + 8), column t + 4 key 8i + 2t + 1
    uint32_t pb[4][4], ps[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sh[4 * i + e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        const Split sp = split(p);
        // e = 0, 1, 2, 3 -> a0 (g, t), a2 (g, t + 4), a1 (g + 8, t),
        // a3 (g + 8, t + 4)
        const int a = ((e & 1) << 1) | (e >> 1);
        pb[i][a] = sp.big;
        ps[i][a] = sp.small;
      }
    }
    // V_j is whole and S_j done in both warpgroups (split K free); the raw
    // V stage is read
    __syncthreads();
    if (tid == 0 && j + 1 < tiles) load_v(j + 1);

    // P V_j (64 x 128) from zero; B k-step kk is bytes 32kk.. of each of
    // V^T's 128 rows
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t vbig = desc_sw128(base + kVBig + kk * 32, 16, 1024);
      const uint64_t vsmall = desc_sw128(base + kVSmall + kk * 32, 16, 1024);
      hopper::wgmma_tf32_rs(acc, ps[kk], vbig, kk > 0);
      hopper::wgmma_tf32_rs(acc, pb[kk], vsmall, 1);
      hopper::wgmma_tf32_rs(acc, pb[kk], vbig, 1);
    }
    wg_commit();
    // K_{j+1} into split K while P V_j runs
    if (j + 1 < tiles) {
      mbar_wait(k_full, (j + 1) & 1);
      split_k();
      fence_proxy_async();
    }
    wg_wait<0>();
    fence_regs(acc);
    // P's fragments stay in their registers until the wgmma that read
    // them are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" ::"r"(pb[i][e]), "r"(ps[i][e]) : "memory");
    // acc[4i + e]: row g (e < 2) or g + 8, dim 8i + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < 64; ++i)
      o[i] = fmaf(o[i], alpha[(i >> 1) & 1], acc[i]);
    // K_{j+1} is whole, P V_j done in both warpgroups (V^T free); the raw
    // K stage and bias slot j & 1 are read
    __syncthreads();
    if (tid == 0 && j + 2 < tiles) load_k(j + 2);
  }

  const int ldo = heads * kHD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
    const float inv = 1.f / l_r[r];
    float* dst = out + ((long long)bw * nq + row) * ldo + h * kHD + 2 * t;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
  }
}

// (hd, rows, panels) float32 as 32-dim x box_rows boxes, 128-byte swizzle;
// rows past `rows` read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int panels,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kHD, (cuuint64_t)rows,
                              (cuuint64_t)panels};
  const cuuint64_t strides[2] = {(cuuint64_t)kHD * 4,
                                 (cuuint64_t)rows * kHD * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1};
  return hopper::encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims,
                              strides, box);
}

int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int heads, int nwin, int nq, int nk, int ld,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      focal_attention_3xtf32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || nq == 0) return (int)cudaGetLastError();
  if (hopper::encoder() == nullptr || ld % kBK != 0 || ld < nk)
    return (int)cudaErrorInvalidValue;
  const int panels = B * heads * nwin;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, nq, panels, kBQ) ||
      !make_map(&kmap, k, nk, panels, kBK) ||
      !make_map(&vmap, v, nk, panels, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, B * nwin);
  focal_attention_3xtf32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      qmap, kmap, vmap, static_cast<const float*>(bias),
      static_cast<float*>(out), heads, nwin, nq, nk, ld);
  return (int)cudaGetLastError();
}

}  // namespace attn_tf32

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
// multiple of 128 (-inf past nk). bfloat16 runs the bf16 wgmma kernel,
// float32 the 3xTF32 wgmma kernel.
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
  return e2fgvi::attn_tf32::launch(q, k, v, bias, out, B, heads, nwin, nq, nk,
                                   ld, s);
}
