// K1 (head-fused DCNv2) and K2 flow_warp: the bilinear samplers of the
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
// Inputs are NHWC, so one group's channels (K1) or a pixel's channels (K2)
// are one contiguous run. Corner reads are 16-byte loads (K2's, and its
// stores, narrower ones of the same kernel where the wrapper found x
// misaligned; K1's wrapper copies a misaligned x). The four corners' loads
// are issued before their sums, in the corner order 00, 01, 10, 11, with
// one float32 FMA per corner and channel, so every width gives the same
// bits.
//
// K2 (flow_warp_kernel): 16 bytes of channels of two pixels a thread (of
// one pixel where a thread takes all of a pixel's channels, as in the
// 2-channel flow composition); at C = 128 a float32 pixel is one warp and
// a bf16 pixel half a warp, so the corner offsets and weights are computed
// once per pixel. What bounds
// it: bytes (four corner reads, mostly L2 hits, and one write per output
// element); see the note there.
//
// K1 is one kernel in both dtypes: it samples the im2col tile straight
// into shared memory and contracts it there with wgmma, the weight
// arriving by TMA, so no im2col matrix goes to device memory. bfloat16
// (namespace fused, deform_conv_wgmma_kernel) and float32 (namespace
// fused_tf32, deform_conv_tf32_kernel, 3xTF32) have a note each. The
// offset/mask prelude (10*tanh + flow, sigmoid) is fused into both, so the
// (N,H,W,G,K,2) offset tensor never exists.
#include "common.cuh"
#include "hopper.cuh"

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

// V elements at p (aligned to V * sizeof(T) bytes) by one load, raw
// (load_words, common.cuh)
template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p, unsigned* w) {
  load_words<V * (int)sizeof(T)>(p, w);
}

// the raw words of load_raw in float32; a bf16 widens exactly as
// __bfloat162float does
template <typename T, int V>
__device__ __forceinline__ void raw_to_f32(const unsigned* w, float* dst) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < V; ++k) dst[k] = __uint_as_float(w[k]);
  } else if constexpr (V == 1) {
    dst[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      dst[2 * k] = __uint_as_float(w[k] << 16);
      dst[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// p[0..V) = src[0..V), rounded to T, by one store of V elements
template <typename T, int V>
__device__ __forceinline__ void store_from_f32(T* p, const float* src) {
  if constexpr (V * (int)sizeof(T) == 2) {
    *p = from_f32<T>(src[0]);
  } else if constexpr (sizeof(T) == 4) {
    unsigned w[V];
#pragma unroll
    for (int k = 0; k < V; ++k) w[k] = __float_as_uint(src[k]);
    store_words<V * 4>(p, w);
  } else {
    unsigned w[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) w[k] = pack_bf16(src[2 * k], src[2 * k + 1]);
    store_words<V * 2>(p, w);
  }
}

// acc[j][0..NC) += sum over the corners of c[j] of w * img[off + c0 ..
// off + c0 + NC), for PX samples j, in loads of V elements: every load of
// every sample first (all in flight together), then the FMAs in corner
// order; a corner of weight 0 is neither read nor added
template <typename T, int NC, int V, int PX>
__device__ __forceinline__ void gather_corners(const T* __restrict__ img,
                                               const Corners (&c)[PX],
                                               int c0, float (&acc)[PX][NC]) {
  constexpr int L = NC / V, WL = words_of<T, V>();
  unsigned raw[PX][4][L][WL];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c[j].w[i] != 0.f) {
#pragma unroll
        for (int l = 0; l < L; ++l)
          load_raw<T, V>(img + c[j].off[i] + c0 + l * V, raw[j][i][l]);
      }
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c[j].w[i] != 0.f) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          float f[V];
          raw_to_f32<T, V>(raw[j][i][l], f);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[j][l * V + k] += c[j].w[i] * f[k];
        }
      }
}

// The offset/mask prelude of one (pixel, group g, tap k) sample: its
// position (py, px) and its mask m, from the raw head values (dy, dx,
// mask logit) and the pixel's flow (dx, dy).
struct Sample {
  float py, px, m;
};

__device__ __forceinline__ Sample sample_at(float dy, float dx, float logit,
                                            float flow_x, float flow_y,
                                            int oy, int ox, int ky, int kx,
                                            int pad, float max_residue) {
  const float off_y = max_residue * tanhf(dy) + flow_y;
  const float off_x = max_residue * tanhf(dx) + flow_x;
  Sample s;
  s.m = 1.f / (1.f + expf(-logit));
  s.py = (float)(oy - pad + ky) + off_y;
  s.px = (float)(ox - pad + kx) + off_x;
  return s;
}

// K2: backward warp of an NHWC map by a dense (dx, dy) float32 flow,
// bilinear, zeros outside. An item is NC channels of PX consecutive
// pixels, consecutive threads take consecutive chunks (at C = 128 a
// float32 pixel is one warp, a bf16 pixel half a warp). The grid fills
// the card once and strides over the items; each thread loads its next
// item's flows before it reads this item's corners, so a flow read's
// latency hides behind the corner reads, and an item's corner loads (all
// its pixels, all four corners) are in flight together.
template <typename T, int NC, int V, int PX>
__global__ void __launch_bounds__(256)
flow_warp_kernel(const T* __restrict__ x, const float* __restrict__ flow,
                 T* __restrict__ out, int N, int H, int W, int C) {
  const int chunks = C / NC;
  const long long pixels = (long long)N * H * W;
  const long long total = (pixels + PX - 1) / PX * chunks;
  const long long step = (long long)gridDim.x * blockDim.x;
  auto load_flows = [&](long long item, float2 (&fl)[PX]) {
    const long long r0 = item / chunks * PX;
#pragma unroll
    for (int j = 0; j < PX; ++j)
      fl[j] = item < total && r0 + j < pixels
                  ? __ldg(reinterpret_cast<const float2*>(flow) + r0 + j)
                  : make_float2(0.f, 0.f);
  };
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float2 next[PX];
  load_flows(i, next);
  for (; i < total; i += step) {
    float2 fl[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) fl[j] = next[j];
    load_flows(i + step, next);
    const int ch = (int)(i % chunks);
    const long long r0 = i / chunks * PX;  // first pixel: n*H*W + y*W + x
    Corners c[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const long long r = r0 + j;
      const int pix = (int)(r % ((long long)H * W));
      const long long n = r / ((long long)H * W);
      const int y = pix / W, xx = pix % W;
      // a pixel past the end has no corners: it reads and writes nothing
      c[j] = corners_of(H, W, C, r < pixels ? (float)y + fl[j].y : -2.f,
                        (float)xx + fl[j].x, 1.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) c[j].off[k] += n * H * W * C;
    }
    float acc[PX][NC];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[j][q] = 0.f;
    gather_corners<T, NC, V, PX>(x, c, ch * NC, acc);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      if (r0 + j >= pixels) break;
      T* o = out + (r0 + j) * C + ch * NC;
#pragma unroll
      for (int q = 0; q < NC; q += V) store_from_f32<T, V>(o + q, acc[j] + q);
    }
  }
}

// The arguments of both K1 kernels; T is x's, head's and out's type
template <typename T>
struct ConvParams {
  const T* x;           // (N, H, W, Cin)
  const T* head;        // (N, Ho, Wo, 3*K*G)
  const float* flow1;   // (N, Ho, Wo, 2), groups g < G/2
  const float* flow2;   // (N, Ho, Wo, 2), the rest
  const float* bias;    // (Cout,) float32
  T* out;               // (M, Cout)
  int M, H, W, Cin, Ho, Wo, G, K, kw, pad, chunks;
  float max_residue;
};

// ---------------------------------------------------------------------------
// bfloat16 K1: the sampler and the contraction in one kernel
//
// The GEMM is M = N*Ho*Wo pixels x K = G*9*16 (2304) x Cout = 128. The K
// axis is (group g, tap k, channel c) with 16 channels a group, so each
// (g, tap) slice of 16 samples is one k16 wgmma step, and a 64-wide K chunk
// (one 128-byte row of the swizzled tile) is 4 consecutive slices.
//
// What bounds it on the H100: the corner reads. The contraction is 53.5
// GFLOP at serving shapes (0.054 ms at 989 TFLOP/s), but each pixel reads
// 144 samples x 4 corners x 32 bytes, ~1.7 GB a call, each corner one
// 32-byte sector of its own cache line, mostly L1/L2 hits; the im2col
// matrix (0.42 GB of bf16 at serving shapes) never goes to device memory.
// The design:
// * One block per 128 pixels x all 128 output channels, 3 warpgroups: a
//   producer warpgroup that gives its registers away (setmaxnreg 24), one
//   thread of which streams the weight, and two consumer warpgroups
//   (setmaxnreg 240) of 64 rows, each with an m64n128 f32 accumulator in
//   registers.
// * B, the weight, reordered once per weight (kernels/deform.py
//   conv_operands) to (Cout, K), K-major:
//   64 x 128 chunks (16 KB, 128-byte swizzle) by TMA into a 3-stage ring
//   with full/empty mbarriers. Every block reads the same 576 KB, which
//   stays in L2.
// * A, the samples: the consumers build each 128 x 64 chunk themselves.
//   Lanes l and l + 16 of a warp share a pixel row and split each slice's
//   16 channels, so a corner's 32-byte sector is one 16-byte load of each
//   of the two and a warp's load touches 16 lines, not 32. Per chunk a
//   thread takes the chunk's 4 slices: the head's offsets and mask logits
//   (loaded one chunk ahead), the prelude, the corners, all 16 corner
//   loads in flight together, the blend in f32, the mask, one rounding to
//   bf16, and four 16-byte st.shared into the swizzled K-major stage (the
//   16-byte chunk j of row r lands at chunk j ^ (r & 7), the address
//   pattern desc_sw128 reads). The values are the float32 blend,
//   rounded once.
// * Overlap: two A stages. While chunk i's four wgmma run, the same warps
//   sample chunk i + 1 into the other stage; wgmma.wait_group 1 frees the
//   stage chunk i - 1 read. Each thread fences its stores to the async
//   proxy (fence.proxy.async) before the warpgroup barrier that precedes
//   the wgmma reading them.
// * Epilogue: the f32 bias, one rounding to bf16, NHWC rows; the rows of
//   the ragged last tile past M are sampled as zeros and not stored.
// * 80 KB of shared memory (2 A + 3 B stages of 16 KB); mbar_wait traps a
//   broken pipeline instead of hanging the card.
// ---------------------------------------------------------------------------
namespace fused {

using hopper::bf16;

constexpr int kBM = 128;                  // pixels per block
constexpr int kCG = 16;                   // channels per group = wgmma k
constexpr int kCout = 128;                // output channels = wgmma n
constexpr int kBK = 64;                   // K per chunk: 4 (g, tap) slices
constexpr int kBStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = 128 + kConsumers;  // producer + consumer warpgroups
constexpr int kATile = kBM * kBK * 2;      // 16 KB
constexpr int kBTile = kCout * kBK * 2;    // 16 KB
constexpr int kAOff = 0;
constexpr int kBOff = kAOff + 2 * kATile;
constexpr int kBarOff = kBOff + kBStages * kBTile;
// + 1 KB to align the base to the 128-byte swizzle's 1024-byte period
constexpr int kSmemBytes = kBarOff + 8 * 2 * kBStages + 1024;

using Params = ConvParams<bf16>;

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier of the 128 threads of consumer warpgroup c (ids 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(c + 1) : "memory");
}

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// CG, the channels a group: 16 (a slice is one k16 step; lanes l and
// l + 16 take its two 8-channel halves) or 8 (a slice is half a k16 step;
// lane l takes the even slices of a chunk, lane l + 16 the odd ones, 8
// channels each, so a thread samples 4 slices either way)
template <int CG>
__global__ void __launch_bounds__(kThreads, 1)
deform_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ Params p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA = base + kAOff, sB = base + kBOff;
  const uint32_t full0 = base + kBarOff, empty0 = full0 + 8 * kBStages;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;

  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: thread 0 streams the weight's K chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      for (int i = 0; i < p.chunks; ++i) {
        const int s = i % kBStages;
        mbar_wait(empty0 + 8 * s, ((i / kBStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, kBTile);
        tma_load(sB + s * kBTile, &wmap, full0 + 8 * s, i * kBK, 0, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int c = (tid >> 7) - 1;           // consumer warpgroup: rows 64c ..
  const int t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  // this thread's A row in the tile, and its channels 8e .. 8e + 7 of
  // every slice (CG 16) or its slices of parity e (CG 8); lanes l and
  // l + 16 share a row
  const int row = c * 64 + warp * 16 + (lane & 15);
  const int e = lane >> 4;
  const int m = m0 + row;
  const bool live = m < p.M;
  const int GK = p.G * p.K;
  constexpr int kHeadWords = CG == 16 ? 6 : 12;

  // the pixel's coordinates, flows, head row and image
  int n = 0, oy = 0, ox = 0;
  float2 f1 = make_float2(0.f, 0.f), f2 = f1;
  const bf16* hp = p.head;
  const bf16* img = p.x;
  if (live) {
    const int P = p.Ho * p.Wo;
    n = m / P;
    const int pp = m - n * P;
    oy = pp / p.Wo;
    ox = pp - oy * p.Wo;
    f1 = __ldg(reinterpret_cast<const float2*>(p.flow1) + m);
    f2 = __ldg(reinterpret_cast<const float2*>(p.flow2) + m);
    hp = p.head + (long long)m * 3 * GK;
    img = p.x + (long long)n * p.H * p.W * p.Cin + (CG == 16 ? 8 * e : 0);
  }
  const uint32_t a_row = row * 128;
  const int sw = row & 7;

  // CG 16: the head values of chunk q's slices 4q .. 4q + 3: h[s] their
  // (dy, dx), h[4 + s/2] their mask logits, two a word. CG 8: of its
  // slices 8q .. 8q + 7: h[j] slice j's (dy, dx), h[8 + j/2] the logits
  auto load_head = [&](int chunk, unsigned (&h)[kHeadWords]) {
    if (live && chunk < p.chunks) {
      if constexpr (CG == 16) {
        load_words<8>(hp + 8 * chunk, h);
        load_words<8>(hp + 8 * chunk + 4, h + 2);
        load_words<8>(hp + 2 * GK + 4 * chunk, h + 4);
      } else {
        load_words<16>(hp + 16 * chunk, h);
        load_words<16>(hp + 16 * chunk + 8, h + 4);
        load_words<16>(hp + 2 * GK + 8 * chunk, h + 8);
      }
    }
  };
  // chunk `chunk` of this thread's row and channel half into an A stage
  auto sample = [&](int chunk, const unsigned (&h)[kHeadWords],
                    uint32_t stage) {
    uint4 v[4];
    if (live) {
      Corners cr[4];
      float mk[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // slice q of the K axis; j its index in the chunk
        const int j = CG == 16 ? s : 2 * s + e;
        const int q = (kBK / CG) * chunk + j;
        const int g = q / p.K;
        const int k = q - g * p.K;
        const int ky = k / p.kw;
        const float2 fl = g < p.G / 2 ? f1 : f2;
        const unsigned lw = h[(CG == 16 ? 4 : 8) + j / 2];
        const Sample sm = sample_at(lo_bf16(h[j]), hi_bf16(h[j]),
                                    (j & 1) ? hi_bf16(lw) : lo_bf16(lw),
                                    fl.x, fl.y, oy, ox, ky, k - ky * p.kw,
                                    p.pad, p.max_residue);
        mk[s] = sm.m;
        cr[s] = corners_of(p.H, p.W, p.Cin, sm.py, sm.px, 1.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) cr[s].off[i] += g * CG;
      }
      float acc[4][8];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[s][k] = 0.f;
      gather_corners<bf16, 8, 8, 4>(img, cr, 0, acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float* a = acc[s];
        v[s] = make_uint4(pack_bf16(a[0] * mk[s], a[1] * mk[s]),
                          pack_bf16(a[2] * mk[s], a[3] * mk[s]),
                          pack_bf16(a[4] * mk[s], a[5] * mk[s]),
                          pack_bf16(a[6] * mk[s], a[7] * mk[s]));
      }
    } else {
      v[0] = v[1] = v[2] = v[3] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // 16-byte chunk of the row: half e of slice s (CG 16), slice 2s + e
      // (CG 8)
      const int j = 2 * s + e;
      st_shared_v4(stage + a_row + ((j ^ sw) << 4), v[s]);
    }
  };

  // A operand of this warpgroup: its 64 rows, 128 bytes each; k-step kk of
  // a chunk reads bytes 32kk.. of every row
  const uint32_t a_wg = sA + c * 64 * 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  unsigned h_cur[kHeadWords], h_next[kHeadWords];
  load_head(0, h_cur);
  load_head(1, h_next);
  sample(0, h_cur, sA);
  fence_proxy_async();
  warpgroup_sync(c);
  for (int i = 0; i < p.chunks; ++i) {
    const int bs = i % kBStages;
    mbar_wait(full0 + 8 * bs, (i / kBStages) & 1);
    const uint32_t a_st = a_wg + (i & 1) * kATile;
    const uint32_t b_st = sB + bs * kBTile;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss(acc, desc_sw128(a_st + kk * 32, 16, 1024),
               desc_sw128(b_st + kk * 32, 16, 1024), i > 0 || kk > 0);
    wg_commit();
    if (i + 1 < p.chunks) {
      // chunk i - 1's products are done: its A stage takes chunk i + 1,
      // its B stage goes back to the producer
#pragma unroll
      for (int w = 0; w < kHeadWords; ++w) h_cur[w] = h_next[w];
      load_head(i + 2, h_next);
      wg_wait<1>();
      fence_regs(acc);
      if (i > 0) mbar_arrive(empty0 + 8 * ((i - 1) % kBStages));
      sample(i + 1, h_cur, sA + ((i + 1) & 1) * kATile);
      fence_proxy_async();
      warpgroup_sync(c);
    }
  }
  wg_wait_all();
  fence_regs(acc);

  // acc[4i + e]: row 16*warp + g (e < 2) or g + 8 of the warpgroup's 64,
  // column 8i + 2t + (e & 1)
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int mr = m0 + c * 64 + warp * 16 + gq + 8 * r;
    if (mr >= p.M) continue;
    bf16* dst = p.out + (long long)mr * kCout + 2 * tq;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + 8 * i + 2 * tq));
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * r] + b.x, acc[4 * i + 2 * r + 1] + b.y);
    }
  }
}

// wk: the weight as (Cout, G*K*CG) bf16, K-major, column (g*K + k)*CG + c
template <int CG>
int launch_cg(Params prm, const void* wk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      deform_conv_wgmma_kernel<CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int ktot = prm.G * prm.K * CG;
  if (prm.Cin != prm.G * CG || ktot % kBK != 0)
    return (int)cudaErrorInvalidValue;
  prm.chunks = ktot / kBK;
  if (prm.M == 0) return (int)cudaGetLastError();
  const cuuint64_t dims[3] = {(cuuint64_t)ktot, (cuuint64_t)kCout, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)ktot * 2,
                                 (cuuint64_t)ktot * 2 * kCout};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)kCout, 1};
  CUtensorMap wmap;
  if (!hopper::encode_sw128(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wk, dims,
                           strides, box))
    return (int)cudaErrorInvalidValue;
  deform_conv_wgmma_kernel<CG><<<blocks_for(prm.M, kBM), kThreads,
                                 kSmemBytes, stream>>>(wmap, prm);
  return (int)cudaGetLastError();
}

int launch(Params prm, const void* wk, cudaStream_t stream) {
  if (prm.Cin == prm.G * 8) return launch_cg<8>(prm, wk, stream);
  return launch_cg<kCG>(prm, wk, stream);
}

}  // namespace fused

// ---------------------------------------------------------------------------
// float32 K1: the sampler and a 3xTF32 contraction in one kernel
//
// Replaces dcn_band.py::_sampler_kernel together with the XLA einsum that
// contracts its samples (dcn_band.py:569, _sample_and_contract): Mosaic
// could not relayout the sampled taps for the MXU in place, so the TPU
// kernel fused nothing. The GEMM is the bf16 kernel's, M pixels x K =
// G*9*16 x 128, in float32.
//
// Precision: the port pins full float32, and one TF32 pass (10 mantissa
// bits) lands ~1e-3 off. So each operand x splits into big = rna_tf32(x)
// and small = rna_tf32(x - big), and each product is small*big +
// big*small + big*big (small*small, ~2^-22 relative, is dropped), as the
// f32 K3 does. The tensor cores truncate every float32
// accumulation toward zero, so the error grows with the steps chained into
// one accumulator at the sum's magnitude. With big*big kept apart from the
// corrections, K = 2304 chains 288 k8 steps into big*big's accumulator:
// 1.5e-5 from K1 in float64 at base B=14 (tools/deform_ab.py --parts
// accuracy; NVIDIA H100 80GB HBM3). So, as K3's P V sum does, each
// 32-wide K chunk's 12 wgmma start from zero in one accumulator that
// joins the running sum by a rounded add: 7.5e-6, closer than the plain
// float32 version (1.6e-5). Two m64n128 accumulators, 128 registers,
// either way.
//
// What bounds it on the H100: 160.6 GFLOP of TF32 work at serving shapes
// (0.324 ms at 495 TFLOP/s), and the corner reads: each pixel reads 144
// samples x 4 corners x 64 bytes, ~3.3 GB a call of L1/L2 traffic, twice
// the bf16 kernel's. The im2col matrix (0.84 GB at serving shapes, 7.5 GB
// at 1296x720) never goes to device memory. The design is the bf16
// kernel's (namespace fused: a TMA ring of the weight, two warpgroups of
// 64 rows sampling chunk i + 1 while chunk i's wgmma run, the bias in the
// epilogue, the ragged tile's rows sampled as zeros and not stored), with:
// * No producer warpgroup. Beside it the consumers get at most 240
//   registers (setmaxnreg), and the two accumulators and 16 corner loads in
//   flight need ~250: that spilled. Thread 0 issues the weight's TMA loads
//   instead: the first kBStages chunks, then, at the end of chunk i, chunk
//   i - 1 + kBStages into the stage both warpgroups released after chunk
//   i - 1 (the empty mbarrier), one chunk's sampling ahead of its use.
// * wgmma m64n128k8 tf32, A and B both K-major (tf32 has no transposed
//   form). A k8 step is 32 bytes of a row, as bf16's k16 is, so a
//   128-byte swizzled row is one 32-wide K chunk, 2 (g, tap) slices: 4 k8
//   steps of 3 wgmma, 72 chunks at serving widths.
// * B: the weight split once per weight (kernels/deform.py conv_operands)
//   into a (2, Cout, K) float32 tensor, big then small; one 3-D TMA box
//   {32, 128, 2} brings a chunk of both (32 KB).
// * A: the consumers sample as the bf16 kernel does, blend in f32 (corners
//   00, 01, 10, 11, one FMA per corner and channel, then the mask), split
//   each value and store big and small into the stage's two A tiles. A
//   slice's 16 channels are 64 bytes, two sectors; lanes l and l + 16
//   share a pixel row and take the 16-byte halves of both, so each warp
//   load is 16 whole sectors (L1 requests, not L2 bytes, bound these
//   samplers).
// * 160 KB of shared memory: 2 A stages x (big + small) x 16 KB and 3 B
//   stages x 32 KB. Each chunk waits for its own wgmma before its rounded
//   join, after sampling the next chunk, which takes far longer.
// ---------------------------------------------------------------------------
namespace fused_tf32 {

using fused::fence_proxy_async;
using fused::st_shared_v4;
using fused::warpgroup_sync;

constexpr int kBM = 128;                   // pixels per block
constexpr int kCG = 16;                    // channels per group
constexpr int kCout = 128;                 // output channels = wgmma n
constexpr int kBK = 32;                    // K per chunk: 2 (g, tap) slices
constexpr int kBStages = 3;
constexpr int kThreads = 256;              // two warpgroups of 64 rows
constexpr int kATile = kBM * kBK * 4;      // 16 KB, big or small
constexpr int kBTile = kCout * kBK * 4;    // 16 KB, big or small
constexpr int kAOff = 0;                   // 2 stages of (big, small)
constexpr int kBOff = kAOff + 2 * 2 * kATile;
constexpr int kBarOff = kBOff + kBStages * 2 * kBTile;
// + 1 KB to align the base to the 128-byte swizzle's 1024-byte period
constexpr int kSmemBytes = kBarOff + 8 * 2 * kBStages + 1024;

using Params = ConvParams<float>;

// CG, the channels a group: 16 (a chunk is 2 slices; lanes l and l + 16
// take channels 4e .. 4e + 3 and 8 + 4e .. of both) or 8 (a chunk is 4
// slices; lane l takes slices 0 and 2, lane l + 16 slices 1 and 3, all 8
// channels of each)
template <int CG>
__global__ void __launch_bounds__(kThreads, 1)
deform_conv_tf32_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ Params p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA = base + kAOff, sB = base + kBOff;
  const uint32_t full0 = base + kBarOff, empty0 = full0 + 8 * kBStages;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;

  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the weight's first K chunks, big and small in one box
    for (int i = 0; i < kBStages && i < p.chunks; ++i) {
      mbar_expect_tx(full0 + 8 * i, 2 * kBTile);
      tma_load(sB + i * 2 * kBTile, &wmap, full0 + 8 * i, i * kBK, 0, 0);
    }
  }
  __syncthreads();

  const int c = tid >> 7;                 // warpgroup: rows 64c ..
  const int t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  // this thread's A row in the tile, and its channels 4e .. 4e + 3 and
  // 8 + 4e .. 8 + 4e + 3 of every slice (lanes l and l + 16 share a row)
  const int row = c * 64 + warp * 16 + (lane & 15);
  const int e = lane >> 4;
  const int m = m0 + row;
  const bool live = m < p.M;
  const int GK = p.G * p.K;

  // the pixel's coordinates, flows, head row and image
  int n = 0, oy = 0, ox = 0;
  float2 f1 = make_float2(0.f, 0.f), f2 = f1;
  const float* hp = p.head;
  const float* img = p.x;
  if (live) {
    const int P = p.Ho * p.Wo;
    n = m / P;
    const int pp = m - n * P;
    oy = pp / p.Wo;
    ox = pp - oy * p.Wo;
    f1 = __ldg(reinterpret_cast<const float2*>(p.flow1) + m);
    f2 = __ldg(reinterpret_cast<const float2*>(p.flow2) + m);
    hp = p.head + (long long)m * 3 * GK;
    img = p.x + (long long)n * p.H * p.W * p.Cin + (CG == 16 ? 4 * e : 0);
  }
  const uint32_t a_row = row * 128;
  const int sw = row & 7;

  // the head values of chunk q's slices 2q, 2q + 1: h[2s], h[2s + 1] the
  // (dy, dx) of slice s, h[4 + s] its mask logit
  // (CG 8: this thread's slices 4q + e and 4q + 2 + e, likewise)
  auto load_head = [&](int chunk, unsigned (&h)[6]) {
    if (live && chunk < p.chunks) {
      if constexpr (CG == 16) {
        load_words<8>(hp + 4 * chunk, h);
        load_words<8>(hp + 4 * chunk + 2, h + 2);
        load_words<8>(hp + 2 * GK + 2 * chunk, h + 4);
      } else {
        load_words<8>(hp + 8 * chunk + 2 * e, h);
        load_words<8>(hp + 8 * chunk + 4 + 2 * e, h + 2);
        load_words<4>(hp + 2 * GK + 4 * chunk + e, h + 4);
        load_words<4>(hp + 2 * GK + 4 * chunk + 2 + e, h + 5);
      }
    }
  };
  // chunk `chunk` of this thread's row and channels into an A stage: big
  // at stage, small at stage + kATile
  auto sample = [&](int chunk, const unsigned (&h)[6], uint32_t stage) {
    float v[2][8];  // slice s: channels 4e .. 4e + 3, then 8 + 4e ..
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int k = 0; k < 8; ++k) v[s][k] = 0.f;
    if (live) {
      // the corners' element offsets in 32 bits (an image of x is under
      // 2^31 elements) and their weights
      int off[2][4];
      float cw[2][4], mk[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int q = CG == 16 ? 2 * chunk + s : 4 * chunk + 2 * s + e;
        const int g = q / p.K;
        const int k = q - g * p.K;
        const int ky = k / p.kw;
        const float2 fl = g < p.G / 2 ? f1 : f2;
        const Sample sm = sample_at(
            __uint_as_float(h[2 * s]), __uint_as_float(h[2 * s + 1]),
            __uint_as_float(h[4 + s]), fl.x, fl.y, oy, ox, ky,
            k - ky * p.kw, p.pad, p.max_residue);
        mk[s] = sm.m;
        const Corners cr = corners_of(p.H, p.W, p.Cin, sm.py, sm.px, 1.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          off[s][i] = (int)cr.off[i] + g * CG;
          cw[s][i] = cr.w[i];
        }
      }
      // every load of both slices in flight together, then the FMAs in
      // corner order; a corner of weight 0 is neither read nor added
      unsigned w[2][4][2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (cw[s][i] != 0.f) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              load_words<16>(img + off[s][i] + (CG == 16 ? 8 : 4) * hf,
                             w[s][i][hf]);
          }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (cw[s][i] != 0.f) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
              v[s][k] += cw[s][i] * __uint_as_float(w[s][i][k / 4][k % 4]);
          }
#pragma unroll
        for (int k = 0; k < 8; ++k) v[s][k] *= mk[s];
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* a = v[s] + 4 * hf;
        const Split x0 = split(a[0]), x1 = split(a[1]), x2 = split(a[2]),
                    x3 = split(a[3]);
        // 16-byte chunk j of the row: slice s's bytes 32 hf + 16 e (CG
        // 16), slice 2s + e's bytes 16 hf (CG 8)
        const int j = CG == 16 ? 4 * s + 2 * hf + e : 4 * s + 2 * e + hf;
        const uint32_t at = a_row + ((j ^ sw) << 4);
        st_shared_v4(stage + at, make_uint4(x0.big, x1.big, x2.big, x3.big));
        st_shared_v4(stage + kATile + at,
                     make_uint4(x0.small, x1.small, x2.small, x3.small));
      }
  };

  // A operands of this warpgroup: its 64 rows of each tile, 128 bytes
  // each; k-step kk of a chunk reads bytes 32kk.. of every row
  const uint32_t a_wg = sA + c * 64 * 128;
  // acc: chunk i's 3xTF32 products, from zero; sum: the chunks before,
  // joined by rounded adds
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  unsigned h_cur[6], h_next[6];
  load_head(0, h_cur);
  load_head(1, h_next);
  sample(0, h_cur, sA);
  fence_proxy_async();
  warpgroup_sync(c);
  for (int i = 0; i < p.chunks; ++i) {
    const int bs = i % kBStages;
    mbar_wait(full0 + 8 * bs, (i / kBStages) & 1);
    const uint32_t a_st = a_wg + (i & 1) * 2 * kATile;
    const uint32_t b_st = sB + bs * 2 * kBTile;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t a_big = desc_sw128(a_st + kk * 32, 16, 1024);
      const uint64_t a_small = desc_sw128(a_st + kATile + kk * 32, 16, 1024);
      const uint64_t b_big = desc_sw128(b_st + kk * 32, 16, 1024);
      const uint64_t b_small = desc_sw128(b_st + kBTile + kk * 32, 16, 1024);
      wgmma_tf32(acc, a_small, b_big, kk > 0);
      wgmma_tf32(acc, a_big, b_small, 1);
      wgmma_tf32(acc, a_big, b_big, 1);
    }
    wg_commit();
    if (i + 1 < p.chunks) {
      // chunk i + 1 into the A stage chunk i - 1 read, while chunk i's
      // wgmma run
#pragma unroll
      for (int w = 0; w < 6; ++w) h_cur[w] = h_next[w];
      load_head(i + 2, h_next);
      sample(i + 1, h_cur, sA + ((i + 1) & 1) * 2 * kATile);
      fence_proxy_async();
    }
    wg_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * bs);  // chunk i's B stage is free
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] += acc[j];
    if (tid == 0 && i > 0 && i - 1 + kBStages < p.chunks) {
      // chunk i - 1's stage, once both warpgroups are done with it, takes
      // chunk i - 1 + kBStages: a chunk's sampling ahead of its use
      const int fs = (i - 1) % kBStages;
      mbar_wait(empty0 + 8 * fs, ((i - 1) / kBStages) & 1);
      mbar_expect_tx(full0 + 8 * fs, 2 * kBTile);
      tma_load(sB + fs * 2 * kBTile, &wmap, full0 + 8 * fs,
               (i - 1 + kBStages) * kBK, 0, 0);
    }
    warpgroup_sync(c);
  }

  // sum[4i + e]: row 16*warp + g (e < 2) or g + 8 of the warpgroup's 64,
  // column 8i + 2t + (e & 1)
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int mr = m0 + c * 64 + warp * 16 + gq + 8 * r;
    if (mr >= p.M) continue;
    float* dst = p.out + (long long)mr * kCout + 2 * tq;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int a = 4 * i + 2 * r;
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + 8 * i + 2 * tq));
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(sum[a] + b.x, sum[a + 1] + b.y);
    }
  }
}

// wk: the weight as (2, Cout, G*K*CG) float32, its tf32 big and small
// parts, K-major, column (g*K + k)*CG + c
template <int CG>
int launch_cg(Params prm, const void* wk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      deform_conv_tf32_kernel<CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int ktot = prm.G * prm.K * CG;
  if (prm.Cin != prm.G * CG || ktot % kBK != 0 ||
      (long long)prm.H * prm.W * prm.Cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  prm.chunks = ktot / kBK;
  if (prm.M == 0) return (int)cudaGetLastError();
  const cuuint64_t dims[3] = {(cuuint64_t)ktot, (cuuint64_t)kCout, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)ktot * 4,
                                 (cuuint64_t)ktot * 4 * kCout};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)kCout, 2};
  CUtensorMap wmap;
  if (!hopper::encode_sw128(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wk, dims,
                           strides, box))
    return (int)cudaErrorInvalidValue;
  deform_conv_tf32_kernel<CG><<<blocks_for(prm.M, kBM), kThreads,
                                kSmemBytes, stream>>>(wmap, prm);
  return (int)cudaGetLastError();
}

int launch(Params prm, const void* wk, cudaStream_t stream) {
  if (prm.Cin == prm.G * 8) return launch_cg<8>(prm, wk, stream);
  return launch_cg<kCG>(prm, wk, stream);
}

}  // namespace fused_tf32

// K1's arguments; `chunks` is set by the dtype's launch
template <typename T>
ConvParams<T> conv_params(const void* x, const void* head, const void* flow1,
                          const void* flow2, const void* bias, void* out,
                          int N, int H, int W, int Cin, int Ho, int Wo, int G,
                          int K, int kw, int pad, float max_residue) {
  ConvParams<T> prm;
  prm.x = static_cast<const T*>(x);
  prm.head = static_cast<const T*>(head);
  prm.flow1 = static_cast<const float*>(flow1);
  prm.flow2 = static_cast<const float*>(flow2);
  prm.bias = static_cast<const float*>(bias);
  prm.out = static_cast<T*>(out);
  prm.M = N * Ho * Wo;
  prm.H = H, prm.W = W, prm.Cin = Cin, prm.Ho = Ho, prm.Wo = Wo;
  prm.G = G, prm.K = K, prm.kw = kw, prm.pad = pad, prm.chunks = 0;
  prm.max_residue = max_residue;
  return prm;
}

// Launchers of K2, dispatched on the channels a thread takes (nc) and the
// elements a load takes (vec, a power of two dividing nc, as wide as the
// data's alignment allows).
template <typename T, int NC, int V, int PX>
void launch_warp_items(const void* x, const void* flow, void* out, int N,
                       int H, int W, int C, cudaStream_t stream) {
  const long long total = ((long long)N * H * W + PX - 1) / PX * (C / NC);
  if (total == 0) return;
  // one wave of resident blocks, found once per instantiation
  static const unsigned wave = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flow_warp_kernel<T, NC, V, PX>, 256, 0);
    return (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
  }();
  const unsigned blocks = blocks_for(total, 256);
  flow_warp_kernel<T, NC, V, PX><<<blocks < wave ? blocks : wave, 256, 0,
                                   stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(flow),
      static_cast<T*>(out), N, H, W, C);
}

// K2's pixels an item: two where a pixel's channels take several threads
// (the 128-channel maps), one where one thread takes them all (the
// 2-channel flow composition, one float2 a pixel), whose grid two pixels
// a thread would halve
template <typename T, int NC,
          int V = (NC * (int)sizeof(T) > 16 ? 16 / (int)sizeof(T) : NC)>
void launch_warp(int vec, const void* x, const void* flow, void* out, int N,
                 int H, int W, int C, cudaStream_t stream) {
  if constexpr (V > 1) {
    if (vec < V)
      return launch_warp<T, NC, V / 2>(vec, x, flow, out, N, H, W, C, stream);
  }
  if (C == NC)
    launch_warp_items<T, NC, V, 1>(x, flow, out, N, H, W, C, stream);
  else
    launch_warp_items<T, NC, V, 2>(x, flow, out, N, H, W, C, stream);
}

template <typename T>
void dispatch_warp(int nc, int vec, const void* x, const void* flow,
                   void* out, int N, int H, int W, int C, cudaStream_t s) {
  switch (nc) {
    case 8: launch_warp<T, 8>(vec, x, flow, out, N, H, W, C, s); break;
    case 4: launch_warp<T, 4>(vec, x, flow, out, N, H, W, C, s); break;
    case 2: launch_warp<T, 2>(vec, x, flow, out, N, H, W, C, s); break;
    default: launch_warp<T, 1>(vec, x, flow, out, N, H, W, C, s); break;
  }
}

}  // namespace e2fgvi

// Plain C entry points, loaded with ctypes (kernels/build.py). Each makes
// `device` (the tensors' CUDA device) current for this library's runtime,
// launches on `stream`, and returns cudaGetLastError(); nonzero means the
// launch was refused. `nc` is the channel chunk per thread and must divide
// the group width (K1) or the channel count (K2); `vec` the elements per
// load; the wrapper picks both.

// K1, sampler and contraction in one kernel: out (N*Ho*Wo, 128) of x's
// dtype = samples x weight^T + bias. wk: the weight K-major, column
// (g*K + k)*CG + c, as (128, G*K*CG) bf16 for bfloat16 and as (2, 128,
// G*K*CG) float32 (its tf32 big and small parts) for float32; bias (128,)
// float32; Cin = CG*G with CG 16 or 8, and G*K*CG a multiple of 64
// (bfloat16) or 32 (float32);
// x, wk and out 16-byte aligned, head, the flows and bias 8-byte aligned.
extern "C" int e2fgvi_deform_conv(int dtype, const void* x, const void* head,
                                  const void* flow1, const void* flow2,
                                  const void* wk, const void* bias,
                                  void* out, int N, int H, int W, int Cin,
                                  int Ho, int Wo, int G, int K, int kw,
                                  int pad, float max_residue, int device,
                                  void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16)
    return e2fgvi::fused::launch(
        e2fgvi::conv_params<e2fgvi::hopper::bf16>(
            x, head, flow1, flow2, bias, out, N, H, W, Cin, Ho, Wo, G, K, kw,
            pad, max_residue),
        wk, s);
  return e2fgvi::fused_tf32::launch(
      e2fgvi::conv_params<float>(x, head, flow1, flow2, bias, out, N, H, W,
                                 Cin, Ho, Wo, G, K, kw, pad, max_residue),
      wk, s);
}

extern "C" int e2fgvi_flow_warp(int dtype, int nc, int vec, const void* x,
                                const void* flow, void* out, int N, int H,
                                int W, int C, int device, void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    e2fgvi::dispatch_warp<__nv_bfloat16>(nc, vec, x, flow, out, N, H, W, C, s);
  } else {
    e2fgvi::dispatch_warp<float>(nc, vec, x, flow, out, N, H, W, C, s);
  }
  return (int)cudaGetLastError();
}
