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
// are one contiguous run. Corner reads and stores are 16-byte accesses
// where the wrapper found the data 16-byte aligned (load_raw /
// store_from_f32), narrower ones of the same kernel where it did not. The
// four corners' loads are issued before their sums, in the corner order
// 00, 01, 10, 11, with one float32 FMA per corner and channel and one
// rounding at the store, so every width gives the same bits.
//
// K2 (flow_warp_kernel): 16 bytes of channels of two pixels a thread (of
// one pixel where a thread takes all of a pixel's channels, as in the
// 2-channel flow composition); at C = 128 a float32 pixel is one warp and
// a bf16 pixel half a warp, so the corner offsets and weights are computed
// once per pixel. What bounds
// it: bytes (four corner reads, mostly L2 hits, and one write per output
// element); see the note there.
//
// K1 in bfloat16 (namespace fused, deform_conv_wgmma_kernel): one kernel
// samples the im2col tile straight into shared memory and contracts it
// there with wgmma; see the note there. K1 in float32
// (deform_im2col_kernel): one thread per (pixel, group, tap) writes 16
// samples of an im2col matrix that a cuBLAS float32 GEMM contracts, as the
// JAX package also contracts outside its kernel
// (dcn_band.py:_sample_and_contract). The offset/mask prelude (10*tanh +
// flow, sigmoid) is fused into both, so the (N,H,W,G,K,2) offset tensor
// never exists.
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

// float32 K1: one thread per (n, output pixel, group g, tap k). Writes
// col[n*P + p, (g*K + k)*CG + c] for c in [0, CG), P = Ho*Wo.
// head: (N, Ho, Wo, 3*K*G) raw offset-head output; channel (g*K+k)*2 + 0/1
// is the (dy, dx) residual, channel 2*K*G + g*K + k the mask logit.
// flow1/flow2: (N, Ho, Wo, 2) float32, (dx, dy) order; groups g < G/2 take
// flow1 and the rest flow2 (the second-order deformable alignment).
template <int NC, int V>
__global__ void __launch_bounds__(256)
deform_im2col_kernel(const float* __restrict__ x,
                     const float* __restrict__ head,
                     const float* __restrict__ flow1,
                     const float* __restrict__ flow2, float* __restrict__ col,
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

  const float* hp = head + r * (3LL * K * G);
  const int oc = (g * K + k) * 2;
  const float* fl = (g < G / 2 ? flow1 : flow2) + r * 2;
  const Sample s = sample_at(hp[oc], hp[oc + 1], hp[2 * K * G + g * K + k],
                             fl[0], fl[1], oy, ox, k / kw, k % kw, pad,
                             max_residue);
  const Corners c[1] = {corners_of(H, W, Cin, s.py, s.px, 1.f)};
  const float* img = x + (long long)n * H * W * Cin + g * CG;
  float* out = col + i * CG;
  for (int c0 = 0; c0 < CG; c0 += NC) {
    float acc[1][NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[0][q] = 0.f;
    gather_corners<float, NC, V, 1>(img, c, c0, acc);
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[0][q] *= s.m;
#pragma unroll
    for (int q = 0; q < NC; q += V)
      store_from_f32<float, V>(out + c0 + q, acc[0] + q);
  }
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
//   pattern desc_sw128 reads). The values are the float32 im2col
//   kernel's arithmetic, rounded once.
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

struct Params {
  const bf16* x;        // (N, H, W, Cin)
  const bf16* head;     // (N, Ho, Wo, 3*K*G)
  const float* flow1;   // (N, Ho, Wo, 2), groups g < G/2
  const float* flow2;   // (N, Ho, Wo, 2), the rest
  const float* bias;    // (Cout,) float32
  bf16* out;            // (M, Cout)
  int M, H, W, Cin, Ho, Wo, G, K, kw, pad, chunks;
  float max_residue;
};

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
  // every slice (lanes l and l + 16 share a row)
  const int row = c * 64 + warp * 16 + (lane & 15);
  const int e = lane >> 4;
  const int m = m0 + row;
  const bool live = m < p.M;
  const int GK = p.G * p.K;

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
    img = p.x + (long long)n * p.H * p.W * p.Cin + 8 * e;
  }
  const uint32_t a_row = row * 128;
  const int sw = row & 7;

  // the head values of chunk q's slices 4q .. 4q + 3: h[s] their (dy, dx),
  // h[4 + s/2] their mask logits, two a word
  auto load_head = [&](int chunk, unsigned (&h)[6]) {
    if (live && chunk < p.chunks) {
      load_words<8>(hp + 8 * chunk, h);
      load_words<8>(hp + 8 * chunk + 4, h + 2);
      load_words<8>(hp + 2 * GK + 4 * chunk, h + 4);
    }
  };
  // chunk `chunk` of this thread's row and channel half into an A stage
  auto sample = [&](int chunk, const unsigned (&h)[6], uint32_t stage) {
    uint4 v[4];
    if (live) {
      Corners cr[4];
      float mk[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int q = 4 * chunk + s;
        const int g = q / p.K;
        const int k = q - g * p.K;
        const int ky = k / p.kw;
        const float2 fl = g < p.G / 2 ? f1 : f2;
        const unsigned lw = h[4 + s / 2];
        const Sample sm = sample_at(lo_bf16(h[s]), hi_bf16(h[s]),
                                    (s & 1) ? hi_bf16(lw) : lo_bf16(lw),
                                    fl.x, fl.y, oy, ox, ky, k - ky * p.kw,
                                    p.pad, p.max_residue);
        mk[s] = sm.m;
        cr[s] = corners_of(p.H, p.W, p.Cin, sm.py, sm.px, 1.f);
#pragma unroll
        for (int i = 0; i < 4; ++i) cr[s].off[i] += g * kCG;
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
      const int j = 2 * s + e;                // 16-byte chunk of the row
      st_shared_v4(stage + a_row + ((j ^ sw) << 4), v[s]);
    }
  };

  // A operand of this warpgroup: its 64 rows, 128 bytes each; k-step kk of
  // a chunk reads bytes 32kk.. of every row
  const uint32_t a_wg = sA + c * 64 * 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  unsigned h_cur[6], h_next[6];
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
      for (int w = 0; w < 6; ++w) h_cur[w] = h_next[w];
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

// wk: the weight as (Cout, G*K*16) bf16, K-major, column (g*K + k)*16 + c
int launch(const Params& prm, const void* wk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      deform_conv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int ktot = prm.G * prm.K * kCG;
  if (prm.Cin != prm.G * kCG || ktot % kBK != 0 || prm.chunks * kBK != ktot)
    return (int)cudaErrorInvalidValue;
  if (prm.M == 0) return (int)cudaGetLastError();
  const cuuint64_t dims[3] = {(cuuint64_t)ktot, (cuuint64_t)kCout, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)ktot * 2,
                                 (cuuint64_t)ktot * 2 * kCout};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)kCout, 1};
  CUtensorMap wmap;
  if (!hopper::encode_bf16_sw128(&wmap, wk, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  deform_conv_wgmma_kernel<<<blocks_for(prm.M, kBM), kThreads, kSmemBytes,
                             stream>>>(wmap, prm);
  return (int)cudaGetLastError();
}

}  // namespace fused

// Launchers of the float32 im2col and of K2, dispatched on the channels a
// thread takes (nc) and the elements a load takes (vec, a power of two
// dividing nc, as wide as the data's alignment allows).
template <int NC, int V = (NC < 4 ? NC : 4)>
void launch_im2col(int vec, const void* x, const void* head,
                   const void* flow1, const void* flow2, void* col, int N,
                   int H, int W, int Cin, int Ho, int Wo, int G, int K,
                   int kw, int pad, float max_residue, cudaStream_t stream) {
  if constexpr (V > 1) {
    if (vec < V)
      return launch_im2col<NC, V / 2>(vec, x, head, flow1, flow2, col, N, H,
                                      W, Cin, Ho, Wo, G, K, kw, pad,
                                      max_residue, stream);
  }
  const long long total = (long long)N * Ho * Wo * G * K;
  if (total == 0) return;
  deform_im2col_kernel<NC, V><<<blocks_for(total, 256), 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(head),
      static_cast<const float*>(flow1), static_cast<const float*>(flow2),
      static_cast<float*>(col), N, H, W, Cin, Ho, Wo, G, K, kw, pad,
      max_residue);
}

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

// float32 K1's sampler: the im2col matrix (N*Ho*Wo, G*K*CG)
extern "C" int e2fgvi_deform_im2col(int nc, int vec, const void* x,
                                    const void* head, const void* flow1,
                                    const void* flow2, void* col, int N,
                                    int H, int W, int Cin, int Ho, int Wo,
                                    int G, int K, int kw, int pad,
                                    float max_residue, int device,
                                    void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nc) {
    case 16: e2fgvi::launch_im2col<16>(vec, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    case 8: e2fgvi::launch_im2col<8>(vec, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    case 4: e2fgvi::launch_im2col<4>(vec, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    case 2: e2fgvi::launch_im2col<2>(vec, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
    default: e2fgvi::launch_im2col<1>(vec, x, head, flow1, flow2, col, N, H, W, Cin, Ho, Wo, G, K, kw, pad, max_residue, s); break;
  }
  return (int)cudaGetLastError();
}

// bfloat16 K1, sampler and contraction in one kernel: out (N*Ho*Wo, 128)
// bf16 = samples x wk^T + bias. wk (128, G*K*16) bf16 K-major; bias (128,)
// float32; Cin = 16*G and G*K a multiple of 4; x, wk and out 16-byte
// aligned, head, the flows and bias 8-byte aligned.
extern "C" int e2fgvi_deform_conv_fused(
    const void* x, const void* head, const void* flow1, const void* flow2,
    const void* wk, const void* bias, void* out, int N, int H, int W,
    int Cin, int Ho, int Wo, int G, int K, int kw, int pad,
    float max_residue, int device, void* stream) {
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  using e2fgvi::hopper::bf16;
  e2fgvi::fused::Params prm;
  prm.x = static_cast<const bf16*>(x);
  prm.head = static_cast<const bf16*>(head);
  prm.flow1 = static_cast<const float*>(flow1);
  prm.flow2 = static_cast<const float*>(flow2);
  prm.bias = static_cast<const float*>(bias);
  prm.out = static_cast<bf16*>(out);
  prm.M = N * Ho * Wo;
  prm.H = H, prm.W = W, prm.Cin = Cin, prm.Ho = Ho, prm.Wo = Wo;
  prm.G = G, prm.K = K, prm.kw = kw, prm.pad = pad;
  prm.chunks = G * K * e2fgvi::fused::kCG / e2fgvi::fused::kBK;
  prm.max_residue = max_residue;
  return e2fgvi::fused::launch(prm, wk, static_cast<cudaStream_t>(stream));
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
