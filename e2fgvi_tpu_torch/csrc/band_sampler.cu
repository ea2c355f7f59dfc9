// E1, E5, E6: the banded DCN sampler's inner-loop variants.
//
// Replaces the TPU experiment kernels scripts/exp_dcn_inner_r04.py
// (E5: base_kernel, bf16_kernel, cbatch_kernel, run at :54; E6:
// packed_kernel, run_packed at :246 and its base baseline at :272) and
// scripts/exp_dcn_pack.py (E1: _packed_kernel, _build_packed at :96). They
// all compute e2fgvi_tpu/kernels/dcn_band.py::_sampler_kernel's function
// (kernels/band_sampler.py states it): per output element, a band of
// candidate source rows weighted by relu(1 - |py - row|), each a two-corner
// linear interpolation along x, times the mask.
//
// On the TPU the band sweep exists because a lane gather is the only
// dynamic read: every row of the band is gathered and most get weight 0.
// Here a thread reads its own addresses, so it computes floor(py) and adds
// only the two rows that can have a nonzero weight, each gated by the band
// test. For finite inputs that equals the sweep (the skipped terms are
// exact zeros).
//
// What bounds E5 and E6 on the H100: bytes, the output stream (at the E5
// shape 224*9*16*64*128 = 264M outputs, 0.53 GB in bfloat16) and the
// positions and mask (0.20 GB), beside 0.08 GB of source. Every tap
// (K = 9) and every channel of one (batch, group) tile i reads the same
// source slab, and output rows [y0, y0 + Ty) reach only slab rows
// [y0, y0 + Ty + band - 1). So the staged kernel (band_staged_kernel) runs
// one block per (i, y-tile) for all taps and channels: it copies those
// rows of a chunk of channels into shared memory once (16-byte cp.async
// copies completing on an mbarrier, double-buffered across chunks; the
// bytes of a row pitch that is no multiple of 16 by 2-byte plain copies),
// each thread reads the positions and mask of VX consecutive x once per
// chunk in 16-byte loads, runs band_taps once for them and loops over the
// chunk's channels, reading corners from shared memory and writing its VX
// outputs of a channel in one streaming store. kernels/band_sampler.py
// `plan` picks Ty and the chunk within the 227 KB a block may use. With
// the global stream cut to ~1-2 GB through L2, the random corner reads'
// shared-memory bank conflicts come next, so staged rows are padded by 16
// bytes (the rows of one warp load then fall on spread banks) and a
// thread issues all its corner loads of a channel before it uses any
// (branch-free: a row outside the band reads the slab's first element and
// is then dropped), so they overlap. One template serves:
//   E5 base/bf16   band_sample: float32 or bfloat16 source (two 32- or
//                  16-bit shared loads a row), bf16(acc) * bf16(mask) or,
//                  in float32, acc * mask;
//   E5 cbatch      band_sample_cbatch: one rounding, (acc * mask);
//   E6             band_sample_xpair: words src[x] << 16 | src[x+1], one
//                  aligned 32-bit shared load a row gives both x corners;
//   E1             band_sample_cpair: words of channels 2c (low half) and
//                  2c+1, staged as E5 stages its bf16 channels (the same
//                  bytes); one 32-bit shared load a corner and row gives
//                  both channels: half E5's corner loads for its outputs.
// All sum in one fixed order with the rounding intrinsics (no FMA
// contraction), so xpair and cpair are bit-equal to band_sample on the same
// bfloat16 source, and the float32 sums equal the plain version's.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace e2fgvi {

// The two candidate rows of one output element: slab rows (-1 = outside
// the band) and the per-row weights of the x0 and x0+1 corners.
struct BandTaps {
  int row[2];
  float w0[2], w1[2];
  int x0;
};

__device__ __forceinline__ BandTaps band_taps(float py, float px, int y,
                                              int dy_lo, int band, int wp) {
  BandTaps b;
  const float x0f = fminf(fmaxf(floorf(px), 0.f), (float)(wp - 2));
  b.x0 = (int)x0f;
  const float wx0 = fmaxf(1.f - fabsf(px - x0f), 0.f);
  const float wx1 = fmaxf(1.f - fabsf(px - (x0f + 1.f)), 0.f);
  const float yr0 = floorf(py);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float yr = yr0 + (float)s;           // image row
    const float r = yr - (float)(y + dy_lo);   // its band index
    const bool ok = r >= 0.f && r < (float)band;
    const float wy = fmaxf(1.f - fabsf(py - yr), 0.f);
    b.row[s] = ok ? y + (int)r : -1;
    b.w0[s] = __fmul_rn(wy, wx0);
    b.w1[s] = __fmul_rn(wy, wx1);
  }
  return b;
}

// acc + (g0 * w0 + g1 * w1), rounded in that order
__device__ __forceinline__ float band_term(float acc, float g0, float g1,
                                           float w0, float w1) {
  return __fadd_rn(acc, __fadd_rn(__fmul_rn(g0, w0), __fmul_rn(g1, w1)));
}

template <typename TO>
__device__ __forceinline__ TO band_out(float acc, float m);
template <>
__device__ __forceinline__ float band_out<float>(float acc, float m) {
  return __fmul_rn(acc, m);
}
// bf16(acc) * bf16(mask): the product of two bf16 values is exact in f32,
// so one more rounding gives the correctly rounded bf16 product
template <>
__device__ __forceinline__ __nv_bfloat16 band_out<__nv_bfloat16>(float acc,
                                                                float m) {
  const float a = __bfloat162float(__float2bfloat16(acc));
  const float mb = __bfloat162float(__float2bfloat16(m));
  return __float2bfloat16(__fmul_rn(a, mb));
}

__device__ __forceinline__ float bf16_hi(unsigned g) {
  return __uint_as_float(g & 0xffff0000u);
}
__device__ __forceinline__ float bf16_lo(unsigned g) {
  return __uint_as_float(g << 16);
}

// ---------------------------------------------------------------------------
// E5 (base, bf16, cbatch), E6 and E1: one block per (i, y-tile), all K taps
// and CG source channels (E1: CG channel-pair words), the tile's slab rows
// staged in shared memory by channel chunk. out (NG, K, CG * lanes, HP,
// WP), lanes the output channels a source element holds (2 for E1, else 1).
// ---------------------------------------------------------------------------
namespace band {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;   // 227 KB: the most a block may use

struct XPair {};  // source tag: 32-bit words src[x] << 16 | src[x+1]
struct CPair {};  // source tag: 32-bit words, bf16 channel 2c in the low
                  // half, 2c+1 in the high half (pack_cpairs)

// T: a staged element; kLanes: the output channels it holds
template <typename S>
struct Elem {
  using T = S;
  static constexpr int kLanes = 1;
};
template <>
struct Elem<XPair> {
  using T = unsigned;
  static constexpr int kLanes = 1;
};
template <>
struct Elem<CPair> {
  using T = unsigned;
  static constexpr int kLanes = 2;
};

// The x0 and x0+1 corners of one staged row, p at x0, as loaded: get(l, x)
// is corner x of output channel l in float32. E6 reads one word for both
// corners; E1 one word a corner for both channels.
template <typename S>
struct Corners {
  typename Elem<S>::T a, b;
  __device__ __forceinline__ void load(const typename Elem<S>::T* p) {
    a = p[0];
    b = p[1];
  }
  __device__ __forceinline__ float get(int, int x) const {
    return to_f32(x ? b : a);
  }
};
template <>
struct Corners<XPair> {
  unsigned a;
  __device__ __forceinline__ void load(const unsigned* p) { a = p[0]; }
  __device__ __forceinline__ float get(int, int x) const {
    return x ? bf16_lo(a) : bf16_hi(a);
  }
};
template <>
struct Corners<CPair> {
  unsigned a, b;
  __device__ __forceinline__ void load(const unsigned* p) {
    a = p[0];
    b = p[1];
  }
  __device__ __forceinline__ float get(int l, int x) const {
    const unsigned g = x ? b : a;
    return l ? bf16_hi(g) : bf16_lo(g);
  }
};

// E5 and E6 write band_out (bf16(acc) * bf16(mask), or acc * mask in
// float32); cbatch rounds once, (acc * mask)
template <typename TO, bool ONE_ROUNDING>
__device__ __forceinline__ TO epilogue(float acc, float m) {
  if constexpr (ONE_ROUNDING) return from_f32<TO>(__fmul_rn(acc, m));
  else return band_out<TO>(acc, m);
}

__device__ __forceinline__ unsigned bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ unsigned bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// VX consecutive float32 at p (aligned to VX * 4 bytes up to 16)
template <int VX>
__device__ __forceinline__ void load_vx(const float* p, float (&v)[VX]) {
  if constexpr (VX == 1) {
    v[0] = __ldg(p);
  } else {
    unsigned w[VX];
#pragma unroll
    for (int j = 0; j < VX; j += 4) load_words<16>(p + j, w + j);
#pragma unroll
    for (int j = 0; j < VX; ++j) v[j] = __uint_as_float(w[j]);
  }
}

// VX consecutive outputs at p by streaming stores of up to 16 bytes
template <typename TO, int VX>
__device__ __forceinline__ void store_vx(TO* p, const TO (&v)[VX]) {
  constexpr int kBytes = VX * (int)sizeof(TO);
  unsigned w[(kBytes + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < VX; ++j) {
    if constexpr (sizeof(TO) == 4) w[j] = bits(v[j]);
    else w[j / 2] |= bits(v[j]) << (16 * (j % 2));   // little-endian pairs
  }
  if constexpr (kBytes <= 16) {
    store_words<kBytes, true>(p, w);
  } else {
#pragma unroll
    for (int j = 0; j < kBytes / 16; ++j)
      store_words<16, true>(reinterpret_cast<char*>(p) + 16 * j, w + 4 * j);
  }
}

// the staged rows of one tile: [y0, y0 + rows), rows = min(tyn + band - 1,
// HS - y0); kernels/band_sampler.py `BandPlan.tiles` states the same
struct Tile {
  int i, y0, tyn, rows;
};

// One channel chunk's rows into shared memory at buf, slot_bytes a
// channel. Rows whose global pitch is a multiple of 16 bytes (on a 16-byte
// aligned source) go row by row to a shared pitch 16 bytes longer, which
// spreads the random rows' corners over the banks; others go as one
// contiguous run, at the offset of its global address mod 16 so that the
// 16-byte copies line up, the unaligned ends by 2-byte plain copies. Every
// thread arrives on `bar` twice: once when its cp.async copies land
// (noinc) and once, with release semantics, after its plain copies.
__device__ __forceinline__ void stage_chunk(const unsigned char* src,
                                            unsigned char* buf, uint32_t bar,
                                            const Tile& tl, int c0, int cn,
                                            int CG, int HS, int row_bytes,
                                            int pitch, int slot_bytes) {
  for (int cc = 0; cc < cn; ++cc) {
    const unsigned char* g =
        src + (((long long)tl.i * CG + c0 + cc) * HS + tl.y0) * row_bytes;
    unsigned char* d = buf + cc * slot_bytes;
    if (pitch != row_bytes) {
      const int per_row = row_bytes / 16;
      for (int j = threadIdx.x; j < tl.rows * per_row; j += blockDim.x) {
        const int r = j / per_row, b = 16 * (j - r * per_row);
        hopper::cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                               d + r * pitch + b)),
                           g + r * row_bytes + b, 16);
      }
      continue;
    }
    const int nbytes = tl.rows * row_bytes;
    const int mis = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    d += mis;
    const int head = min((16 - mis) & 15, nbytes);
    const int n16 = (nbytes - head) / 16;
    const int tail = head + 16 * n16;
    for (int j = threadIdx.x; j < n16; j += blockDim.x) {
      const int b = head + 16 * j;
      hopper::cp_async16(
          static_cast<uint32_t>(__cvta_generic_to_shared(d + b)), g + b, 16);
    }
    const int nsmall = (head + nbytes - tail) / 2;
    for (int j = threadIdx.x; j < nsmall; j += blockDim.x) {
      const int b = 2 * j < head ? 2 * j : tail + 2 * j - head;
      *reinterpret_cast<unsigned short*>(d + b) =
          __ldg(reinterpret_cast<const unsigned short*>(g + b));
    }
  }
  hopper::cp_async_arrive_noinc(bar);
  hopper::mbar_arrive(bar);
}

// S: float, __nv_bfloat16, XPair or CPair; TO: the output; VX: consecutive
// x a thread takes (WP % VX == 0, the position and output rows aligned to
// it)
template <typename S, typename TO, bool ONE_ROUNDING, int VX>
__global__ void __launch_bounds__(kThreads,
                                  VX * Elem<S>::kLanes >= 8 ? 2 : 3)
band_staged_kernel(const unsigned char* __restrict__ src,
                   const float* __restrict__ py,
                   const float* __restrict__ px,
                   const float* __restrict__ mask, TO* __restrict__ out,
                   int K, int CG, int HP, int WP, int band, int dy_lo,
                   int ty, int chunk, int pitch, int slot_bytes) {
  using T = typename Elem<S>::T;
  constexpr int L = Elem<S>::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];
  const int ntiles = (HP + ty - 1) / ty;
  Tile tl;
  tl.i = blockIdx.x / ntiles;
  tl.y0 = (blockIdx.x % ntiles) * ty;
  tl.tyn = min(ty, HP - tl.y0);
  const int HS = HP + band;
  tl.rows = min(tl.tyn + band - 1, HS - tl.y0);
  const int row_bytes = WP * (int)sizeof(T);
  const int nchunks = (CG + chunk - 1) / chunk;
  const uint32_t bar0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(&full[0]));
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar0, 2 * blockDim.x);
    hopper::mbar_init(bar0 + 8, 2 * blockDim.x);
  }
  __syncthreads();

  const int pitch_e = pitch / (int)sizeof(T);   // shared row pitch
  const int ngx = WP / VX;
  const int ntasks = K * tl.tyn * ngx;
  const long long plane = (long long)HP * WP;
  stage_chunk(src, smem, bar0, tl, 0, min(chunk, CG), CG, HS, row_bytes,
              pitch, slot_bytes);
  for (int k = 0; k < nchunks; ++k) {
    const int c0 = k * chunk;
    if (k + 1 < nchunks) {       // the other buffer, free since the sync
      const int c1 = c0 + chunk;
      stage_chunk(src, smem + ((k + 1) & 1) * chunk * slot_bytes,
                  bar0 + 8 * ((k + 1) & 1), tl, c1, min(chunk, CG - c1), CG,
                  HS, row_bytes, pitch, slot_bytes);
    }
    hopper::mbar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);
    const unsigned char* buf = smem + (k & 1) * chunk * slot_bytes;
    const int cn = min(chunk, CG - c0);
    // each channel's rows start at its global address mod 16 (stage_chunk;
    // 0 where the rows are padded)
    const uintptr_t g0 = reinterpret_cast<uintptr_t>(src) +
        (((uintptr_t)tl.i * CG + c0) * HS + tl.y0) * row_bytes;
    const uintptr_t cpitch = (uintptr_t)HS * row_bytes;

    // positions of the thread's next task, loaded a task ahead
    float vy[VX], vx[VX], vm[VX];
    auto load_task = [&](int task) {
      const int xg = task % ngx;
      const int r = task / ngx;
      const long long pos =
          (((long long)tl.i * K + r / tl.tyn) * HP + tl.y0 + r % tl.tyn) *
              WP + xg * VX;
      load_vx<VX>(py + pos, vy);
      load_vx<VX>(px + pos, vx);
      load_vx<VX>(mask + pos, vm);
    };
    if (threadIdx.x < ntasks) load_task(threadIdx.x);
    for (int task = threadIdx.x; task < ntasks; task += blockDim.x) {
      const int xg = task % ngx;
      const int r = task / ngx;
      const int t = r / tl.tyn;
      const int y = tl.y0 + r % tl.tyn;
      // each candidate row as an element offset into the staged slab
      // (-1: outside the band) and its corner weights
      int off[VX][2];
      float w0[VX][2], w1[VX][2], m[VX];
#pragma unroll
      for (int v = 0; v < VX; ++v) {
        const BandTaps b = band_taps(vy[v], vx[v], y, dy_lo, band, WP);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          off[v][s] =
              b.row[s] < 0 ? -1 : (b.row[s] - tl.y0) * pitch_e + b.x0;
          w0[v][s] = b.w0[s];
          w1[v][s] = b.w1[s];
        }
        m[v] = vm[v];
      }
      if (task + (int)blockDim.x < ntasks) load_task(task + blockDim.x);
      TO* o = out + (((long long)tl.i * K + t) * CG + c0) * L * plane +
              (long long)y * WP + xg * VX;
      uintptr_t ga = g0;
#pragma unroll 2
      for (int cc = 0; cc < cn; ++cc, o += L * plane, ga += cpitch) {
        const T* p = reinterpret_cast<const T*>(buf + cc * slot_bytes +
                                                (ga & 15));
        // every corner is loaded (a row outside the band from the slab's
        // first element) before any is used, so the shared loads overlap;
        // a row outside the band then leaves acc as it was, as a skip would
        Corners<S> cr[VX][2];
#pragma unroll
        for (int v = 0; v < VX; ++v) {
#pragma unroll
          for (int s = 0; s < 2; ++s) cr[v][s].load(p + max(off[v][s], 0));
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          TO res[VX];
#pragma unroll
          for (int v = 0; v < VX; ++v) {
            float acc = 0.f;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const float a = band_term(acc, cr[v][s].get(l, 0),
                                        cr[v][s].get(l, 1), w0[v][s],
                                        w1[v][s]);
              acc = off[v][s] < 0 ? acc : a;
            }
            res[v] = epilogue<TO, ONE_ROUNDING>(acc, m[v]);
          }
          store_vx<TO, VX>(o + l * plane, res);
        }
      }
    }
    if (k + 1 < nchunks) __syncthreads();   // buffer k & 1 is read
  }
}

// shared bytes of one channel's staged rows: padded rows where the row
// pitch is a multiple of 16 bytes, else the contiguous run rounded up to
// 16 plus 16 for its alignment shift (which also holds padded rows'
// contiguous form, for a source that is not 16-byte aligned);
// kernels/band_sampler.py `_slot_bytes` computes the same
inline int slot_bytes(int ty, int band, int WP, int esize) {
  const int rows = ty + band - 1, row_bytes = WP * esize;
  if (row_bytes % 16 == 0) return rows * (row_bytes + 16);
  return (rows * row_bytes + 15) / 16 * 16 + 16;
}

template <typename S, typename TO, bool ONE_ROUNDING, int VX>
cudaError_t launch_vx(const void* src, const void* py, const void* px,
                      const void* mask, void* out, int NG, int K, int CG,
                      int HP, int WP, int band, int dy_lo, int ty, int chunk,
                      cudaStream_t s) {
  auto* kernel = band_staged_kernel<S, TO, ONE_ROUNDING, VX>;
  const int slot = slot_bytes(ty, band, WP, (int)sizeof(typename Elem<S>::T));
  const int nbuf = chunk < CG ? 2 : 1;
  const long long smem = (long long)nbuf * chunk * slot;
  if (smem > kMaxSmem - 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)NG * ((HP + ty - 1) / ty);
  const int row_bytes = WP * (int)sizeof(typename Elem<S>::T);
  const bool padded =
      row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  kernel<<<(unsigned)blocks, kThreads, (int)smem, s>>>(
      static_cast<const unsigned char*>(src), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<const float*>(mask),
      static_cast<TO*>(out), K, CG, HP, WP, band, dy_lo, ty, chunk,
      padded ? row_bytes + 16 : row_bytes, slot);
  return cudaGetLastError();
}

// vx: 8, 4 or 1 consecutive x a thread (the wrapper picks it from WP and
// the alignment of the position and output pointers); 4 or 1 for channel
// pairs, whose 8 would hold 16 outputs' corners and spill
template <typename S, typename TO, bool ONE_ROUNDING>
cudaError_t launch(const void* src, const void* py, const void* px,
                   const void* mask, void* out, int NG, int K, int CG,
                   int HP, int WP, int band, int dy_lo, int ty, int chunk,
                   int vx, cudaStream_t s) {
  if ((long long)NG * K * CG * HP * WP == 0) return cudaGetLastError();
  if (ty < 1 || chunk < 1 || chunk > CG || WP % vx != 0 || band < 1)
    return cudaErrorInvalidValue;
  switch (vx) {
    case 8:
      if constexpr (Elem<S>::kLanes == 1)
        return launch_vx<S, TO, ONE_ROUNDING, 8>(src, py, px, mask, out, NG,
                                                 K, CG, HP, WP, band, dy_lo,
                                                 ty, chunk, s);
      return cudaErrorInvalidValue;
    case 4:
      return launch_vx<S, TO, ONE_ROUNDING, 4>(src, py, px, mask, out, NG, K,
                                               CG, HP, WP, band, dy_lo, ty,
                                               chunk, s);
    case 1:
      return launch_vx<S, TO, ONE_ROUNDING, 1>(src, py, px, mask, out, NG, K,
                                               CG, HP, WP, band, dy_lo, ty,
                                               chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace band

}  // namespace e2fgvi

// Plain C entry points, loaded with ctypes (kernels/build.py). Each makes
// `device` current, launches on `stream` and returns cudaGetLastError().
// dtype codes: 0 float32, 1 bfloat16. band_sample takes (src, out) in
// (f32, f32), (bf16, bf16) or (f32, bf16); the wrapper refuses the rest.
// ty, chunk: kernels/band_sampler.py `plan`'s y-tile and channel chunk;
// vx: consecutive x a thread (8, 4 or 1).
extern "C" int e2fgvi_band_sample(int src_dtype, int out_dtype,
                                  const void* src, const void* py,
                                  const void* px, const void* mask, void* out,
                                  int NG, int K, int CG, int HP, int WP,
                                  int band, int dy_lo, int ty, int chunk,
                                  int vx, int device, void* stream) {
  using e2fgvi::kBFloat16;
  namespace b = e2fgvi::band;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dtype == kBFloat16 && out_dtype == kBFloat16) {
    return (int)b::launch<__nv_bfloat16, __nv_bfloat16, false>(
        src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, ty, chunk, vx,
        s);
  } else if (src_dtype != kBFloat16 && out_dtype == kBFloat16) {
    return (int)b::launch<float, __nv_bfloat16, false>(
        src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, ty, chunk, vx,
        s);
  } else if (src_dtype != kBFloat16 && out_dtype != kBFloat16) {
    return (int)b::launch<float, float, false>(
        src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, ty, chunk, vx,
        s);
  }
  return (int)cudaErrorInvalidValue;
}

// cbatch: (acc * mask) rounded once to src's dtype; in float32 that is
// band_sample's own arithmetic, so both share one kernel
extern "C" int e2fgvi_band_sample_cbatch(int dtype, const void* src,
                                         const void* py, const void* px,
                                         const void* mask, void* out, int NG,
                                         int K, int CG, int HP, int WP,
                                         int band, int dy_lo, int ty,
                                         int chunk, int vx, int device,
                                         void* stream) {
  namespace b = e2fgvi::band;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    return (int)b::launch<__nv_bfloat16, __nv_bfloat16, true>(
        src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, ty, chunk, vx,
        s);
  }
  return (int)b::launch<float, float, false>(
      src, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, ty, chunk, vx, s);
}

extern "C" int e2fgvi_band_sample_xpair(const void* psrc, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int NG, int K, int CG,
                                        int HP, int WP, int band, int dy_lo,
                                        int ty, int chunk, int vx,
                                        int device, void* stream) {
  namespace b = e2fgvi::band;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)b::launch<b::XPair, __nv_bfloat16, false>(
      psrc, py, px, mask, out, NG, K, CG, HP, WP, band, dy_lo, ty, chunk, vx,
      static_cast<cudaStream_t>(stream));
}

// CGP: channel-pair words; out has 2 * CGP channels
extern "C" int e2fgvi_band_sample_cpair(const void* psrc, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int NG, int K, int CGP,
                                        int HP, int WP, int band, int dy_lo,
                                        int ty, int chunk, int vx,
                                        int device, void* stream) {
  namespace b = e2fgvi::band;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)b::launch<b::CPair, __nv_bfloat16, false>(
      psrc, py, px, mask, out, NG, K, CGP, HP, WP, band, dy_lo, ty, chunk, vx,
      static_cast<cudaStream_t>(stream));
}
