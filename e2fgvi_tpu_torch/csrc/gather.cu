// E3 row_gather and E4 bilinear4_sample: the gather formulations of the
// DCN sampler that scripts/exp_gather.py measured on the TPU.
//
// Replaces the TPU experiment kernels scripts/exp_gather.py `v2` (inner
// `kernel` at :123, pallas_call :127: a per-lane row gather from a VMEM
// resident (P, 128) table, Mosaic's tpu.dynamic_gather) and `v3` (inner
// `kernel` at :171, pallas_call :194: four such gathers fused with the
// bilinear weights). On the TPU the table had to sit in VMEM and the index
// array had to match the table's shape. Here the table lies in device
// memory; at P = 6480 rows of 128 lanes (3.3 MB in float32) it stays in
// the 50 MB L2.
//
// E3 is bound by bytes: at (9, 6480, 128) it reads 30 MB of int32 indices
// and writes 15 MB (bfloat16) or 30 MB (float32); the table's reads hit
// L2. One thread takes L consecutive lanes of an output row (L = 8 where
// C % 8 == 0 and both bases are 16-byte aligned; 4, 2 or 1 lanes at
// other C and alignments): its indices come in as 16-byte loads, its
// output goes out as 16-byte stores, both streamed past L2 (ld/st.cs).
// Where the L indices agree and lie in [0, P) (a DCN's lanes of one group
// share a row, as the experiment's inputs do), the table row's L values
// are 16- or 32-byte loads; otherwise each lane loads on its own and an
// index outside [0, P) gives 0. Offsets are 32-bit where every element
// offset of the table and the index array fits in an int, 64-bit above.
// The grid is 4 blocks an SM striding over the rows (kBlocksPerSM): on
// the H100 that came nearest the DRAM bound of the grids tried (2 to 8
// blocks an SM; one thread per 8 lanes, 3,641 blocks, was slowest).
//
// E4 was bound by L2 sectors: lane j samples group j % G, so a group's
// C/G channels lie G lanes apart and each of its 4-byte reads took a
// 32-byte sector of its own (58,320 rows x 16 groups x 8 lanes x 4
// corners x 32 B = 955 MB at the experiment's shapes, for a 3.3 MB
// table). The entry point first rewrites the table group-major,
// tabg[g, p, k] = tab[p, k*G + g] (group_major_kernel: 32 rows a block
// through shared memory, 3.3 MB in and out), so that one (row, group,
// corner) read is C/G consecutive floats: one 32-byte sector at C/G = 8
// (119 MB in all), and the two x-corners of a row share 64 bytes. Two
// threads split a (row, group) at C/G = 8, one 16-byte load a corner
// each, so that a warp's load asks L1 for 16 whole sectors and not 32
// half-used ones: on the H100 one thread reading a (row, group)'s 32
// bytes a corner took nearly twice as long. The
// sampler sums the four corners in the order (y0,x0), (y0,x0+1),
// (y0+1,x0), (y0+1,x0+1) with __fmul_rn/__fadd_rn, and stages the block's
// rows in shared memory, so they go out in lane order as 16-byte stores.
#include "common.cuh"

namespace e2fgvi {
namespace gather {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;   // group_major_kernel: table rows a block
constexpr int kStagePad = 16;   // sampler: floats of padding a staged row
// E3's grid: blocks an SM, striding over the rest (on the H100 2, 3, 6 and 8
// blocks an SM, and one thread per L lanes, were as fast or slower)
constexpr int kBlocksPerSM = 4;

// L values of T as the 32-bit words of load_words (common.cuh), moved in
// accesses of min(16, L * sizeof(T)) bytes, to which the address must be
// aligned; STREAM: streamed past L2, for data read or written once
template <typename T, int L>
struct Lanes {
  static constexpr int kBytes = static_cast<int>(sizeof(T)) * L;
  static constexpr int kStep = kBytes < 16 ? kBytes : 16;   // bytes an access
  unsigned w[words_of<T, L>()];
  __device__ __forceinline__ T& operator[](int i) {
    return reinterpret_cast<T*>(w)[i];
  }
  __device__ __forceinline__ const T& operator[](int i) const {
    return reinterpret_cast<const T*>(w)[i];
  }
};

template <typename T, int L, bool STREAM = false>
__device__ __forceinline__ Lanes<T, L> load_lanes(const T* p) {
  using V = Lanes<T, L>;
  V r;
#pragma unroll
  for (int i = 0; i < V::kBytes / V::kStep; ++i)
    load_words<V::kStep, STREAM>(reinterpret_cast<const char*>(p)
                                     + i * V::kStep, r.w + i * 4);
  return r;
}

template <typename T, int L, bool STREAM = false>
__device__ __forceinline__ void store_lanes(T* p, const Lanes<T, L>& v) {
  using V = Lanes<T, L>;
#pragma unroll
  for (int i = 0; i < V::kBytes / V::kStep; ++i)
    store_words<V::kStep, STREAM>(reinterpret_cast<char*>(p) + i * V::kStep,
                                  v.w + i * 4);
}

// E3: a thread takes L consecutive lanes of an output row at a time, in a
// grid-stride loop; I is the offset type: unsigned where every offset is
// under 2**31 (the loop's v + stride then stays under 2**32), else
// long long
template <typename T, int L, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ tab, const int* __restrict__ idx,
                  T* __restrict__ out, I n_vec, int P, int C) {
  const int vec_per_row = C / L;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; v < n_vec;
       v += stride) {
    const I e = v * L;                              // row * C + j0
    const int j0 = static_cast<int>(v % vec_per_row) * L;
    const Lanes<int, L> r = load_lanes<int, L, true>(idx + e);
    bool same = true;
#pragma unroll
    for (int i = 1; i < L; ++i) same &= r[i] == r[0];
    Lanes<T, L> o;
    if (same && static_cast<unsigned>(r[0]) < static_cast<unsigned>(P)) {
      o = load_lanes<T, L>(tab + static_cast<I>(r[0]) * C + j0);
    } else {
#pragma unroll
      for (int i = 0; i < L; ++i)
        o[i] = static_cast<unsigned>(r[i]) < static_cast<unsigned>(P)
                   ? tab[static_cast<I>(r[i]) * C + j0 + i]
                   : from_f32<T>(0.f);
    }
    store_lanes<T, L, true>(out + e, o);
  }
}

// E4, step 1: tabg[g, p, k] = tab[p, k*G + g]. A block reads 32 table rows
// in order into shared memory (rows padded to C + 1 floats, so the 32
// lanes of a warp, one row each, read 32 banks), then one thread per
// (group, row) writes the row's C/G channels of the group, consecutive in
// tabg: a warp writes 32 consecutive rows of one group.
__global__ void __launch_bounds__(kThreads)
group_major_kernel(const float* __restrict__ tab, float* __restrict__ tabg,
                   int HW, int G, int C) {
  extern __shared__ float tile[];                   // kTileRows x (C + 1)
  const int S = C + 1, CG = C / G;
  const int p0 = blockIdx.x * kTileRows;
  const int nr = min(kTileRows, HW - p0);
  const float* src = tab + static_cast<long long>(p0) * C;
  for (int i = threadIdx.x; i < nr * C; i += kThreads) {
    const int r = i / C;
    tile[r * S + (i - r * C)] = __ldg(src + i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * kTileRows; i += kThreads) {
    const int g = i / kTileRows, r = i - g * kTileRows;
    if (r >= nr) continue;
    float* d = tabg + (static_cast<long long>(g) * HW + p0 + r) * CG;
    const float* s = tile + r * S + g;
    if (CG % 4 == 0) {                              // tabg is 16-byte aligned
      for (int k = 0; k < CG; k += 4)
        *reinterpret_cast<float4*>(d + k) = make_float4(
            s[k * G], s[(k + 1) * G], s[(k + 2) * G], s[(k + 3) * G]);
    } else {
      for (int k = 0; k < CG; ++k) d[k] = s[k * G];
    }
  }
}

// E4, step 2: the threads of a (row, group) compute its corners and
// weights and read VW-float runs of each corner: where C/G % 4 == 0 (VW =
// 4), C/G / 4 threads, one 16-byte load a corner each, so a warp's load
// covers 16 (row, group)s' 32-byte sectors in full (a thread reading all
// 32 bytes would ask L1 for 32 half-used sectors a load); else one thread
// reads the C/G floats one by one. The sums go to shared memory at their
// lanes (rows padded by kStagePad floats), then out in lane order: the
// block's `rb` rows of `out` are contiguous.
template <int VW>
__global__ void __launch_bounds__(kThreads)
bilinear4_group_major_kernel(const float* __restrict__ tabg,
                             const float* __restrict__ py,
                             const float* __restrict__ px,
                             float* __restrict__ out, int rows, int G, int C,
                             int H, int W, int rb) {
  extern __shared__ float4 stage4[];                // rb x (C + kStagePad)
  float* stage = reinterpret_cast<float*>(stage4);
  const int S = C + kStagePad, CG = C / G;
  const int sub = VW == 4 ? CG / 4 : 1;             // threads a (row, group)
  const int per = VW == 4 ? 4 : CG;                 // channels a thread
  const long long row0 = static_cast<long long>(blockIdx.x) * rb;
  const int nr = static_cast<int>(min(static_cast<long long>(rb),
                                      rows - row0));
  const long long plane = static_cast<long long>(H) * W * CG;
  for (int i = threadIdx.x; i < nr * G * sub; i += kThreads) {
    const int rg = i / sub, q = i - rg * sub;       // (row, group), chunk
    const int r = rg / G, g = rg - r * G;
    const long long e = row0 * G + rg;
    const float fy = __ldg(py + e), fx = __ldg(px + e);
    const float y0 = fminf(fmaxf(floorf(fy), 0.f), static_cast<float>(H - 2));
    const float x0 = fminf(fmaxf(floorf(fx), 0.f), static_cast<float>(W - 2));
    const float wy0 = fmaxf(1.f - fabsf(fy - y0), 0.f);
    const float wy1 = fmaxf(1.f - fabsf(fy - (y0 + 1.f)), 0.f);
    const float wx0 = fmaxf(1.f - fabsf(fx - x0), 0.f);
    const float wx1 = fmaxf(1.f - fabsf(fx - (x0 + 1.f)), 0.f);
    const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
    const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
    const float* t0 = tabg + g * plane
        + static_cast<long long>(static_cast<int>(y0) * W
                                 + static_cast<int>(x0)) * CG + q * per;
    const float* t1 = t0 + static_cast<long long>(W) * CG;
    float* s = stage + r * S + q * per * G + g;
    for (int k = 0; k < per; k += VW) {
      const Lanes<float, VW> a = load_lanes<float, VW>(t0 + k);
      const Lanes<float, VW> b = load_lanes<float, VW>(t0 + CG + k);
      const Lanes<float, VW> c = load_lanes<float, VW>(t1 + k);
      const Lanes<float, VW> d = load_lanes<float, VW>(t1 + CG + k);
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        float acc = __fmul_rn(a[u], w00);
        acc = __fadd_rn(acc, __fmul_rn(b[u], w01));
        acc = __fadd_rn(acc, __fmul_rn(c[u], w10));
        acc = __fadd_rn(acc, __fmul_rn(d[u], w11));
        s[(k + u) * G] = acc;
      }
    }
  }
  __syncthreads();
  float* o = out + row0 * C;
  if (C % 4 == 0) {                   // out is 16-byte aligned, so is row0*C
    const int c4 = C / 4;
    for (int i = threadIdx.x; i < nr * c4; i += kThreads) {
      const int r = i / c4;
      __stcs(reinterpret_cast<float4*>(o) + i,
             *reinterpret_cast<const float4*>(stage + r * S
                                              + (i - r * c4) * 4));
    }
  } else {
    for (int i = threadIdx.x; i < nr * C; i += kThreads) {
      const int r = i / C;
      __stcs(o + i, stage[r * S + (i - r * C)]);
    }
  }
}

// the device's SM count, read once a device
inline int sm_count(int device) {
  static int counts[64] = {0};
  int n = device >= 0 && device < 64 ? counts[device] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (device >= 0 && device < 64) counts[device] = n;
  }
  return n;
}

template <typename T, typename I>
cudaError_t launch_row_gather_at(int lanes, const void* tab,
                                 const void* idx, void* out, long long n_elem,
                                 int P, int C, int device, cudaStream_t s) {
  const long long n_vec = n_elem / lanes;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  const long long cap =
      static_cast<long long>(kBlocksPerSM) * sm_count(device);
  if (blocks > cap) blocks = cap;
  const auto* t = static_cast<const T*>(tab);
  const auto* i = static_cast<const int*>(idx);
  auto* o = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  const I nv = static_cast<I>(n_vec);
  switch (lanes) {
    case 8:
      row_gather_kernel<T, 8, I><<<grid, kThreads, 0, s>>>(t, i, o, nv, P, C);
      break;
    case 4:
      row_gather_kernel<T, 4, I><<<grid, kThreads, 0, s>>>(t, i, o, nv, P, C);
      break;
    case 2:
      row_gather_kernel<T, 2, I><<<grid, kThreads, 0, s>>>(t, i, o, nv, P, C);
      break;
    case 1:
      row_gather_kernel<T, 1, I><<<grid, kThreads, 0, s>>>(t, i, o, nv, P, C);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_row_gather(int lanes, const void* tab, const void* idx,
                              void* out, int rows, int P, int C, int device,
                              cudaStream_t s) {
  const long long n_elem = static_cast<long long>(rows) * C;
  const long long span = static_cast<long long>(rows > P ? rows : P) * C;
  return span < (1LL << 31)
      ? launch_row_gather_at<T, unsigned>(lanes, tab, idx, out, n_elem, P,
                                          C, device, s)
      : launch_row_gather_at<T, long long>(lanes, tab, idx, out, n_elem, P,
                                           C, device, s);
}

}  // namespace gather
}  // namespace e2fgvi

// Plain C entry points, loaded with ctypes (kernels/build.py). Each makes
// `device` current, launches on `stream` and returns cudaGetLastError().

// `lanes`: lanes a thread (8, 4, 2 or 1), chosen by the wrapper so that C
// is a multiple and tab and idx are aligned to a thread's loads.
extern "C" int e2fgvi_row_gather(int dtype, int lanes, const void* tab,
                                 const void* idx, void* out, int rows, int P,
                                 int C, int device, void* stream) {
  using namespace e2fgvi;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (static_cast<long long>(rows) * C == 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kBFloat16
          ? gather::launch_row_gather<__nv_bfloat16>(lanes, tab, idx, out,
                                                     rows, P, C, device, s)
          : gather::launch_row_gather<float>(lanes, tab, idx, out, rows, P,
                                             C, device, s));
}

// `tabg`: scratch of h*w*C floats for the group-major table.
extern "C" int e2fgvi_bilinear4_sample(const void* tab, const void* py,
                                       const void* px, void* out, void* tabg,
                                       int rows, int G, int C, int H, int W,
                                       int device, void* stream) {
  using namespace e2fgvi::gather;
  const cudaError_t dev_err = e2fgvi::use_device(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (static_cast<long long>(rows) * G == 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = H * W;
  const size_t tile_bytes = sizeof(float) * kTileRows * (C + 1);
  if (tile_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_major_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tile_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  group_major_kernel<<<(hw + kTileRows - 1) / kTileRows, kThreads,
                       tile_bytes, s>>>(static_cast<const float*>(tab),
                                        static_cast<float*>(tabg), hw, G, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // rows a block: as many rows as fill 256 threads (C/4 threads a row
  // where C/G % 4 == 0, else G) within 48 KB of staging
  const bool vec4 = (C / G) % 4 == 0;
  int rb = kThreads / (vec4 ? C / 4 : G);
  const int rb_smem = 48 * 1024 / (static_cast<int>(sizeof(float))
                                   * (C + kStagePad));
  if (rb > rb_smem) rb = rb_smem;
  if (rb < 1) rb = 1;
  const unsigned blocks = static_cast<unsigned>((rows + rb - 1) / rb);
  const size_t stage_bytes = sizeof(float) * rb * (C + kStagePad);
  const auto* g = static_cast<const float*>(tabg);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  auto* o = static_cast<float*>(out);
  if (vec4)
    bilinear4_group_major_kernel<4><<<blocks, kThreads, stage_bytes, s>>>(
        g, y, x, o, rows, G, C, H, W, rb);
  else
    bilinear4_group_major_kernel<1><<<blocks, kThreads, stage_bytes, s>>>(
        g, y, x, o, rows, G, C, H, W, rb);
  return static_cast<int>(cudaGetLastError());
}
