// K3 focal_attention: softmax over two key panels for every
// (batch, window, head) of the temporal focal transformer (models/tfocal.py).
//
// Replaces the TPU kernel e2fgvi_tpu/kernels/fused_attention.py::_kernel
// (built by _build, entry fused_focal_attention). The interface is the
// same: q/ko/vo are (B*heads*nWin, n, hd) per-head window partitions, the
// gathered rolled + pooled keys kg/vg are (B*heads, T, nWin, S, hd) (the
// gather through the deduped key table stays a torch indexing op outside
// the kernel), the biases are per key in float32, and each head writes its
// hd-wide stripe of the (B*nWin, nq, heads*hd) output, ready for the proj
// GEMM.
//
// Where the TPU kernel held a whole window's logits in VMEM (~100 MB
// scoped), a Hopper block has at most 227 KB of shared memory, so this is a
// flash-style loop: one block per (b, window, head, 64-query tile) walks
// 64-key tiles of the own panel and then of the gathered panel, keeping a
// running max and sum per query row (online softmax) and the 64x128 output
// accumulator in registers. What bounds it on the H100 at serving shapes
// (B=14, 16 windows, 4 heads, nq=765, 765 + 17*125 keys, hd=128): the
// ~1.0 TFLOP of q.k and p.v per call, done here with float32 FMAs from
// shared memory (each thread owns a 4x4 logit tile and a 4x8 output tile,
// read as 16-byte vectors without bank conflicts) for float32, the parity
// path, and on tensor cores (mma.sync, below) for bfloat16, the serving
// path.
// Reading keys through the index table inside the kernel is later work.
//
// The biases are finite (-100 outside the pooled grid, ln(multiplicity) on
// deduped slots, -1e9 on padding frames); keys past a panel's end get -inf.
// Every 64-key tile holds at least one in-range key, so the running max is
// finite after the first tile and no row is ever all -inf.
#include <cmath>

#include "common.cuh"

namespace e2fgvi {

constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per tile
constexpr int kHD = 128;        // head width
constexpr int kThreads = 256;
constexpr int kRowStride = kHD + 4;  // Q/K/V rows: 16-byte aligned, no bank conflicts
constexpr int kPStride = kBK + 4;
constexpr int kSmemFloats =
    3 * 64 * kRowStride + kBQ * kPStride + kBK;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
focal_attention_kernel(const T* __restrict__ q, const T* __restrict__ ko,
                       const T* __restrict__ vo, const T* __restrict__ kg,
                       const T* __restrict__ vg,
                       const float* __restrict__ bias_o,
                       const float* __restrict__ bias_g, T* __restrict__ out,
                       int heads, int nwin, int nt, int S, int nq, int no) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [kBQ][kRowStride]
  float* Ks = Qs + kBQ * kRowStride;     // [kBK][kRowStride]
  float* Vs = Ks + kBK * kRowStride;     // [kBK][kRowStride]
  float* Ps = Vs + kBK * kRowStride;     // [kBQ][kPStride]
  float* Bs = Ps + kBQ * kPStride;       // [kBK]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;   // query rows tr*4 .. tr*4+3
  const int tc = tid & 15;   // logit cols tc + 16*c; output cols tc*4 (+64)
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;             // b * nwin + w
  const int b = bw / nwin, w = bw % nwin;
  const long long bhw = ((long long)b * heads + h) * nwin + w;

  const T* qp = q + (bhw * nq + q0) * kHD;
  for (int e = tid; e < kBQ * kHD; e += kThreads) {
    const int r = e / kHD, d = e % kHD;
    Qs[r * kRowStride + d] =
        (q0 + r < nq) ? to_f32(qp[(long long)r * kHD + d]) : 0.f;
  }

  float m_i[4], l_i[4], o[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = -INFINITY;
    l_i[a] = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) o[a][u] = 0.f;
  }

  for (int panel = 0; panel < 2; ++panel) {
    const int nk = panel == 0 ? no : nt * S;
    const T* kp = panel == 0 ? ko : kg;
    const T* vp = panel == 0 ? vo : vg;
    for (int j0 = 0; j0 < nk; j0 += kBK) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < kBK * kHD; e += kThreads) {
        const int j = e / kHD, d = e % kHD;
        const int jj = j0 + j;
        float kv = 0.f, vv = 0.f;
        if (jj < nk) {
          long long row;
          if (panel == 0) {
            row = bhw * no + jj;
          } else {
            const int t = jj / S, s = jj % S;
            row = ((((long long)b * heads + h) * nt + t) * nwin + w) * S + s;
          }
          kv = to_f32(kp[row * kHD + d]);
          vv = to_f32(vp[row * kHD + d]);
        }
        Ks[j * kRowStride + d] = kv;
        Vs[j * kRowStride + d] = vv;
      }
      if (tid < kBK) {
        const int jj = j0 + tid;
        float bj = -INFINITY;
        if (jj < nk) {
          bj = panel == 0 ? bias_o[(long long)b * no + jj]
                          : bias_g[(long long)bw * nt * S + jj];
        }
        Bs[tid] = bj;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kHD; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qv[a] = *reinterpret_cast<const float4*>(
              &Qs[(tr * 4 + a) * kRowStride + d]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kv[c] = *reinterpret_cast<const float4*>(
              &Ks[(tc + 16 * c) * kRowStride + d]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float acc = s[a][c];
            acc = fmaf(qv[a].x, kv[c].x, acc);
            acc = fmaf(qv[a].y, kv[c].y, acc);
            acc = fmaf(qv[a].z, kv[c].z, acc);
            acc = fmaf(qv[a].w, kv[c].w, acc);
            s[a][c] = acc;
          }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] += Bs[tc + 16 * c];
          mx = fmaxf(mx, s[a][c]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[a], mx);
        const float alpha = __expf(m_i[a] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = __expf(s[a][c] - m_new);
          Ps[(tr * 4 + a) * kPStride + tc + 16 * c] = p;
          rs += p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l_i[a] = l_i[a] * alpha + rs;
        m_i[a] = m_new;
#pragma unroll
        for (int u = 0; u < 8; ++u) o[a][u] *= alpha;
      }
      __syncthreads();

      // keys past the panel's end have p == 0 and zero rows in Vs
#pragma unroll 2
      for (int j = 0; j < kBK; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          pv[a] = *reinterpret_cast<const float4*>(
              &Ps[(tr * 4 + a) * kPStride + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 v0 = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * kRowStride + tc * 4]);
          const float4 v1 = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * kRowStride + 64 + tc * 4]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = jj == 0 ? pv[a].x
                          : jj == 1 ? pv[a].y
                          : jj == 2 ? pv[a].z
                                    : pv[a].w;
            o[a][0] = fmaf(p, v0.x, o[a][0]);
            o[a][1] = fmaf(p, v0.y, o[a][1]);
            o[a][2] = fmaf(p, v0.z, o[a][2]);
            o[a][3] = fmaf(p, v0.w, o[a][3]);
            o[a][4] = fmaf(p, v1.x, o[a][4]);
            o[a][5] = fmaf(p, v1.y, o[a][5]);
            o[a][6] = fmaf(p, v1.z, o[a][6]);
            o[a][7] = fmaf(p, v1.w, o[a][7]);
          }
        }
      }
    }
  }

  const int ld = heads * kHD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + tr * 4 + a;
    if (r >= nq) continue;
    const float inv = 1.f / l_i[a];
    T* op = out + ((long long)bw * nq + r) * ld + h * kHD;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      op[tc * 4 + u] = from_f32<T>(o[a][u] * inv);
      op[64 + tc * 4 + u] = from_f32<T>(o[a][4 + u] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the same flash loop on tensor cores, FlashAttention-2 style.
// 4 warps, each owning 16 of the block's 64 query rows. Products are
// mma.sync m16n8k16 (bf16 in, f32 accumulate) with operands fetched by
// ldmatrix from padded shared-memory tiles. The fragment layouts are fixed
// by the PTX ISA, so the logits, the online-softmax state and the 16x128
// output accumulator all stay in registers: a thread holds rows g and g+8
// (g = lane/4) of each 8-column tile, the logit accumulator doubles as the
// bf16 A operand of P V, and the per-row max reduces over the 4 lanes of a
// quad. P is rounded to bfloat16 for P V, as the JAX kernel rounds p to
// v's dtype; the row sums use the unrounded p.
// ---------------------------------------------------------------------------

constexpr int kMThreads = 128;
constexpr int kLd = kHD + 8;   // bf16 tile rows: 272 B, conflict-free ldmatrix
constexpr int kMSmemBytes = 3 * kBQ * kLd * 2 + kBK * 4;

using bf16 = __nv_bfloat16;

// rows [0, 64) of a (rows, 128) bf16 matrix into shared memory as 16-byte
// chunks; row_of(r) gives the global row of tile row r, or -1 for zeros
template <typename RowFn>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               RowFn row_of) {
  for (int c = threadIdx.x; c < kBQ * (kHD / 8); c += kMThreads) {
    const int r = c / (kHD / 8), cc = c % (kHD / 8);
    const long long row = row_of(r);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row >= 0)
      v = *reinterpret_cast<const uint4*>(src + row * kHD + cc * 8);
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

__global__ void __launch_bounds__(kMThreads)
focal_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ ko,
                           const bf16* __restrict__ vo,
                           const bf16* __restrict__ kg,
                           const bf16* __restrict__ vg,
                           const float* __restrict__ bias_o,
                           const float* __restrict__ bias_g,
                           bf16* __restrict__ out, int heads, int nwin,
                           int nt, int S, int nq, int no) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * kLd;
  bf16* Vs = Ks + kBK * kLd;
  float* Bs = reinterpret_cast<float*>(Vs + kBK * kLd);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;      // fragment row / column pair
  const int lm = lane >> 3, lr = lane & 7;     // ldmatrix matrix / row
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bw = blockIdx.z;                   // b * nwin + w
  const int b = bw / nwin, w = bw % nwin;
  const long long bhw = ((long long)b * heads + h) * nwin + w;

  load_tile_bf16(Qs, q, [&](int r) -> long long {
    return q0 + r < nq ? bhw * nq + q0 + r : -1;
  });
  __syncthreads();
  // the warp's 16 query rows as 8 A fragments (16 x 16 each)
  unsigned qa[kHD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kHD / 16; ++ks)
    ldmatrix_x4(qa[ks], Qs + (warp * 16 + lr + 8 * (lm & 1)) * kLd +
                            ks * 16 + 8 * (lm >> 1));

  float o[kHD / 8][4];
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l_r[2] = {0.f, 0.f};               // this lane's partial row sums

  for (int panel = 0; panel < 2; ++panel) {
    const int nk = panel == 0 ? no : nt * S;
    const bf16* kp = panel == 0 ? ko : kg;
    const bf16* vp = panel == 0 ? vo : vg;
    for (int j0 = 0; j0 < nk; j0 += kBK) {
      __syncthreads();  // the previous tile's readers are done
      auto row_of = [&](int r) -> long long {
        const int jj = j0 + r;
        if (jj >= nk) return -1;
        if (panel == 0) return bhw * no + jj;
        const int t = jj / S, s = jj % S;
        return ((((long long)b * heads + h) * nt + t) * nwin + w) * S + s;
      };
      load_tile_bf16(Ks, kp, row_of);
      load_tile_bf16(Vs, vp, row_of);
      if (tid < kBK) {
        const int jj = j0 + tid;
        float bj = -INFINITY;
        if (jj < nk) {
          bj = panel == 0 ? bias_o[(long long)b * no + jj]
                          : bias_g[(long long)bw * nt * S + jj];
        }
        Bs[tid] = bj;
      }
      __syncthreads();

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

      // O (16 x 128) += P (16 x 64) V: the logit tiles 2kb and 2kb + 1
      // are the A fragment of key block kb
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
  }

  // full row sums over the quad, then write rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const int ld = heads * kHD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= nq) continue;
    const float inv = 1.f / l_r[i];
    bf16* dst = out + ((long long)bw * nq + r) * ld + h * kHD + 2 * tg;
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

template <typename T>
int launch_attention(const void* q, const void* ko, const void* vo,
                     const void* kg, const void* vg, const void* bias_o,
                     const void* bias_g, void* out, int B, int heads,
                     int nwin, int nt, int S, int nq, int no,
                     cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      focal_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || nq == 0) return (int)cudaGetLastError();
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, B * nwin);
  focal_attention_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ko),
      static_cast<const T*>(vo), static_cast<const T*>(kg),
      static_cast<const T*>(vg), static_cast<const float*>(bias_o),
      static_cast<const float*>(bias_g), static_cast<T*>(out), heads, nwin,
      nt, S, nq, no);
  return (int)cudaGetLastError();
}

int launch_attention_mma(const void* q, const void* ko, const void* vo,
                         const void* kg, const void* vg, const void* bias_o,
                         const void* bias_g, void* out, int B, int heads,
                         int nwin, int nt, int S, int nq, int no,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      focal_attention_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || nq == 0) return (int)cudaGetLastError();
  const dim3 grid((nq + kBQ - 1) / kBQ, heads, B * nwin);
  focal_attention_mma_kernel<<<grid, kMThreads, kMSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ko),
      static_cast<const bf16*>(vo), static_cast<const bf16*>(kg),
      static_cast<const bf16*>(vg), static_cast<const float*>(bias_o),
      static_cast<const float*>(bias_g), static_cast<bf16*>(out), heads,
      nwin, nt, S, nq, no);
  return (int)cudaGetLastError();
}

}  // namespace e2fgvi

// Plain C entry point, loaded with ctypes (kernels/build.py). Makes
// `device` current for this library's runtime, launches on `stream` and
// returns cudaGetLastError(); hd must be 128. bfloat16 runs the
// tensor-core kernel, float32 the FMA kernel.
extern "C" int e2fgvi_focal_attention(int dtype, const void* q,
                                      const void* ko, const void* vo,
                                      const void* kg, const void* vg,
                                      const void* bias_o,
                                      const void* bias_g, void* out, int B,
                                      int heads, int nwin, int nt, int S,
                                      int nq, int no, int hd, int device,
                                      void* stream) {
  if (hd != e2fgvi::kHD) return (int)cudaErrorInvalidValue;
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == e2fgvi::kBFloat16) {
    return e2fgvi::launch_attention_mma(q, ko, vo, kg, vg, bias_o, bias_g,
                                        out, B, heads, nwin, nt, S, nq, no,
                                        s);
  }
  return e2fgvi::launch_attention<float>(q, ko, vo, kg, vg, bias_o, bias_g,
                                         out, B, heads, nwin, nt, S, nq, no,
                                         s);
}
