// e2fgvi_tpu_torch native host-pipeline kernels: the port's own copy of
// the JAX package's native/host_ops.cpp, built and bound by
// e2fgvi_tpu_torch/data/native.py.
//
//  1. dilate_cross: iterated 3x3-cross binary dilation (mask preprocessing,
//     reference core/dataset.py:124-128 semantics). Iterating a cross k
//     times equals a diamond of radius k (an L1 distance threshold),
//     computed here in two passes over a distance accumulator instead of k
//     full passes.
//
//  2. composite_blend: fused per-frame compositing
//     out = pred * mask + orig * (1 - mask), optionally 50/50-blended with
//     a previous composite (reference test.py:168-179): one pass, no
//     intermediate allocations.
//
// Exposed with a plain C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <limits>
#include <vector>

extern "C" {

// Iterated 3x3-cross dilation == L1 (Manhattan) distance threshold:
// out(p) = 1 iff min_{q: m(q)=1} |p-q|_1 <= iters.
// Two-pass chamfer distance transform, O(H*W) independent of iters.
void dilate_cross(const uint8_t* mask, uint8_t* out, int h, int w,
                  int iters) {
    const int32_t INF = std::numeric_limits<int32_t>::max() / 4;
    std::vector<int32_t> d(static_cast<size_t>(h) * w);
    // forward pass
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            size_t i = static_cast<size_t>(y) * w + x;
            int32_t v = mask[i] ? 0 : INF;
            if (y > 0) v = std::min(v, d[i - w] + 1);
            if (x > 0) v = std::min(v, d[i - 1] + 1);
            d[i] = v;
        }
    }
    // backward pass
    for (int y = h - 1; y >= 0; --y) {
        for (int x = w - 1; x >= 0; --x) {
            size_t i = static_cast<size_t>(y) * w + x;
            int32_t v = d[i];
            if (y + 1 < h) v = std::min(v, d[i + w] + 1);
            if (x + 1 < w) v = std::min(v, d[i + 1] + 1);
            d[i] = v;
            out[i] = (v <= iters) ? 1 : 0;
        }
    }
}

// pred: float32 (h, w, 3) in [0, 255]; orig: uint8 (h, w, 3);
// mask: uint8 (h, w) in {0,1}; prev: float32 (h, w, 3) or null;
// out: float32 (h, w, 3).
// Matches the reference compositing exactly, including the uint8 cast of
// the prediction before mixing (test.py:170-179).
void composite_blend(const float* pred, const uint8_t* orig,
                     const uint8_t* mask, const float* prev, float* out,
                     int h, int w) {
    const size_t n = static_cast<size_t>(h) * w;
    for (size_t i = 0; i < n; ++i) {
        const uint8_t m = mask[i];
        for (int c = 0; c < 3; ++c) {
            const size_t j = i * 3 + c;
            float p = pred[j];
            // reference casts pred to uint8 (truncation after clamp)
            float pu = static_cast<float>(static_cast<uint8_t>(
                p < 0.f ? 0.f : (p > 255.f ? 255.f : p)));
            float img = m ? pu : static_cast<float>(orig[j]);
            out[j] = prev ? 0.5f * prev[j] + 0.5f * img : img;
        }
    }
}

}  // extern "C"
