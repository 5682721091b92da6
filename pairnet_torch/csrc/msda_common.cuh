// Shared pieces of the multi-scale deformable attention (MSDA) kernels.
//
// Semantics (mmcv MultiScaleDeformableAttention, as in
// pairnet_tpu/ops/deform_attn.py): a sampling location p in [0, 1] maps to
// the pixel coordinate p * size - 0.5 of its level; each of the four
// bilinear corners that lies outside the level's plane counts zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxLevels = 8;

// Level geometry, passed to the kernels by value.
struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];  // first token of each level in S
};

// hw: host array of n (h, w) pairs. Returns false for an unsupported n.
inline bool make_levels(const int* hw, int n, Levels* lv) {
  if (n < 1 || n > kMaxLevels) return false;
  lv->n = n;
  long long s = 0;
  for (int l = 0; l < n; ++l) {
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
    lv->start[l] = s;
    s += (long long)lv->h[l] * lv->w[l];
  }
  return true;
}

inline unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 22)) blocks = 1LL << 22;  // the kernels stride over the rest
  return (unsigned)(blocks > 0 ? blocks : 1);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// One level's contribution to one output channel:
//   sum_p wt[p] * bilinear(vl, loc[p])
// vl points at channel (h, d) of the level's first token; consecutive tokens
// are `row` elements apart. loc holds P (x, y) pairs, wt P weights.
template <typename T>
__device__ __forceinline__ float level_taps(const T* __restrict__ vl, long long row,
                                            int hl, int wl,
                                            const float* __restrict__ loc,
                                            const float* __restrict__ wt, int P) {
  float acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const float x = loc[2 * p] * wl - 0.5f;
    const float y = loc[2 * p + 1] * hl - 0.5f;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    // no corner inside the plane; this also keeps the int casts in range
    if (!(x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f && y0f <= (float)(hl - 1)))
      continue;
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const bool xa = x0 >= 0, xb = x0 + 1 < wl;
    const bool ya = y0 >= 0, yb = y0 + 1 < hl;
    float s = 0.f;
    if (ya && xa) s += (1.f - fx) * (1.f - fy) * to_f32(vl[((long long)y0 * wl + x0) * row]);
    if (ya && xb) s += fx * (1.f - fy) * to_f32(vl[((long long)y0 * wl + x0 + 1) * row]);
    if (yb && xa) s += (1.f - fx) * fy * to_f32(vl[((long long)(y0 + 1) * wl + x0) * row]);
    if (yb && xb) s += fx * fy * to_f32(vl[((long long)(y0 + 1) * wl + x0 + 1) * row]);
    acc += wt[p] * s;
  }
  return acc;
}
