// Shared pieces of the multi-scale deformable attention (MSDA) kernels.
//
// Semantics (mmcv MultiScaleDeformableAttention, as in
// pairnet_tpu/ops/deform_attn.py): a sampling location p in [0, 1] maps to
// the pixel coordinate p * size - 0.5 of its level; each of the four
// bilinear corners that lies outside the level's plane counts zero.
//
// The gathers (deform_attn_exact.cu, deform_attn_quant.cu) and the backward
// (deform_attn_bwd.cu) run one warp per query (b, q) over all its heads:
// the geometry of each tap (h, l, p) is computed once, by one lane, into
// shared memory, and a lane owns 8 channels of one head, so a corner is
// one or two vector loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxLevels = 8;
constexpr int kTapWarps = 4;  // warps per block of the warp-per-query kernels

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

// One tap (h, l, p) of a gather, computed once by one lane of the warp and
// read by every lane of head h from shared memory.
struct alignas(16) Tap {
  int4 tok;  // the four corners' tokens in S, clamped into the level's plane
  float4 w;  // corner weights in the order 00, 01, 10, 11, 0 for a corner
             // off the plane; times a with kFoldA
  float a;   // the attention weight
};

// The gather tap at normalized location xy of level l with attention weight
// a. The pixel coordinate xy * size - 0.5 is one fused multiply-add, as in
// the one-thread-per-channel kernels these gathers replaced. A tap with no
// corner in the plane gets weights 0 at token 0.
template <bool kFoldA>
__device__ __forceinline__ Tap make_tap(float2 xy, float a, int l, const Levels& lv) {
  const int hl = lv.h[l], wl = lv.w[l];
  const float x = xy.x * wl - 0.5f;
  const float y = xy.y * hl - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Tap tp;
  tp.a = a;
  tp.tok = make_int4(0, 0, 0, 0);
  tp.w = make_float4(0.f, 0.f, 0.f, 0.f);
  // this test also keeps the int casts in range
  if (x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f && y0f <= (float)(hl - 1)) {
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const bool xa = x0 >= 0, xb = x0 + 1 < wl;
    const bool ya = y0 >= 0, yb = y0 + 1 < hl;
    const int xl = xa ? x0 : 0, xr = xb ? x0 + 1 : wl - 1;
    const int yt = ya ? y0 : 0, ybt = yb ? y0 + 1 : hl - 1;
    const int s0 = (int)lv.start[l];
    tp.tok = make_int4(s0 + yt * wl + xl, s0 + yt * wl + xr, s0 + ybt * wl + xl,
                       s0 + ybt * wl + xr);
    float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
    float w10 = (1.f - fx) * fy, w11 = fx * fy;
    if (kFoldA) {  // the TPU int8 kernels' order: (corner weight) * a
      w00 *= a;
      w01 *= a;
      w10 *= a;
      w11 *= a;
    }
    tp.w = make_float4(ya && xa ? w00 : 0.f, ya && xb ? w01 : 0.f, yb && xa ? w10 : 0.f,
                       yb && xb ? w11 : 0.f);
  }
  return tp;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  u.x = *reinterpret_cast<uint32_t*>(&h[0]);
  u.y = *reinterpret_cast<uint32_t*>(&h[1]);
  u.z = *reinterpret_cast<uint32_t*>(&h[2]);
  u.w = *reinterpret_cast<uint32_t*>(&h[3]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The launch limits of the warp-per-query kernels: D a multiple of 8 up to
// 64, the taps of kTapWarps queries in shared memory, blocks in range.
inline bool tap_kernel_fits(long long B, long long Q, int H, int D, int L, int P,
                            size_t tap_bytes) {
  return H >= 1 && P >= 1 && D >= 8 && D <= 64 && D % 8 == 0 &&
         (long long)kTapWarps * H * L * P * (long long)tap_bytes <= 227 * 1024 &&
         (B * Q + kTapWarps - 1) / kTapWarps <= 0x7fffffffLL;
}
