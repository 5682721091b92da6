// Multi-scale deformable attention backward: dvalue, dlocs, dweights.
//
// Replaces the TPU kernels
//   pairnet_tpu/ops/pallas_deform_attn_v6.py::_bwd_kernel   (parity anchor)
//   pairnet_tpu/ops/pallas_deform_bwd2.py::_bwd2_kernel     (default VJP)
//   pairnet_tpu/ops/pallas_deform_bwd3.py::_bwd3_kernel     (bf16 upstream grad)
// which compute one function; here they are three instances of one template:
//   deform_attn_bwd_f32        f32 values            (rows 5/6, f32 training)
//   deform_attn_bwd_bf16       bf16 values           (row 6, bf16 training)
//   deform_attn_bwd_bf16_grad  bf16 values, bwd3's roundings (row 7): the
//     upstream grad rounded to bf16 for every use, and each per-tap product
//     bf16(g_bf16 * cw * a) rounded before it is summed into dvalue.
//
// Semantics (mmcv MultiScaleDeformableAttention backward): pixel coordinate
// p * size - 0.5; a corner outside the level's plane passes no gradient,
// neither to dvalue nor through its bilinear weight to dlocs. dlocs is the
// gradient with respect to the normalized location (x part times w, y part
// times h). Outputs are cast to the input dtypes by the caller's buffers:
// dvalue to the value's (via an f32 scratch), dlocs and dweights in f32.
//
// Layout: value (B, S, H, D), locs (B, Q, H, L, P, 2) f32, weights
// (B, Q, H, L, P) f32, g (B, Q, H * D) f32; dvalue (B, S, H, D) f32 scratch
// (+ bf16 copy for bf16 values), dlocs and dweights in the locs/weights
// layouts, f32.
//
// Design: one group of `width` lanes (a power of two, >= D up to 32) per tap
// (b, q, h, level, point), lane = channel, looping over D in steps of width.
// Each lane reads its channel of the 4 corner rows of value and of g, adds
// g * a * cw into the f32 dvalue scratch with atomicAdd (no bf16 atomics:
// the scratch is cast once at the end), and keeps partial sums of g * v
// weighted by cw, dcw/dfx and dcw/dfy; a shuffle reduction over the group
// gives dweights and dlocs. Taps are in the weights' order, so consecutive
// groups share one (b, q, h) row of g.
//
// Bound on an H100: by the byte count (inputs read once, outputs written
// once) the least time is a fraction of a millisecond at the training
// shapes; what sets the pace of this first design is the 4 * D scattered
// f32 atomics per tap (~1.1e9 per call at batch 4, 800x1344), not bytes.

#include "msda_common.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kBf16Grad>
__global__ void bwd_kernel(const T* __restrict__ value, const float* __restrict__ locs,
                           const float* __restrict__ weights, const float* __restrict__ g,
                           float* __restrict__ dvalue, float* __restrict__ dlocs,
                           float* __restrict__ dweights, int B, int S, int Q, int H, int D,
                           int P, Levels lv, int width) {
  const int L = lv.n;
  const long long taps = (long long)B * Q * H * L * P;
  const long long row = (long long)H * D;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (width - 1);
  const int per_warp = 32 / width;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // t0 is uniform over the warp, so every lane reaches the shuffles below
  for (long long t0 = warp * per_warp; t0 < taps; t0 += n_warps * per_warp) {
    const long long t = t0 + lane / width;
    float pa = 0.f, px = 0.f, py = 0.f, aw = 0.f;
    int wl = 0, hl = 0;
    if (t < taps) {
      const int l = (int)((t / P) % L);
      const long long bqh = t / ((long long)P * L);  // (b * Q + q) * H + h
      const int h = (int)(bqh % H);
      const int b = (int)(bqh / H / Q);
      hl = lv.h[l];
      wl = lv.w[l];
      aw = weights[t];
      const float x = __fmul_rn(locs[2 * t], (float)wl) - 0.5f;
      const float y = __fmul_rn(locs[2 * t + 1], (float)hl) - 0.5f;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      // some corner inside the plane; this also keeps the int casts in range
      if (x0f >= -1.f && x0f <= (float)(wl - 1) && y0f >= -1.f && y0f <= (float)(hl - 1)) {
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const bool in_x[2] = {x0 >= 0, x0 + 1 < wl};
        const bool in_y[2] = {y0 >= 0, y0 + 1 < hl};
        // corner c = 2 * dy + dx: bilinear weight and its d/dfx, d/dfy
        const float cw[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy), (1.f - fx) * fy, fx * fy};
        const float cdx[4] = {-(1.f - fy), 1.f - fy, -fy, fy};
        const float cdy[4] = {-(1.f - fx), -fx, 1.f - fx, fx};
        long long tok[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tok[c] = lv.start[l] + (long long)(y0 + (c >> 1)) * wl + x0 + (c & 1);
        const T* vb = value + (long long)b * S * row + (long long)h * D;
        float* dvb = dvalue + (long long)b * S * row + (long long)h * D;
        const float* gq = g + bqh * D;
        for (int d = sub; d < D; d += width) {
          float gd = gq[d];
          if (kBf16Grad) gd = round_bf16(gd);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (!(in_x[c & 1] && in_y[c >> 1])) continue;
            const float gv = __fmul_rn(gd, to_f32(vb[tok[c] * row + d]));
            pa += cw[c] * gv;
            px += cdx[c] * gv;
            py += cdy[c] * gv;
            float prod = __fmul_rn(gd, __fmul_rn(cw[c], aw));
            if (kBf16Grad) prod = round_bf16(prod);
            atomicAdd(dvb + tok[c] * row + d, prod);
          }
        }
      }
    }
    for (int off = width >> 1; off > 0; off >>= 1) {
      pa += __shfl_xor_sync(0xffffffffu, pa, off);
      px += __shfl_xor_sync(0xffffffffu, px, off);
      py += __shfl_xor_sync(0xffffffffu, py, off);
    }
    if (t < taps && sub == 0) {
      dweights[t] = pa;
      dlocs[2 * t] = px * aw * (float)wl;
      dlocs[2 * t + 1] = py * aw * (float)hl;
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// dvalue_f32: zeroed here, then accumulated; for bf16 values it is cast into
// dvalue_out, for f32 values the caller passes dvalue_out == dvalue_f32.
template <typename T, bool kBf16Grad>
int launch(const void* value, const void* locs, const void* weights, const void* g,
           void* dvalue_f32, void* dvalue_out, void* dlocs, void* dweights, int B, int S, int Q,
           int H, int D, int L, int P, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv) || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_value = (long long)B * S * H * D;
  cudaError_t err = cudaMemsetAsync(dvalue_f32, 0, n_value * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  int width = 1;
  while (width < D && width < 32) width <<= 1;
  const int threads = 256;
  const long long taps = (long long)B * Q * H * L * P;
  bwd_kernel<T, kBf16Grad><<<grid_for(taps * width, threads), threads, 0, st>>>(
      (const T*)value, (const float*)locs, (const float*)weights, (const float*)g,
      (float*)dvalue_f32, (float*)dlocs, (float*)dweights, B, S, Q, H, D, P, lv, width);
  err = cudaGetLastError();
  if (err != cudaSuccess || dvalue_out == dvalue_f32) return (int)err;
  cast_bf16_kernel<<<grid_for(n_value, threads), threads, 0, st>>>(
      (const float*)dvalue_f32, (__nv_bfloat16*)dvalue_out, n_value);
  return (int)cudaGetLastError();
}

}  // namespace

#define BWD_ARGS                                                                           \
  const void *value, const void *locs, const void *weights, const void *g, void *dvalue_f32, \
      void *dvalue_out, void *dlocs, void *dweights, int B, int S, int Q, int H, int D,     \
      int L, int P, const int *hw, void *stream
#define BWD_PASS \
  value, locs, weights, g, dvalue_f32, dvalue_out, dlocs, dweights, B, S, Q, H, D, L, P, hw, stream

extern "C" int deform_attn_bwd_f32(BWD_ARGS) { return launch<float, false>(BWD_PASS); }

extern "C" int deform_attn_bwd_bf16(BWD_ARGS) { return launch<__nv_bfloat16, false>(BWD_PASS); }

extern "C" int deform_attn_bwd_bf16_grad(BWD_ARGS) {
  return launch<__nv_bfloat16, true>(BWD_PASS);
}
