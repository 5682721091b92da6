// Quantized multi-scale deformable attention for serving: int4 and int8
// quantize + gather.
//
// Replaces the TPU kernels of
//   * pairnet_tpu/ops/pallas_deform_attn_v16.py (int4, bf16 serving):
//     _qp16_kernel (via _quantize_pack_int4) -> quantize<bf16, 7>, and
//     _kernel (via _weighted_gather_v16) -> gather<bf16 out, int4 taps>;
//   * pairnet_tpu/ops/pallas_deform_attn_v12.py / _v14.py (int8, levels
//     fused): _qp_kernel (via _quantize_pack_fused) -> quantize<bf16 or f32,
//     127>, and _kernel (via _weighted_gather_v12 / _v14, bit-identical) ->
//     gather<bf16 out, int8 taps>;
//   * pairnet_tpu/ops/pallas_deform_attn_v10.py / _v11.py (int8, one level
//     per call, f32 out, scale folded outside; parity anchors) ->
//     gather<f32 out, int8 taps>, which sums the levels in the kernel.
//
// Quantize: one scale per (b, h, level, d), max(absmax / bound, 1e-20), and
// codes clip(rint(v / scale), -bound, bound) with an IEEE f32 divide and
// round-half-to-even; bound is 7 (int4) or 127 (int8).
//
// Gather: bilinear taps on the codes for all levels in one launch, f32
// accumulation, each level's scale folded in once per (level, d) after that
// level's tap sum. The int4 taps weight the bilinear sum by the attention
// weight (the exact MSDA's order); the int8 taps use the TPU int8 kernels'
// order, the attention weight folded into each corner weight first:
// w00 = (1 - fx) * (1 - fy) * a (pallas_deform_attn_v10.py:76-79).
//
// The TPU kernels pack the 2x2 footprint of a tap (int8) or two channels
// (int4) into one int32 lane; that is a lane trick of the TPU's vector unit.
// Here each code is an int8 in the value layout (B, S, H, D), the scales are
// f32 (B, H, L, D), and every corner is bounds-checked on its own.
//
// Bounds on an H100: bytes for both. quantize reads the value twice (absmax
// pass, then quantize pass; the least traffic counts it once) and writes one
// byte per element. gather reads the codes, locations and weights and writes
// bf16 or f32; it is the exact kernel's design (one thread per output
// (b, q, h, d), d fastest, coalesced code rows) at a quarter of the f32
// value bytes.

#include "msda_common.cuh"

namespace {

// Chunks of `chunk` tokens, numbered level by level: level l owns chunks
// [first[l], first[l + 1]).
struct Chunks {
  int chunk;
  int first[kMaxLevels + 1];
};

template <typename T>
__global__ void absmax_kernel(const T* __restrict__ value, unsigned* __restrict__ amax,
                              int S, int HD, Levels lv, Chunks ck) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= HD) return;
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  int l = 0;
  while (l + 1 < lv.n && y >= ck.first[l + 1]) ++l;
  const long long lo = lv.start[l] + (long long)(y - ck.first[l]) * ck.chunk;
  long long hi = lo + ck.chunk;
  const long long end = lv.start[l] + (long long)lv.h[l] * lv.w[l];
  if (hi > end) hi = end;
  const T* v = value + (long long)b * S * HD + c;
  float m = 0.f;
  for (long long s = lo; s < hi; ++s) m = fmaxf(m, fabsf(to_f32(v[s * HD])));
  // non-negative floats order like their bit patterns
  atomicMax(amax + ((long long)b * lv.n + l) * HD + c, __float_as_uint(m));
}

template <typename T, int kBound>
__global__ void quantize_kernel(const T* __restrict__ value, const unsigned* __restrict__ amax,
                                int8_t* __restrict__ codes, float* __restrict__ scales,
                                int B, int S, int H, int D, Levels lv) {
  const int HD = H * D;
  const long long total = (long long)B * S * HD;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % HD);
    const long long bs = i / HD;
    const long long s = bs % S;
    const int b = (int)(bs / S);
    int l = 0;
    while (l + 1 < lv.n && s >= lv.start[l + 1]) ++l;
    const float am = __uint_as_float(amax[((long long)b * lv.n + l) * HD + c]);
    const float scale = fmaxf(__fdiv_rn(am, (float)kBound), 1e-20f);
    float q = rintf(__fdiv_rn(to_f32(value[i]), scale));
    q = fminf(fmaxf(q, (float)-kBound), (float)kBound);
    codes[i] = (int8_t)q;
    if (s == lv.start[l]) {
      const int h = c / D, d = c % D;
      scales[(((long long)b * H + h) * lv.n + l) * D + d] = scale;
    }
  }
}

// One level's int8 tap sum for one output channel, in the TPU int8 kernels'
// arithmetic: each in-plane corner adds code * ((corner weight) * a).
__device__ __forceinline__ float level_taps_int8(const int8_t* __restrict__ vl, long long row,
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
    const float a = wt[p];
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const bool xa = x0 >= 0, xb = x0 + 1 < wl;
    const bool ya = y0 >= 0, yb = y0 + 1 < hl;
    float s = 0.f;
    if (ya && xa) s += (float)vl[((long long)y0 * wl + x0) * row] * ((1.f - fx) * (1.f - fy) * a);
    if (ya && xb) s += (float)vl[((long long)y0 * wl + x0 + 1) * row] * (fx * (1.f - fy) * a);
    if (yb && xa) s += (float)vl[((long long)(y0 + 1) * wl + x0) * row] * ((1.f - fx) * fy * a);
    if (yb && xb) s += (float)vl[((long long)(y0 + 1) * wl + x0 + 1) * row] * (fx * fy * a);
    acc += s;
  }
  return acc;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename OutT, bool kInt8Taps>
__global__ void gather_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
                              const float* __restrict__ locs, const float* __restrict__ weights,
                              OutT* __restrict__ out, int B, int S, int Q, int H, int D, int P,
                              Levels lv) {
  const long long total = (long long)B * Q * H * D;
  const long long row = (long long)H * D;
  const int L = lv.n;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(i % D);
    const long long bqh = i / D;  // (b * Q + q) * H + h
    const int h = (int)(bqh % H);
    const int b = (int)(bqh / H / Q);
    const float* loc = locs + bqh * L * P * 2;
    const float* wt = weights + bqh * L * P;
    const int8_t* vb = codes + (long long)b * S * row + (long long)h * D + d;
    const float* sc = scales + ((long long)b * H + h) * L * D + d;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int8_t* vl = vb + lv.start[l] * row;
      const float taps = kInt8Taps
          ? level_taps_int8(vl, row, lv.h[l], lv.w[l], loc + l * P * 2, wt + l * P, P)
          : level_taps(vl, row, lv.h[l], lv.w[l], loc + l * P * 2, wt + l * P, P);
      acc += sc[l * D] * taps;
    }
    store(out + i, acc);
  }
}

template <typename T, int kBound>
int quantize(const void* value, void* amax, void* codes, void* scales, int B, int S, int H,
             int D, int L, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int HD = H * D;
  Chunks ck;
  ck.chunk = 64;
  ck.first[0] = 0;
  for (int l = 0; l < L; ++l) {
    const long long n = (long long)lv.h[l] * lv.w[l];
    ck.first[l + 1] = ck.first[l] + (int)((n + ck.chunk - 1) / ck.chunk);
  }
  if (ck.first[L] > 65535 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const int tx = HD < 256 ? HD : 256;
  const dim3 grid((HD + tx - 1) / tx, ck.first[L], B);
  absmax_kernel<T><<<grid, tx, 0, st>>>((const T*)value, (unsigned*)amax, S, HD, lv, ck);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int threads = 256;
  quantize_kernel<T, kBound><<<grid_for((long long)B * S * HD, threads), threads, 0, st>>>(
      (const T*)value, (const unsigned*)amax, (int8_t*)codes, (float*)scales, B, S, H, D, lv);
  return (int)cudaGetLastError();
}

template <typename OutT, bool kInt8Taps>
int gather(const void* codes, const void* scales, const void* locs, const void* weights,
           void* out, int B, int S, int Q, int H, int D, int L, int P, const int* hw,
           void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)B * Q * H * D;
  gather_kernel<OutT, kInt8Taps><<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, (const float*)locs, (const float*)weights,
      (OutT*)out, B, S, Q, H, D, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// value: (B, S, H, D) bf16 or f32; amax: zeroed u32 scratch of B * L * H * D
// entries; codes int8 (B, S, H, D); scales f32 (B, H, L, D).
#define QUANTIZE_ENTRY(name, T, bound)                                                     \
  extern "C" int name(const void* value, void* amax, void* codes, void* scales, int B,    \
                      int S, int H, int D, int L, const int* hw, void* stream) {           \
    return quantize<T, bound>(value, amax, codes, scales, B, S, H, D, L, hw, stream);     \
  }
QUANTIZE_ENTRY(int4_quantize_bf16, __nv_bfloat16, 7)
QUANTIZE_ENTRY(int8_quantize_bf16, __nv_bfloat16, 127)
QUANTIZE_ENTRY(int8_quantize_f32, float, 127)

// codes int8 (B, S, H, D); scales f32 (B, H, L, D); locs f32 (B, Q, H, L, P, 2);
// weights f32 (B, Q, H, L, P); out (B, Q, H * D).
#define GATHER_ENTRY(name, OutT, int8_taps)                                                \
  extern "C" int name(const void* codes, const void* scales, const void* locs,            \
                      const void* weights, void* out, int B, int S, int Q, int H, int D,   \
                      int L, int P, const int* hw, void* stream) {                         \
    return gather<OutT, int8_taps>(codes, scales, locs, weights, out, B, S, Q, H, D, L, P, \
                                   hw, stream);                                            \
  }
GATHER_ENTRY(int4_gather, __nv_bfloat16, false)
GATHER_ENTRY(int8_gather_bf16, __nv_bfloat16, true)
GATHER_ENTRY(int8_gather_f32, float, true)
