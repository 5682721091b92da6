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
// byte per element. gather reads the codes, locations and weights once
// (least traffic; its corner reads, 32-byte sectors of a head's codes, come
// mostly from L2, which holds the codes) and writes bf16 or f32.
//
// Gather design: one warp per (b, q), covering every head. The tap geometry
// (coordinates, the four corners' tokens, in-plane tests, corner weights)
// is computed once per (h, l, p) by one lane and shared through shared
// memory, instead of once per output channel. Lane i owns 8 consecutive
// channels of one head (at H = 8, D = 32: head i / 4): each corner is one
// 8-byte load of 8 codes (a head's 32 channels are one 32-byte sector), the
// output one 16-byte (bf16) store. A level's taps are unrolled by 4, so its
// 16 corner loads are in flight before any is used. Codes become f32
// exactly by a byte permute into the mantissa of 2^23 and one subtract.
// Attention weights are read in their own dtype (bf16 on the serving path).
// Per channel, the arithmetic and its order are those of the one-thread-
// per-channel design it replaces (corner order, tap order, scale per level).
//
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

// Code k (0..3) of a word of four int8 codes, as an exact f32: the byte
// xor 0x80 (= code + 128) becomes the low mantissa bits of 2^23.
__device__ __forceinline__ float code_f32(uint32_t biased, int k) {
  return __int_as_float((int)__byte_perm(biased, 0x4Bu, 0x4550u | k)) - 8388736.f;
}

// One warp per (b, q), covering all H heads. Lane i owns the 8-channel
// groups i, i + 32, ... of the query's H * D channels.
template <typename OutT, typename WT, bool kInt8Taps>
__global__ void __launch_bounds__(kTapWarps * 32)
gather_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
              const float* __restrict__ locs, const WT* __restrict__ weights,
              OutT* __restrict__ out, int B, int S, int Q, int H, int D, int P, Levels lv) {
  extern __shared__ Tap taps_all[];
  const int L = lv.n;
  const int HLP = H * L * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bq = (long long)blockIdx.x * kTapWarps + warp;
  if (bq >= (long long)B * Q) return;  // the whole warp; no block barrier follows
  const int b = (int)(bq / Q);
  Tap* taps = taps_all + warp * HLP;

  // the geometry of each tap once, the lanes taking taps lane, lane + 32, ...
  const float2* loc = reinterpret_cast<const float2*>(locs) + bq * HLP;
  const WT* wt = weights + bq * HLP;
  for (int i = lane; i < HLP; i += 32)
    taps[i] = make_tap<kInt8Taps>(loc[i], to_f32(wt[i]), (i / P) % L, lv);
  __syncwarp();

  const int G = D / 8;  // 8-channel groups per head
  const long long row = (long long)H * D;
  for (int gi = lane; gi < H * G; gi += 32) {
    const int h = gi / G, c8 = (gi % G) * 8;
    const int8_t* cb = codes + (long long)b * S * row + (long long)h * D + c8;
    const float* sc = scales + ((long long)b * H + h) * L * D + c8;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int l = 0; l < L; ++l) {
      const Tap* tl = taps + (h * L + l) * P;
      float lt[8];  // the level's tap sum
#pragma unroll
      for (int c = 0; c < 8; ++c) lt[c] = 0.f;
      for (int p0 = 0; p0 < P; p0 += 4) {
        // the corner loads of up to 4 taps, issued before any is used
        uint2 raw[4][4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (p0 + pp < P) {
            const int4 tk = tl[p0 + pp].tok;
            raw[pp][0] = __ldg(reinterpret_cast<const uint2*>(cb + tk.x * row));
            raw[pp][1] = __ldg(reinterpret_cast<const uint2*>(cb + tk.y * row));
            raw[pp][2] = __ldg(reinterpret_cast<const uint2*>(cb + tk.z * row));
            raw[pp][3] = __ldg(reinterpret_cast<const uint2*>(cb + tk.w * row));
          }
        }
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          if (p0 + pp >= P) continue;
          const float4 w4 = tl[p0 + pp].w;
          const float cw[4] = {w4.x, w4.y, w4.z, w4.w};
          float s[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) s[c] = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // corners in order 00, 01, 10, 11
            const uint32_t lo = raw[pp][k].x ^ 0x80808080u, hi = raw[pp][k].y ^ 0x80808080u;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              s[c] = fmaf(cw[k], code_f32(c < 4 ? lo : hi, c & 3), s[c]);
          }
          if (kInt8Taps) {
#pragma unroll
            for (int c = 0; c < 8; ++c) lt[c] += s[c];
          } else {
            const float a = tl[p0 + pp].a;
#pragma unroll
            for (int c = 0; c < 8; ++c) lt[c] = fmaf(a, s[c], lt[c]);
          }
        }
      }
      const float4 sa = *reinterpret_cast<const float4*>(sc + l * D);
      const float4 sb = *reinterpret_cast<const float4*>(sc + l * D + 4);
      const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(sv[c], lt[c], acc[c]);
    }
    store8(out + bq * row + (long long)h * D + c8, acc);
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

template <typename OutT, typename WT, bool kInt8Taps>
int gather_w(const void* codes, const void* scales, const void* locs, const void* weights,
             void* out, int B, int S, int Q, int H, int D, int P, const Levels& lv,
             cudaStream_t st) {
  const size_t smem = (size_t)kTapWarps * H * lv.n * P * sizeof(Tap);
  auto kern = gather_kernel<OutT, WT, kInt8Taps>;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const long long blocks = ((long long)B * Q + kTapWarps - 1) / kTapWarps;
  kern<<<(unsigned)blocks, kTapWarps * 32, smem, st>>>(
      (const int8_t*)codes, (const float*)scales, (const float*)locs, (const WT*)weights,
      (OutT*)out, B, S, Q, H, D, P, lv);
  return (int)cudaGetLastError();
}

template <typename OutT, bool kInt8Taps>
int gather(const void* codes, const void* scales, const void* locs, const void* weights,
           void* out, int B, int S, int Q, int H, int D, int L, int P, int weights_bf16,
           const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv)) return (int)cudaErrorInvalidValue;
  if (!tap_kernel_fits(B, Q, H, D, L, P, sizeof(Tap)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return weights_bf16
             ? gather_w<OutT, __nv_bfloat16, kInt8Taps>(codes, scales, locs, weights, out, B, S,
                                                        Q, H, D, P, lv, st)
             : gather_w<OutT, float, kInt8Taps>(codes, scales, locs, weights, out, B, S, Q, H,
                                                D, P, lv, st);
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
// weights (B, Q, H, L, P), bf16 if weights_bf16 else f32; out (B, Q, H * D).
// D a multiple of 8 up to 64; every pointer aligned to its vector loads.
#define GATHER_ENTRY(name, OutT, int8_taps)                                                \
  extern "C" int name(const void* codes, const void* scales, const void* locs,            \
                      const void* weights, void* out, int B, int S, int Q, int H, int D,   \
                      int L, int P, int weights_bf16, const int* hw, void* stream) {       \
    return gather<OutT, int8_taps>(codes, scales, locs, weights, out, B, S, Q, H, D, L, P, \
                                   weights_bf16, hw, stream);                              \
  }
GATHER_ENTRY(int4_gather, __nv_bfloat16, false)
GATHER_ENTRY(int8_gather_bf16, __nv_bfloat16, true)
GATHER_ENTRY(int8_gather_f32, float, true)
