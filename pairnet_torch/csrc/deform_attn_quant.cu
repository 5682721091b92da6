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
// Quantize design: two launches over the same tiles of kTileRows tokens of
// one (image, level), which a block finds from blockIdx once (the level from
// a per-level table of first tiles): no per-element index arithmetic, level
// search or 64-bit division. A thread owns 8 consecutive channels (one
// 16-byte load of bf16, two of f32) of a token row, all of one head (D is a
// multiple of 8), HD / 8 threads a row, and keeps kRowsInFlight rows' loads
// in flight before using any.
//   1. absmax: per-channel maxima of the tile in registers, then over the
//      block's rows in shared memory, one atomicMax per channel into a
//      workspace, and an arrival count per (b, level). The last block of a
//      (b, level) to arrive turns the maxima into the scales, writes them,
//      and resets its workspace slots and count to zero (atomicExch), so the
//      wrapper's workspace, zeroed once when allocated, needs no fill per call.
//   2. quantize: the thread's 8 scales read once (two 16-byte loads), 8 IEEE
//      divides per row, 8 codes packed into one 8-byte store.
// A max is exact and independent of order, so codes and scales are bit-equal
// to the plain version. fmaxf drops a NaN from the max, where the plain
// version's amax propagates it; a NaN value's code is -bound.
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

// Quantize: tiles of kTileRows tokens, numbered level by level: level l
// owns tiles [first[l], first[l + 1]) of each image, the last one partial.
struct Tiles {
  int first[kMaxLevels + 1];
};

constexpr int kTileRows = 256;
constexpr int kQuantThreads = 256;
constexpr int kRowsInFlight = 4;  // a thread's rows loaded before any is used

// The tile of a quantize block: blockIdx.x counts tiles, blockIdx.y images.
struct TileRows {
  int l;         // level
  int row0;      // first token of the tile within its level
  int rows;      // tokens in the tile
  long long s0;  // first token of the tile in (b, S)
};

__device__ __forceinline__ TileRows tile_rows(const Levels& lv, const Tiles& tl, int S) {
  TileRows t;
  t.l = 0;
  while (t.l + 1 < lv.n && (int)blockIdx.x >= tl.first[t.l + 1]) ++t.l;
  const int n = lv.h[t.l] * lv.w[t.l];
  t.row0 = ((int)blockIdx.x - tl.first[t.l]) * kTileRows;
  t.rows = min(kTileRows, n - t.row0);
  t.s0 = (long long)blockIdx.y * S + lv.start[t.l] + t.row0;
  return t;
}

// Eight consecutive channels of a token row as loaded: one 16-byte load of
// bf16, two of f32; x[c] is channel c as an f32.
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float operator[](int c) const {
    const uint32_t w = c < 2 ? u.x : c < 4 ? u.y : c < 6 ? u.z : u.w;
    return __uint_as_float(c & 1 ? w & 0xffff0000u : w << 16);
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float operator[](int c) const {
    const float4& h = c < 4 ? a : b;
    const int k = c & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

// Pass 1: the tile's per-channel absmax (in registers over a thread's rows,
// then over the block's rows in shared memory), one atomicMax per channel
// into amax[b, l, :], then an arrival count per (b, l). The last block of a
// (b, l) to arrive writes its scales and leaves its amax slots and its count
// at zero for the next call. tpr threads share a token row, each owning the
// 8-channel groups g, g + tpr, ...; blockDim.x = rows_per_pass * tpr.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
absmax_kernel(const T* __restrict__ value, unsigned* __restrict__ amax,
              unsigned* __restrict__ arrivals, float* __restrict__ scales, int S, int H, int D,
              Levels lv, Tiles tl, int tpr, float bound) {
  extern __shared__ float red[];  // rows_per_pass x HD
  __shared__ bool last;
  const int HD = H * D, G = HD / 8;
  const int R = blockDim.x / tpr;
  const int r = threadIdx.x / tpr, gi = threadIdx.x - r * tpr;
  const TileRows t = tile_rows(lv, tl, S);
  const T* base = value + t.s0 * HD;
  for (int g = gi; g < G; g += tpr) {
    float m[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) m[c] = 0.f;
    for (int i = r; i < t.rows; i += kRowsInFlight * R) {
      Row8<T> x[kRowsInFlight];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (i + k * R < t.rows) x[k].load(base + (long long)(i + k * R) * HD + g * 8);
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (i + k * R < t.rows) {
#pragma unroll
          for (int c = 0; c < 8; ++c) m[c] = fmaxf(m[c], fabsf(x[k][c]));
        }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) red[r * HD + g * 8 + c] = m[c];
  }
  __syncthreads();
  unsigned* am = amax + ((long long)blockIdx.y * lv.n + t.l) * HD;
  for (int c = threadIdx.x; c < HD; c += blockDim.x) {
    float m = red[c];
    for (int rr = 1; rr < R; ++rr) m = fmaxf(m, red[rr * HD + c]);
    // non-negative floats order like their bit patterns
    atomicMax(am + c, __float_as_uint(m));
  }
  __threadfence();
  __syncthreads();
  unsigned* arrived = arrivals + blockIdx.y * lv.n + t.l;
  if (threadIdx.x == 0)
    last = atomicAdd(arrived, 1u) == (unsigned)(tl.first[t.l + 1] - tl.first[t.l] - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < HD; c += blockDim.x) {
    const float m = __uint_as_float(atomicExch(am + c, 0u));  // read, and reset
    const int h = c / D, d = c - h * D;
    scales[(((long long)blockIdx.y * H + h) * lv.n + t.l) * D + d] =
        fmaxf(__fdiv_rn(m, bound), 1e-20f);
  }
  if (threadIdx.x == 0) *arrived = 0u;
}

// Pass 2: codes of the tile, 8 channels a thread with their 8 scales in
// registers, the rows in flight loaded before any is used, 8 codes a store.
template <typename T, int kBound>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const T* __restrict__ value, const float* __restrict__ scales,
                int8_t* __restrict__ codes, int S, int H, int D, Levels lv, Tiles tl, int tpr) {
  const int HD = H * D, G = HD / 8;
  const int R = blockDim.x / tpr;
  const int r = threadIdx.x / tpr, gi = threadIdx.x - r * tpr;
  const TileRows t = tile_rows(lv, tl, S);
  const T* base = value + t.s0 * HD;
  int8_t* out = codes + t.s0 * HD;
  for (int g = gi; g < G; g += tpr) {
    // the group's 8 channels lie in one head, so its scales are contiguous
    const int h = g * 8 / D, d = g * 8 - h * D;
    const float4* sp = reinterpret_cast<const float4*>(
        scales + (((long long)blockIdx.y * H + h) * lv.n + t.l) * D + d);
    const float4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    // the rows in the reverse of pass 1's order: those it read last are
    // the likeliest to be still in L2
    const int step = kRowsInFlight * R;
    const int last = t.rows > r ? r + (t.rows - 1 - r) / step * step : -1;
    for (int i = last; i >= r; i -= step) {
      Row8<T> x[kRowsInFlight];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (i + k * R < t.rows) x[k].load(base + (long long)(i + k * R) * HD + g * 8);
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        if (i + k * R >= t.rows) continue;
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float q = rintf(__fdiv_rn(x[k][c], sc[c]));
          q = fminf(fmaxf(q, (float)-kBound), (float)kBound);
          word[c >> 2] |= ((uint32_t)(int)q & 0xffu) << (8 * (c & 3));
        }
        *reinterpret_cast<uint2*>(out + (long long)(i + k * R) * HD + g * 8) =
            make_uint2(word[0], word[1]);
      }
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
int quantize(const void* value, void* workspace, void* codes, void* scales, int B, int S, int H,
             int D, int L, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv)) return (int)cudaErrorInvalidValue;
  const int HD = H * D;
  if (H < 1 || D < 1 || D % 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Tiles tl;
  tl.first[0] = 0;
  for (int l = 0; l < L; ++l) {
    const long long n = (long long)lv.h[l] * lv.w[l];
    if (n < 1) return (int)cudaErrorInvalidValue;
    tl.first[l + 1] = tl.first[l] + (int)((n + kTileRows - 1) / kTileRows);
  }
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const int G = HD / 8;
  const int tpr = G < kQuantThreads ? G : kQuantThreads;  // threads per token row
  const int rows_per_pass = kQuantThreads / tpr;
  const int threads = rows_per_pass * tpr;
  const size_t smem = (size_t)rows_per_pass * HD * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(tl.first[L], B);
  unsigned* amax = (unsigned*)workspace;  // B * L * HD slots, then B * L arrival counts
  absmax_kernel<T><<<grid, threads, smem, st>>>((const T*)value, amax,
                                                amax + (long long)B * L * HD, (float*)scales,
                                                S, H, D, lv, tl, tpr, (float)kBound);
  int err = (int)cudaGetLastError();
  if (err) return err;
  quantize_kernel<T, kBound><<<grid, threads, 0, st>>>(
      (const T*)value, (const float*)scales, (int8_t*)codes, S, H, D, lv, tl, tpr);
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

// value: (B, S, H, D) bf16 or f32, D a multiple of 8; workspace: u32,
// B * L * (H * D + 1) entries, zero before the call and left zero after it
// (one per device and stream: calls that share one must not overlap); codes
// int8 (B, S, H, D); scales f32 (B, H, L, D). Every pointer 16-byte aligned.
#define QUANTIZE_ENTRY(name, T, bound)                                                       \
  extern "C" int name(const void* value, void* workspace, void* codes, void* scales, int B, \
                      int S, int H, int D, int L, const int* hw, void* stream) {             \
    return quantize<T, bound>(value, workspace, codes, scales, B, S, H, D, L, hw, stream);  \
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
