// Exact multi-scale deformable attention forward.
//
// Replaces the TPU kernels pairnet_tpu/ops/pallas_deform_attn_v6.py::_kernel
// (f32 values) and pairnet_tpu/ops/pallas_deform_attn_v7.py::_kernel (bf16
// values): the same function, one template over the value type, with f32
// locations, weights, accumulation and output.
//
// Layout: value (B, S, H, D), locs (B, Q, H, L, P, 2), weights
// (B, Q, H, L, P), out (B, Q, H * D) f32. D a multiple of 8 up to 64.
//
// Design: the warp-per-query design of the quantized gather
// (deform_attn_quant.cu). One warp per (b, q) covers every head; the
// geometry of each tap (h, l, p) -- corner tokens clamped into the plane,
// corner weights 0 off the plane -- is computed once by one lane into
// shared memory (make_tap, msda_common.cuh), not once per output channel.
// Lane i owns 8 consecutive channels of one head (at H = 8, D = 32: head
// i / 4): a corner is one 16-byte load (bf16) or two (f32), a level's taps
// go 4 at a time (2 for f32 values) with all their corner loads issued
// before any is used, and the output is two 16-byte stores. Per channel the
// arithmetic and its order are those of the one-thread-per-channel kernel
// this replaces: corners 00, 01, 10, 11 summed as s = fma(cw, v, s), then
// acc_l = fma(a, s, acc_l) in point order, levels added in order. An
// off-plane corner adds 0 * v at a clamped token, where that kernel skipped
// it, which leaves every sum unchanged.
//
// Bound on an H100: bytes. The function reads the value plane, locations
// and weights once and writes the f32 output; ~10 operations per tap and
// channel against them is far below the card's operations-per-byte ridge.
// What it moves beyond that is one request per head and in-plane corner
// (the head's D channels of a value row, 64 bytes in bf16 at D = 32),
// served mostly by L2, which holds the value plane; those B * Q * H * L * P
// * 4 requests, more than their bytes, set its pace.

#include "msda_common.cuh"

namespace {

// 8 consecutive channels of a row as loaded: one 16-byte word (bf16) or two (f32).
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Raw8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Raw8<float> load8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32's
__device__ __forceinline__ void unpack8(const Raw8<__nv_bfloat16>& r, float (&v)[8]) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.lo.x, v[1] = r.lo.y, v[2] = r.lo.z, v[3] = r.lo.w;
  v[4] = r.hi.x, v[5] = r.hi.y, v[6] = r.hi.z, v[7] = r.hi.w;
}

template <typename T>
__global__ void __launch_bounds__(kTapWarps * 32)
exact_kernel(const T* __restrict__ value, const float* __restrict__ locs,
             const float* __restrict__ weights, float* __restrict__ out, int B, int S, int Q,
             int H, int D, int P, Levels lv) {
  constexpr int kInFlight = sizeof(T) == 2 ? 4 : 2;  // taps whose loads are in flight
  extern __shared__ Tap taps_all[];
  const int L = lv.n;
  const int HLP = H * L * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bq = (long long)blockIdx.x * kTapWarps + warp;
  if (bq >= (long long)B * Q) return;  // the whole warp; no block barrier follows
  const int b = (int)(bq / Q);
  Tap* taps = taps_all + warp * HLP;

  const float2* loc = reinterpret_cast<const float2*>(locs) + bq * HLP;
  const float* wt = weights + bq * HLP;
  for (int i = lane; i < HLP; i += 32) taps[i] = make_tap<false>(loc[i], wt[i], (i / P) % L, lv);
  __syncwarp();

  const int G = D / 8;  // 8-channel groups per head
  const long long row = (long long)H * D;
  for (int gi = lane; gi < H * G; gi += 32) {
    const int h = gi / G, c8 = (gi % G) * 8;
    const T* vb = value + (long long)b * S * row + (long long)h * D + c8;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int l = 0; l < L; ++l) {
      const Tap* tl = taps + (h * L + l) * P;
      float lt[8];  // the level's sum
#pragma unroll
      for (int c = 0; c < 8; ++c) lt[c] = 0.f;
      for (int p0 = 0; p0 < P; p0 += kInFlight) {
        Raw8<T> raw[kInFlight][4];
#pragma unroll
        for (int pp = 0; pp < kInFlight; ++pp) {
          if (p0 + pp < P) {
            const int4 tk = tl[p0 + pp].tok;
            raw[pp][0] = load8(vb + tk.x * row);
            raw[pp][1] = load8(vb + tk.y * row);
            raw[pp][2] = load8(vb + tk.z * row);
            raw[pp][3] = load8(vb + tk.w * row);
          }
        }
#pragma unroll
        for (int pp = 0; pp < kInFlight; ++pp) {
          if (p0 + pp >= P) continue;
          const float4 w4 = tl[p0 + pp].w;
          const float cw[4] = {w4.x, w4.y, w4.z, w4.w};
          float s[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) s[c] = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // corners in order 00, 01, 10, 11
            float v[8];
            unpack8(raw[pp][k], v);
#pragma unroll
            for (int c = 0; c < 8; ++c) s[c] = fmaf(cw[k], v[c], s[c]);
          }
          const float a = tl[p0 + pp].a;
#pragma unroll
          for (int c = 0; c < 8; ++c) lt[c] = fmaf(a, s[c], lt[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] += lt[c];
    }
    store8(out + bq * row + (long long)h * D + c8, acc);
  }
}

template <typename T>
int launch(const void* value, const void* locs, const void* weights, void* out, int B,
           int S, int Q, int H, int D, int L, int P, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv) || !tap_kernel_fits(B, Q, H, D, L, P, sizeof(Tap)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kTapWarps * H * L * P * sizeof(Tap);
  auto kern = exact_kernel<T>;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const long long blocks = ((long long)B * Q + kTapWarps - 1) / kTapWarps;
  kern<<<(unsigned)blocks, kTapWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)locs, (const float*)weights, (float*)out, B, S, Q, H, D,
      P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// Every pointer aligned to its vector accesses (16 bytes).
extern "C" int deform_attn_exact_f32(const void* value, const void* locs,
                                     const void* weights, void* out, int B, int S, int Q,
                                     int H, int D, int L, int P, const int* hw,
                                     void* stream) {
  return launch<float>(value, locs, weights, out, B, S, Q, H, D, L, P, hw, stream);
}

extern "C" int deform_attn_exact_bf16(const void* value, const void* locs,
                                      const void* weights, void* out, int B, int S, int Q,
                                      int H, int D, int L, int P, const int* hw,
                                      void* stream) {
  return launch<__nv_bfloat16>(value, locs, weights, out, B, S, Q, H, D, L, P, hw, stream);
}
