// int4 multi-scale deformable attention for bf16 serving: quantize + gather.
//
// Replaces the TPU kernels of pairnet_tpu/ops/pallas_deform_attn_v16.py:
//   * _qp16_kernel (via _quantize_pack_int4) -> int4_quantize below: one
//     scale per (b, h, level, d), max(absmax / 7, 1e-20), and codes
//     clip(rint(v / scale), -7, 7) with an IEEE f32 divide and
//     round-half-to-even.
//   * _kernel (via _weighted_gather_v16) -> int4_gather below: bilinear
//     taps on the codes for all levels in one launch, f32 accumulation, the
//     scale folded in once per (level, d), bf16 output.
//
// The TPU kernel packs the 2x2 footprint of two channels as nibbles of one
// int32 lane; that is a lane trick of the TPU's vector unit. Here each code
// is an int8 in the value layout (B, S, H, D), the scales are f32
// (B, H, L, D), and every corner is bounds-checked on its own.
//
// Bounds on an H100: bytes for both. int4_quantize reads the value twice
// (absmax pass, then quantize pass; the least traffic counts it once) and
// writes one byte per element. int4_gather reads the codes, locations and
// weights and writes bf16; it is the exact kernel's design (one thread per
// output (b, q, h, d), d fastest, coalesced code rows) at a quarter of the
// f32 value bytes.

#include "msda_common.cuh"

namespace {

// Chunks of `chunk` tokens, numbered level by level: level l owns chunks
// [first[l], first[l + 1]).
struct Chunks {
  int chunk;
  int first[kMaxLevels + 1];
};

__global__ void absmax_kernel(const __nv_bfloat16* __restrict__ value, unsigned* __restrict__ amax,
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
  const __nv_bfloat16* v = value + (long long)b * S * HD + c;
  float m = 0.f;
  for (long long s = lo; s < hi; ++s) m = fmaxf(m, fabsf(to_f32(v[s * HD])));
  // non-negative floats order like their bit patterns
  atomicMax(amax + ((long long)b * lv.n + l) * HD + c, __float_as_uint(m));
}

__global__ void quantize_kernel(const __nv_bfloat16* __restrict__ value, const unsigned* __restrict__ amax,
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
    const float scale = fmaxf(__fdiv_rn(am, 7.f), 1e-20f);
    float q = rintf(__fdiv_rn(to_f32(value[i]), scale));
    q = fminf(fmaxf(q, -7.f), 7.f);
    codes[i] = (int8_t)q;
    if (s == lv.start[l]) {
      const int h = c / D, d = c % D;
      scales[(((long long)b * H + h) * lv.n + l) * D + d] = scale;
    }
  }
}

__global__ void gather_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
                              const float* __restrict__ locs, const float* __restrict__ weights,
                              __nv_bfloat16* __restrict__ out, int B, int S, int Q, int H,
                              int D, int P, Levels lv) {
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
    for (int l = 0; l < L; ++l)
      acc += sc[l * D] * level_taps(vb + lv.start[l] * row, row, lv.h[l], lv.w[l],
                                    loc + l * P * 2, wt + l * P, P);
    out[i] = __float2bfloat16_rn(acc);
  }
}

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
  absmax_kernel<<<grid, tx, 0, st>>>((const __nv_bfloat16*)value, (unsigned*)amax, S, HD, lv, ck);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int threads = 256;
  quantize_kernel<<<grid_for((long long)B * S * HD, threads), threads, 0, st>>>(
      (const __nv_bfloat16*)value, (const unsigned*)amax, (int8_t*)codes, (float*)scales, B, S, H, D, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// value: bf16 (B, S, H, D); amax: zeroed u32 scratch of B * L * H * D entries.
extern "C" int int4_quantize_bf16(const void* value, void* amax, void* codes, void* scales,
                                  int B, int S, int H, int D, int L, const int* hw,
                                  void* stream) {
  return quantize(value, amax, codes, scales, B, S, H, D, L, hw, stream);
}

extern "C" int int4_gather(const void* codes, const void* scales, const void* locs,
                           const void* weights, void* out, int B, int S, int Q, int H, int D,
                           int L, int P, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)B * Q * H * D;
  gather_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, (const float*)locs, (const float*)weights,
      (__nv_bfloat16*)out, B, S, Q, H, D, P, lv);
  return (int)cudaGetLastError();
}
