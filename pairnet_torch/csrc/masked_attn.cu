// Masked flash cross-attention of the Mask2Former decoder, inference only.
//
// Replaces the TPU kernel pairnet_tpu/ops/pallas_masked_attn.py::_kernel
// (via masked_flash_attention). Per (b*h) plane and query:
//   s_j = (q * (1 / sqrt(D))) . k_j            f32 products
//   s_j = -1e9 where mask[b, q, j] is set      the mask is shared by the heads
//   out = sum_j softmax(s)_j v_j               online softmax in f32
// and the result is acc / max(l, 1e-30) in f32, as the TPU kernel's.
//
// Design (a first, simple one): one block of 4 warps per (b*h, tile of 16
// queries); each warp owns 4 queries. The block walks the keys in tiles of
// 64, staging K and V (converted to f32) and the 16 x 64 mask tile in shared
// memory. A lane scores keys lane and lane + 32 of the tile with f32 FMAs on
// the CUDA cores (the TPU kernel computes f32 scores; TF32 would change
// them), the warp reduces the tile's max and sum with shuffles, and lane d
// keeps the running output acc[d] in registers (D <= 32 per lane slot). The
// running max and sum live in registers of every lane of the warp.
//
// Bound on an H100: operations. A (b*h) plane does 4 * Lq * Lk * D f32
// operations (q.k and p.v, a multiply and an add each) on 2 * Lk * D key
// and value elements: at the decoder's Lq = 100 that is 100 operations per
// bf16 byte (50 per f32 byte), above the card's f32 ridge of 20 per byte
// (67 TFLOP/s over 3.35 TB/s). Each of a plane's ceil(Lq / 16) blocks (7 at
// Lq = 100) reads K and V again.
// Keys past the end of the plane take no part in the softmax (the TPU
// wrapper pads to 1024-key tiles with masked keys, which add 0 to every row
// with a live key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kQueriesPerWarp = 4;
constexpr int kQT = kWarps * kQueriesPerWarp;  // queries per block
constexpr int kKT = 64;                        // keys per tile
constexpr float kMasked = -1e9f;               // the TPU kernel's fill
constexpr float kNone = -3.0e38f;              // below any score: a key past the plane's end

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
masked_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const uint8_t* __restrict__ mask, float* __restrict__ out, int H, int Lq,
                   int Lk, float scale) {
  constexpr int NA = (D + 31) / 32;  // output channels per lane
  __shared__ float qs[kQT][D];
  __shared__ float ks[kKT][D + 1];  // +1: lanes reading rows j hit distinct banks
  __shared__ float vs[kKT][D];
  __shared__ uint8_t ms[kQT][kKT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kQT;
  const T* qp = q + (long long)bh * Lq * D;
  const T* kp = k + (long long)bh * Lk * D;
  const T* vp = v + (long long)bh * Lk * D;
  const uint8_t* mp = mask + (long long)b * Lq * Lk;

  for (int i = tid; i < kQT * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < Lq ? to_f32(qp[(long long)(q0 + r) * D + d]) * scale : 0.f;
  }

  float m[kQueriesPerWarp], l[kQueriesPerWarp], acc[kQueriesPerWarp][NA];
#pragma unroll
  for (int r = 0; r < kQueriesPerWarp; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NA; ++t) acc[r][t] = 0.f;
  }

  for (int t0 = 0; t0 < Lk; t0 += kKT) {
    const int nk = Lk - t0 < kKT ? Lk - t0 : kKT;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKT * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const bool in = j < nk;
      const long long off = (long long)(t0 + j) * D + d;
      ks[j][d] = in ? to_f32(kp[off]) : 0.f;
      vs[j][d] = in ? to_f32(vp[off]) : 0.f;
    }
    for (int i = tid; i < kQT * kKT; i += blockDim.x) {
      const int r = i / kKT, j = i % kKT;
      ms[r][j] = (q0 + r < Lq && j < nk) ? mp[(long long)(q0 + r) * Lk + t0 + j] : 1;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kQueriesPerWarp; ++r) {
      const int qi = warp * kQueriesPerWarp + r;
      if (q0 + qi >= Lq) continue;  // warp-uniform
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qs[qi][d], ks[j][d], dot);
        s[c] = ms[qi][j] ? kMasked : dot;
      }
      // keys past the end of the plane take no part
      const bool in0 = lane < nk, in1 = lane + 32 < nk;
      const float tile_max = warp_max(fmaxf(in0 ? s[0] : kNone, in1 ? s[1] : kNone));
      const float m_new = fmaxf(m[r], tile_max);
      const float p0 = in0 ? expf(s[0] - m_new) : 0.f;
      const float p1 = in1 ? expf(s[1] - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NA; ++t) acc[r][t] *= corr;
      for (int j = 0; j < 32; ++j) {
        const float pa = __shfl_sync(0xffffffffu, p0, j);
        const float pb = __shfl_sync(0xffffffffu, p1, j);
#pragma unroll
        for (int t = 0; t < NA; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[r][t] = fmaf(pb, vs[j + 32][d], fmaf(pa, vs[j][d], acc[r][t]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQueriesPerWarp; ++r) {
    const int qi = q0 + warp * kQueriesPerWarp + r;
    if (qi >= Lq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* o = out + ((long long)bh * Lq + qi) * D;
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const int d = lane + 32 * t;
      if (d < D) o[d] = acc[r][t] * inv;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int BH,
           int H, int Lq, int Lk, int D, float scale, void* stream) {
  if (H < 1 || BH % H != 0 || BH > 65535 || Lq < 1 || Lk < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((Lq + kQT - 1) / kQT, BH);
  const dim3 block(kWarps * 32);
  const cudaStream_t st = (cudaStream_t)stream;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const uint8_t* mt = (const uint8_t*)mask;
  float* ot = (float*)out;
  switch (D) {
    case 8: masked_attn_kernel<T, 8><<<grid, block, 0, st>>>(qt, kt, vt, mt, ot, H, Lq, Lk, scale); break;
    case 16: masked_attn_kernel<T, 16><<<grid, block, 0, st>>>(qt, kt, vt, mt, ot, H, Lq, Lk, scale); break;
    case 32: masked_attn_kernel<T, 32><<<grid, block, 0, st>>>(qt, kt, vt, mt, ot, H, Lq, Lk, scale); break;
    case 64: masked_attn_kernel<T, 64><<<grid, block, 0, st>>>(qt, kt, vt, mt, ot, H, Lq, Lk, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, Lq, D), k and v (BH, Lk, D), all of one dtype; mask bool (B, Lq, Lk)
// with B = BH / H, set = masked out; out f32 (BH, Lq, D). D in {8, 16, 32, 64}.
extern "C" int masked_attn_f32(const void* q, const void* k, const void* v, const void* mask,
                               void* out, int BH, int H, int Lq, int Lk, int D, float scale,
                               void* stream) {
  return launch<float>(q, k, v, mask, out, BH, H, Lq, Lk, D, scale, stream);
}

extern "C" int masked_attn_bf16(const void* q, const void* k, const void* v, const void* mask,
                                void* out, int BH, int H, int Lq, int Lk, int D, float scale,
                                void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, out, BH, H, Lq, Lk, D, scale, stream);
}
