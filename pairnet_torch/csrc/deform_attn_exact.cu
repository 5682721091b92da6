// Exact multi-scale deformable attention forward.
//
// Replaces the TPU kernels pairnet_tpu/ops/pallas_deform_attn_v6.py::_kernel
// (f32 values) and pairnet_tpu/ops/pallas_deform_attn_v7.py::_kernel (bf16
// values): the same function, one template over the value type, with f32
// locations, weights, accumulation and output.
//
// Layout: value (B, S, H, D), locs (B, Q, H, L, P, 2), weights
// (B, Q, H, L, P), out (B, Q, H * D) f32.
//
// Design (mmcv ms_deformable_im2col shape): one thread per output
// (b, q, h, d), d fastest, so the D threads of one (b, q, h) read
// value[b, s, h, :] as one coalesced row per corner and share each
// location and weight as a broadcast load. Every level is visited in one
// launch and the sum stays in a register.
//
// Bound on an H100: bytes. Each output reads L * P * 4 value rows, 2 * L * P
// location floats and L * P weights and writes one f32; per output element
// that is ~10 flops per tap against ~4 value bytes per corner, far below
// the card's operations-per-byte ridge. The least time is
// (value + locs + weights + out bytes) / memory bandwidth.

#include "msda_common.cuh"

namespace {

template <typename T>
__global__ void exact_kernel(const T* __restrict__ value, const float* __restrict__ locs,
                             const float* __restrict__ weights, float* __restrict__ out,
                             int B, int S, int Q, int H, int D, int P, Levels lv) {
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
    const T* vb = value + (long long)b * S * row + (long long)h * D + d;
    float acc = 0.f;
    for (int l = 0; l < L; ++l)
      acc += level_taps(vb + lv.start[l] * row, row, lv.h[l], lv.w[l],
                        loc + l * P * 2, wt + l * P, P);
    out[i] = acc;
  }
}

template <typename T>
int launch(const void* value, const void* locs, const void* weights, void* out, int B,
           int S, int Q, int H, int D, int L, int P, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = (long long)B * Q * H * D;
  exact_kernel<T><<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const T*)value, (const float*)locs, (const float*)weights, (float*)out, B, S, Q, H,
      D, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

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
