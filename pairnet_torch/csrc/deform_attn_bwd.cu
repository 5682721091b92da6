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
//     bf16(g_bf16 * (cw * a)) rounded before it is summed into dvalue.
//
// Semantics (mmcv MultiScaleDeformableAttention backward): pixel coordinate
// p * size - 0.5, computed as the plain version does (a product, then a
// sum, no fused multiply-add); a corner outside the level's plane passes no
// gradient, neither to dvalue nor through its bilinear weight to dlocs.
// dlocs is the gradient with respect to the normalized location (x part
// times w, y part times h).
//
// Layout: value (B, S, H, D) f32 or bf16, locs (B, Q, H, L, P, 2) f32,
// weights (B, Q, H, L, P) f32, g (B, Q, H * D) f32 or bf16; dvalue
// (B, S, H, D) f32 scratch (+ a bf16 copy for bf16 values), dlocs and
// dweights in the locs/weights layouts, f32. D a multiple of 8 up to 64.
//
// Design: one warp per query (b, q) over all its heads, the layout of the
// warp-per-query gathers (msda_common.cuh). One lane computes the geometry
// of each tap (h, l, p) into shared memory: the corner tokens, clamped into
// the plane, the in-plane mask, the fractional position and cw * a per
// corner (0 off the plane). A head's channels go to pw lanes (D / 8 rounded
// up to a power of two; 4 at D = 32), 8 channels a lane: 4 in each half of
// the head's row (lane j: 4j .. 4j + 3 and D / 2 + 4j ..), so that each
// access of the head's lanes covers whole 32-byte sectors. Each lane holds
// its 8 channels of g in registers for the whole query, read once. Per tap
// and in-plane corner a lane loads its 8 value channels (two 8-byte loads
// for bf16, two 16-byte ones for f32; the loads of up to 4 taps, 2 for f32,
// issued before any is used), adds its share of s_k = sum_d g_d v_dk, and
// adds its 8 products g_d * (cw_k * a) into dvalue with two float4 atomics
// (sm_90's vector atomicAdd) instead of 8 scalar ones. An off-plane corner
// issues neither its load nor its atomic. The head's pw lanes then sum s_k
// by a log2(pw)-step shuffle, and its first lane forms
//   dweight = sum_k cw_k s_k,  dloc = (sum_k dcw_k/dfx s_k * a * w,
//                                      sum_k dcw_k/dfy s_k * a * h),
// with the in-plane mask on every term, into the tap's shared slot; the
// lanes then write the query's dweights and dlocs as contiguous rows.
//
// Bound on an H100: bytes. The function reads value, locations, weights
// and g once and writes dvalue, dlocs and dweights once; its least work,
// ~4 operations per in-plane corner and channel, is far below the
// operations-per-byte ridge. What the kernel moves beyond that, per
// in-plane corner and head: its D value channels read and D f32 additions
// into the scratch, as float4 pieces. At the training shapes (batch 4,
// 800x1344) that is 4.3 GB of scattered writes into a 90 MB scratch, which
// does not fit the 50 MB L2; those writes, more than the atomics or the
// loads, set its pace (timed with the atomics made plain stores and the
// loads made constants: pairnet_torch/tools/msda_kernels.py). Summing the
// taps of neighbouring queries in a shared-memory window first would cut
// them, but an f32 atomicAdd on shared memory is a compare-and-swap loop
// on sm_90, slower than the vector atomics it would save.

#include "msda_common.cuh"

namespace {

// One tap (h, l, p) of the backward, in shared memory.
struct alignas(16) BwdTap {
  int4 tok;     // the four corners' tokens in S, clamped into the level's plane
  float4 cwa;   // cw_k * a per corner (00, 01, 10, 11), 0 off the plane
  float fx, fy;  // the fractional position in the pixel cell
  float a;       // the attention weight
  int in;        // bit k: corner k lies in the plane
  float4 grad;   // dweight, dloc x, dloc y of the tap, once summed
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ BwdTap make_bwd_tap(float2 xy, float a, int l, const Levels& lv) {
  const int hl = lv.h[l], wl = lv.w[l];
  const float x = __fmul_rn(xy.x, (float)wl) - 0.5f;
  const float y = __fmul_rn(xy.y, (float)hl) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  BwdTap t;
  t.tok = make_int4(0, 0, 0, 0);
  t.cwa = make_float4(0.f, 0.f, 0.f, 0.f);
  t.fx = 0.f;
  t.fy = 0.f;
  t.a = a;
  t.in = 0;
  t.grad = make_float4(0.f, 0.f, 0.f, 0.f);
  // some corner inside the plane; this also keeps the int casts in range
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
    t.tok = make_int4(s0 + yt * wl + xl, s0 + yt * wl + xr, s0 + ybt * wl + xl,
                      s0 + ybt * wl + xr);
    t.in = (ya && xa) | (ya && xb) << 1 | (yb && xa) << 2 | (yb && xb) << 3;
    t.fx = fx;
    t.fy = fy;
    t.cwa = make_float4(ya && xa ? __fmul_rn((1.f - fx) * (1.f - fy), a) : 0.f,
                        ya && xb ? __fmul_rn(fx * (1.f - fy), a) : 0.f,
                        yb && xa ? __fmul_rn((1.f - fx) * fy, a) : 0.f,
                        yb && xb ? __fmul_rn(fx * fy, a) : 0.f);
  }
  return t;
}

// 4 consecutive channels as loaded: 8 bytes (bf16) or 16 (f32).
template <typename T>
struct Raw4;
template <>
struct Raw4<__nv_bfloat16> {
  uint2 u;
};
template <>
struct Raw4<float> {
  float4 f;
};

__device__ __forceinline__ Raw4<__nv_bfloat16> load4(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint2*>(p))};
}
__device__ __forceinline__ Raw4<float> load4(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p))};
}

__device__ __forceinline__ void unpack4(const Raw4<__nv_bfloat16>& r, float* v) {
  v[0] = __uint_as_float(r.u.x << 16);
  v[1] = __uint_as_float(r.u.x & 0xffff0000u);
  v[2] = __uint_as_float(r.u.y << 16);
  v[3] = __uint_as_float(r.u.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack4(const Raw4<float>& r, float* v) {
  v[0] = r.f.x, v[1] = r.f.y, v[2] = r.f.z, v[3] = r.f.w;
}

// A lane's 8 channels of a row: 4 at p and 4 at p + half (half = D / 2), so
// that the head's lanes cover whole 32-byte sectors with each access.
template <typename T>
struct Lane8 {
  Raw4<T> lo, hi;
};

template <typename T>
__device__ __forceinline__ Lane8<T> load_lane8(const T* p, int half) {
  return {load4(p), load4(p + half)};
}

template <typename T>
__device__ __forceinline__ void unpack_lane8(const Lane8<T>& r, float (&v)[8]) {
  unpack4(r.lo, v);
  unpack4(r.hi, v + 4);
}

// dvalue[p .. p + 4) += v[0 .. 4), dvalue[p + half .. p + half + 4) +=
// v[4 .. 8): two 16-byte vector atomics (sm_90).
__device__ __forceinline__ void add8(float* p, int half, const float (&v)[8]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  atomicAdd(reinterpret_cast<float4*>(p + half), make_float4(v[4], v[5], v[6], v[7]));
}

template <typename T, typename GT, bool kBf16Grad>
__global__ void __launch_bounds__(kTapWarps * 32)
bwd_kernel(const T* __restrict__ value, const float* __restrict__ locs,
           const float* __restrict__ weights, const GT* __restrict__ g,
           float* __restrict__ dvalue, float* __restrict__ dlocs, float* __restrict__ dweights,
           int B, int S, int Q, int H, int D, int P, int pw, Levels lv) {
  constexpr int kInFlight = sizeof(T) == 2 ? 4 : 2;  // taps whose loads are in flight
  extern __shared__ BwdTap btaps_all[];
  const int L = lv.n;
  const int LP = L * P, HLP = H * LP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bq = (long long)blockIdx.x * kTapWarps + warp;
  if (bq >= (long long)B * Q) return;  // the whole warp; no block barrier follows
  const int b = (int)(bq / Q);
  BwdTap* taps = btaps_all + warp * HLP;

  const float2* loc = reinterpret_cast<const float2*>(locs) + bq * HLP;
  const float* wt = weights + bq * HLP;
  for (int i = lane; i < HLP; i += 32) taps[i] = make_bwd_tap(loc[i], wt[i], (i / P) % L, lv);
  __syncwarp();

  const int G = D / 8;  // 8-channel groups per head, on pw >= G lanes
  const long long row = (long long)H * D;
  // every loop bound below is uniform over the warp, so all lanes reach the shuffles
  for (int h0 = 0; h0 < H; h0 += 32 / pw) {
    const int h = h0 + lane / pw, grp = lane % pw;
    const bool active = h < H && grp < G;
    const int hs = h < H ? h : H - 1;  // an idle lane reads some head's taps
    const int c4 = grp * 4, half = D / 2;  // channels c4 .. c4 + 3 of each half
    float gv[8];
    if (active) {
      unpack_lane8(load_lane8(g + bq * row + (long long)h * D + c4, half), gv);
      if (kBf16Grad) {
#pragma unroll
        for (int c = 0; c < 8; ++c) gv[c] = round_bf16(gv[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) gv[c] = 0.f;
    }
    const long long base = (long long)b * S * row + (long long)hs * D + c4;
    const T* vb = value + base;
    float* dvb = dvalue + base;
    for (int l = 0; l < L; ++l) {
      BwdTap* tl = taps + hs * LP + l * P;
      for (int p0 = 0; p0 < P; p0 += kInFlight) {
        Lane8<T> raw[kInFlight][4];
#pragma unroll
        for (int pp = 0; pp < kInFlight; ++pp) {
          if (p0 + pp < P) {
            const int4 tk = tl[p0 + pp].tok;
            const int in = active ? tl[p0 + pp].in : 0;
            const int tok[4] = {tk.x, tk.y, tk.z, tk.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              raw[pp][k] = (in >> k & 1) ? load_lane8(vb + tok[k] * row, half) : Lane8<T>{};
          }
        }
#pragma unroll
        for (int pp = 0; pp < kInFlight; ++pp) {
          if (p0 + pp >= P) continue;
          BwdTap* tp = tl + p0 + pp;
          const int4 tk = tp->tok;
          const float4 c4 = tp->cwa;
          const int in = active ? tp->in : 0;
          const int tok[4] = {tk.x, tk.y, tk.z, tk.w};
          const float cwa[4] = {c4.x, c4.y, c4.z, c4.w};
          float sv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float v[8];
            unpack_lane8(raw[pp][k], v);
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) s = fmaf(gv[c], v[c], s);
            sv[k] = s;
            if (in >> k & 1) {
              float prod[8];
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                prod[c] = __fmul_rn(gv[c], cwa[k]);
                if (kBf16Grad) prod[c] = round_bf16(prod[c]);
              }
              add8(dvb + tok[k] * row, half, prod);
            }
          }
          for (int off = pw >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) sv[k] += __shfl_xor_sync(0xffffffffu, sv[k], off);
          }
          if (active && grp == 0) {
            const float fx = tp->fx, fy = tp->fy, a = tp->a;
            const int m = tp->in;
            const float cw[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy), (1.f - fx) * fy,
                                 fx * fy};
            const float cdx[4] = {-(1.f - fy), 1.f - fy, -fy, fy};
            const float cdy[4] = {-(1.f - fx), -fx, 1.f - fx, fx};
            float pa = 0.f, px = 0.f, py = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (m >> k & 1) {
                pa = fmaf(cw[k], sv[k], pa);
                px = fmaf(cdx[k], sv[k], px);
                py = fmaf(cdy[k], sv[k], py);
              }
            }
            tp->grad = make_float4(pa, px * a * (float)lv.w[l], py * a * (float)lv.h[l], 0.f);
          }
        }
      }
    }
  }
  __syncwarp();
  float2* dl = reinterpret_cast<float2*>(dlocs) + bq * HLP;
  float* dw = dweights + bq * HLP;
  for (int i = lane; i < HLP; i += 32) {
    const float4 gr = taps[i].grad;
    dw[i] = gr.x;
    dl[i] = make_float2(gr.y, gr.z);
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T, typename GT, bool kBf16Grad>
int launch_kernel(const void* value, const void* locs, const void* weights, const void* g,
                  void* dvalue_f32, void* dlocs, void* dweights, int B, int S, int Q, int H,
                  int D, int P, const Levels& lv, cudaStream_t st) {
  int pw = 1;
  while (pw < D / 8) pw <<= 1;
  const size_t smem = (size_t)kTapWarps * H * lv.n * P * sizeof(BwdTap);
  auto kern = bwd_kernel<T, GT, kBf16Grad>;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const long long blocks = ((long long)B * Q + kTapWarps - 1) / kTapWarps;
  kern<<<(unsigned)blocks, kTapWarps * 32, smem, st>>>(
      (const T*)value, (const float*)locs, (const float*)weights, (const GT*)g,
      (float*)dvalue_f32, (float*)dlocs, (float*)dweights, B, S, Q, H, D, P, pw, lv);
  return (int)cudaGetLastError();
}

// dvalue_f32: zeroed here, then accumulated; for bf16 values it is cast into
// dvalue_out, for f32 values the caller passes dvalue_out == dvalue_f32.
template <typename T, bool kBf16Grad>
int launch(const void* value, const void* locs, const void* weights, const void* g,
           int g_bf16, void* dvalue_f32, void* dvalue_out, void* dlocs, void* dweights, int B,
           int S, int Q, int H, int D, int L, int P, const int* hw, void* stream) {
  Levels lv;
  if (!make_levels(hw, L, &lv) || !tap_kernel_fits(B, Q, H, D, L, P, sizeof(BwdTap)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_value = (long long)B * S * H * D;
  int err = (int)cudaMemsetAsync(dvalue_f32, 0, n_value * sizeof(float), st);
  if (err) return err;
  err = g_bf16 ? launch_kernel<T, __nv_bfloat16, kBf16Grad>(value, locs, weights, g, dvalue_f32,
                                                             dlocs, dweights, B, S, Q, H, D, P,
                                                             lv, st)
               : launch_kernel<T, float, kBf16Grad>(value, locs, weights, g, dvalue_f32, dlocs,
                                                    dweights, B, S, Q, H, D, P, lv, st);
  if (err || dvalue_out == dvalue_f32) return err;
  const int threads = 256;
  cast_bf16_kernel<<<grid_for(n_value, threads), threads, 0, st>>>(
      (const float*)dvalue_f32, (__nv_bfloat16*)dvalue_out, n_value);
  return (int)cudaGetLastError();
}

}  // namespace

// g is bf16 if g_bf16, else f32; every pointer aligned to its vector
// accesses (16 bytes).
#define BWD_ARGS                                                                            \
  const void *value, const void *locs, const void *weights, const void *g, int g_bf16,     \
      void *dvalue_f32, void *dvalue_out, void *dlocs, void *dweights, int B, int S, int Q, \
      int H, int D, int L, int P, const int *hw, void *stream
#define BWD_PASS                                                                           \
  value, locs, weights, g, g_bf16, dvalue_f32, dvalue_out, dlocs, dweights, B, S, Q, H, D, \
      L, P, hw, stream

extern "C" int deform_attn_bwd_f32(BWD_ARGS) { return launch<float, false>(BWD_PASS); }

extern "C" int deform_attn_bwd_bf16(BWD_ARGS) { return launch<__nv_bfloat16, false>(BWD_PASS); }

extern "C" int deform_attn_bwd_bf16_grad(BWD_ARGS) {
  return launch<__nv_bfloat16, true>(BWD_PASS);
}
