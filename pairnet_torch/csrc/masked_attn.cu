// Masked flash cross-attention of the Mask2Former decoder, inference only.
//
// Replaces the TPU kernel pairnet_tpu/ops/pallas_masked_attn.py::_kernel
// (via masked_flash_attention). Per (b*h) plane and query:
//   s_j = (q . k_j) / sqrt(D)                  scores in f32
//   s_j = -1e9 where mask[b, q, j] is set      the mask is shared by the heads
//   out = sum_j softmax(s)_j v_j               online softmax in f32
// and the result is acc / max(l, 1e-30) in f32, as the TPU kernel's. Keys
// past the end of the plane take no part (the TPU wrapper pads to 1024-key
// tiles with masked keys, which add 0 to every row with a live key).
//
// Bound on an H100: bytes. At the decoder's shapes (B = 8, H = 8, Lq = 100,
// D = 32, Lk up to 16800) K and V are 137.6 MB in bf16 and the mask 13.4 MB,
// 0.046 ms at 3.35 TB/s, against 0.014 ms for the 1.38e10 operations at the
// bf16 tensor-core rate. So the products run on tensor cores with
// mma.sync: wgmma's 64-row tiles would buy nothing at 100 queries and a
// kernel bound by bytes.
//
// Design:
//   * flash_partial_kernel: one CTA of 8 warps per (image b, chunk of at
//     most 512 keys), covering all H heads of the image. The chunk's mask
//     rows of a group of 128 queries are loaded into shared memory once and
//     read by every head: the mask crosses the bus once, not H times. The
//     CTA walks (head, 64-key tile) steps; each tile's K and V are staged
//     with cp.async into a double-buffered ring, so the next copy overlaps
//     the current products. Warp w owns queries [16w, 16w + 16) of the
//     group: one m16 tile, its running max, sum and accumulator in
//     registers. At a head's last tile it writes its partial (m, l, acc) in
//     f32 to a scratch of the wrapper.
//   * bf16 instance: q.k as m16n8k16 bf16 products with an f32 accumulator
//     (exact products; the 1/sqrt(D) scale applied to the f32 score after
//     them). P.V with P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//     two products with V: the residual error is ~2^-18 P. The row sum l
//     is taken over the f32 P.
//   * f32 instance: 3xTF32 on m16n8k8 (a_hi b_hi + a_hi b_lo + a_lo b_hi,
//     each operand split into TF32 hi and lo parts), q scaled by 1/sqrt(D)
//     in f32 first as the TPU kernel does; f32-level accuracy.
//   * flash_merge_kernel: one thread per (plane, query, channel) merges the
//     chunks' partials: weights 2^(m_c - m), out = sum_c w_c acc_c /
//     max(sum_c w_c l_c, 1e-30). A chunk whose keys are all masked for a
//     row has m_c = -1e9 (in log2 units) and contributes exactly 0 beside a
//     chunk with a live key; a row masked everywhere averages all values.
//   * Exponentials are exp2 of scores pre-multiplied by log2(e).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQG = kWarps * 16;  // queries per group: one m16 tile per warp
constexpr int kKT = 64;           // keys per tile
constexpr int kMaxChunk = 512;    // keys per CTA, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;  // the TPU kernel's fill, in log2 units
constexpr float kNone = -3.0e38f;          // below any score: a key past the end
constexpr float kInit = -1e30f;            // running max before the first tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = in ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// The f32 scores of one 64-key tile for a warp's 16 queries: S[j] holds
// keys 8j + 2t, 8j + 2t + 1 of rows g (S[j][0..1]) and g + 8 (S[j][2..3]).
template <int D>
__device__ __forceinline__ void scores_bf16(float (&S)[8][4], const uint32_t (&qa)[(D + 15) / 16][4],
                                            const __nv_bfloat16* kt, int g, int t) {
  constexpr int KS = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.f;
    const __nv_bfloat16* kr = kt + (8 * j + g) * KS;
#pragma unroll
    for (int s = 0; s < (D + 15) / 16; ++s) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * s + 2 * t);
      const uint32_t b1 = D >= 16 ? *reinterpret_cast<const uint32_t*>(kr + 16 * s + 8 + 2 * t) : 0u;
      mma_bf16(S[j], qa[s], b0, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void scores_f32(float (&S)[8][4], const uint32_t (&qh)[D / 8][4],
                                           const uint32_t (&ql)[D / 8][4], const float* kt, int g,
                                           int t) {
  constexpr int KS = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.f;
    const float* kr = kt + (8 * j + g) * KS;
#pragma unroll
    for (int s = 0; s < D / 8; ++s) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(kr[8 * s + t], bh0, bl0);
      split_tf32(kr[8 * s + t + 4], bh1, bl1);
      mma_tf32(S[j], ql[s], bh0, bh1);
      mma_tf32(S[j], qh[s], bl0, bl1);
      mma_tf32(S[j], qh[s], bh0, bh1);
    }
  }
}

// acc += P V for one tile; P[j] in the layout of S.
template <int D>
__device__ __forceinline__ void pv_bf16(float (&acc)[D / 8][4], const float (&P)[8][4],
                                        const __nv_bfloat16* vt, int g, int t) {
  constexpr int KS = D + 8;
  const uint16_t* vr = reinterpret_cast<const uint16_t*>(vt);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // keys 16kk .. 16kk + 15
    uint32_t hi[4], lo[4];
    const float* p0 = P[2 * kk];
    const float* p1 = P[2 * kk + 1];
    const float pv[8] = {p0[0], p0[1], p0[2], p0[3], p1[0], p1[1], p1[2], p1[3]};
    float ph[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ph[i] = __bfloat162float(__float2bfloat16_rn(pv[i]));
    // A fragment: rows g (regs 0, 2) and g + 8 (regs 1, 3); keys 2t, 2t + 1
    // (regs 0, 1) and 2t + 8, 2t + 9 (regs 2, 3) of the 16
    hi[0] = pack_bf16(ph[0], ph[1]);
    hi[1] = pack_bf16(ph[2], ph[3]);
    hi[2] = pack_bf16(ph[4], ph[5]);
    hi[3] = pack_bf16(ph[6], ph[7]);
    lo[0] = pack_bf16(pv[0] - ph[0], pv[1] - ph[1]);
    lo[1] = pack_bf16(pv[2] - ph[2], pv[3] - ph[3]);
    lo[2] = pack_bf16(pv[4] - ph[4], pv[5] - ph[5]);
    lo[3] = pack_bf16(pv[6] - ph[6], pv[7] - ph[7]);
    const int k0 = 16 * kk + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = 8 * n + g;
      const uint32_t b0 = pack_raw(vr[k0 * KS + d], vr[(k0 + 1) * KS + d]);
      const uint32_t b1 = pack_raw(vr[(k0 + 8) * KS + d], vr[(k0 + 9) * KS + d]);
      mma_bf16(acc[n], lo, b0, b1);
      mma_bf16(acc[n], hi, b0, b1);
    }
  }
}

template <int D>
__device__ __forceinline__ void pv_f32(float (&acc)[D / 8][4], const float (&P)[8][4],
                                       const float* vt, int g, int t) {
  constexpr int KS = D + 8;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {  // keys 8kk .. 8kk + 7
    // The k8 step's column t stands for key 8kk + 2t and column t + 4 for
    // key 8kk + 2t + 1: the layout of S, so P needs no shuffle; B follows.
    uint32_t ah[4], al[4];
    split_tf32(P[kk][0], ah[0], al[0]);
    split_tf32(P[kk][2], ah[1], al[1]);
    split_tf32(P[kk][1], ah[2], al[2]);
    split_tf32(P[kk][3], ah[3], al[3]);
    const int k0 = 8 * kk + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = 8 * n + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(vt[k0 * KS + d], bh0, bl0);
      split_tf32(vt[(k0 + 1) * KS + d], bh1, bl1);
      mma_tf32(acc[n], al, bh0, bh1);
      mma_tf32(acc[n], ah, bl0, bl1);
      mma_tf32(acc[n], ah, bh0, bh1);
    }
  }
}

// Partial (m, l, acc) of every (chunk, plane, query): acc at
// pacc[((c * BH + bh) * Lq + q) * D + d], (m, l) at pml[(c * BH + bh) * Lq + q],
// m in log2 units.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const uint8_t* __restrict__ mask, float* __restrict__ pacc,
                     float2* __restrict__ pml, int H, int Lq, int Lk, int CK, float scale,
                     int mask_words) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KS = D + 8;  // row stride of a staged K or V tile, in elements
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte pieces per key row
  constexpr int EPC = 16 / (int)sizeof(T);       // elements per piece
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [2][kKT][KS]
  T* vs = ks + 2 * kKT * KS;           // [2][kKT][KS]
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + 2 * kKT * KS);  // [kQG][MS]
  const int MS = CK + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, b = blockIdx.y;
  const int BH = gridDim.y * H;
  const int c0 = c * CK;
  const int nk = min(CK, Lk - c0);  // keys of this chunk, >= 1
  const int ntiles = (nk + kKT - 1) / kKT;
  const int steps = H * ntiles;
  // bf16: the scale after the exact product; f32: q is scaled first
  const float post = kBf16 ? scale * kLog2e : kLog2e;

  auto issue = [&](int s) {  // stage step s's K and V tile into buffer s & 1
    const int h = s / ntiles, tile = s % ntiles;
    const long long plane = (long long)(b * H + h) * Lk * D;
    const int kb = c0 + tile * kKT;
    const int kn = min(kKT, c0 + nk - kb);
    T* kd = ks + (s & 1) * kKT * KS;
    T* vd = vs + (s & 1) * kKT * KS;
    for (int i = tid; i < kKT * CPR; i += kThreads) {
      const int r = i / CPR, e = (i % CPR) * EPC;
      const bool in = r < kn;
      const long long off = plane + (long long)(kb + (in ? r : 0)) * D + e;
      cp_async16(kd + r * KS + e, k + off, in);
      cp_async16(vd + r * KS + e, v + off, in);
    }
  };

  for (int q0 = 0; q0 < Lq; q0 += kQG) {
    __syncthreads();  // the previous group's mask rows are consumed
    issue(0);
    cp_async_commit();
    // the chunk's mask rows of this group, read by every head
    const int nq = min(kQG, Lq - q0);
    const uint8_t* mrow = mask + ((long long)b * Lq + q0) * Lk + c0;
    if (mask_words) {
      const int wpr = (nk + 3) / 4;
      for (int i = tid; i < nq * wpr; i += kThreads) {
        const int r = i / wpr, w = i % wpr;
        *reinterpret_cast<uint32_t*>(ms + r * MS + 4 * w) =
            *reinterpret_cast<const uint32_t*>(mrow + (long long)r * Lk + 4 * w);
      }
    } else {
      for (int i = tid; i < nq * nk; i += kThreads) {
        const int r = i / nk, j = i % nk;
        ms[r * MS + j] = mrow[(long long)r * Lk + j];
      }
    }

    const int r0 = q0 + warp * 16;  // first query of this warp's m16 tile
    const bool active = r0 < Lq;
    const int ra = r0 + g, rb = r0 + g + 8;
    const uint8_t* mra = ms + (warp * 16 + g) * MS;
    const uint8_t* mrb = mra + 8 * MS;
    uint32_t qa[kBf16 ? (D + 15) / 16 : D / 8][4];  // bf16 q, or f32 q's TF32 hi part
    uint32_t ql[kBf16 ? 1 : D / 8][4];              // f32 q's TF32 lo part
    float m[2], l[2], acc[D / 8][4];

    for (int s = 0; s < steps; ++s) {
      const int h = s / ntiles, tile = s % ntiles;
      if (s + 1 < steps) issue(s + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      if (active) {
        const int bh = b * H + h;
        if (tile == 0) {  // a new head: its q fragment, a fresh state
          const T* qp = q + (long long)bh * Lq * D;
          if constexpr (kBf16) {
            const uint16_t* qr = reinterpret_cast<const uint16_t*>(qp);
#pragma unroll
            for (int s16 = 0; s16 < (D + 15) / 16; ++s16) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = (i & 1) ? rb : ra;
                const int d = 16 * s16 + 2 * t + ((i & 2) ? 8 : 0);
                qa[s16][i] = (r < Lq && d < D)
                                 ? *reinterpret_cast<const uint32_t*>(qr + (long long)r * D + d)
                                 : 0u;
              }
            }
          } else {
#pragma unroll
            for (int s8 = 0; s8 < D / 8; ++s8) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = (i & 1) ? rb : ra;
                const int d = 8 * s8 + t + ((i & 2) ? 4 : 0);
                const float x = r < Lq ? static_cast<float>(qp[(long long)r * D + d]) * scale : 0.f;
                split_tf32(x, qa[s8][i], ql[s8][i]);
              }
            }
          }
          m[0] = m[1] = kInit;
          l[0] = l[1] = 0.f;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        }

        const T* kt = ks + (s & 1) * kKT * KS;
        const T* vt = vs + (s & 1) * kKT * KS;
        float S[8][4];
        if constexpr (kBf16) {
          scores_bf16<D>(S, qa, kt, g, t);
        } else {
          scores_f32<D>(S, qa, ql, kt, g, t);
        }
        // mask, keys past the end, row maxima (rows g: S[j][0..1], g + 8: S[j][2..3])
        const int kn = min(kKT, nk - tile * kKT);
        float mx[2] = {kNone, kNone};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kj = 8 * j + 2 * t;
          const int col = tile * kKT + kj;
          const uint8_t* pa = mra + col;
          const uint8_t* pb = mrb + col;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = i & 1;
            const bool set = (i < 2 ? pa : pb)[e] != 0;
            const float x = kj + e < kn ? (set ? kMasked : S[j][i] * post) : kNone;
            S[j][i] = x;
            mx[i >> 1] = fmaxf(mx[i >> 1], x);
          }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          corr[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = exp2f(S[j][i] - m[i >> 1]);
            S[j][i] = p;
            l[i >> 1] += p;  // this thread's share; the row's 4 threads add at the end
          }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
        if constexpr (kBf16) {
          pv_bf16<D>(acc, S, vt, g, t);
        } else {
          pv_f32<D>(acc, S, vt, g, t);
        }

        if (tile == ntiles - 1) {  // the head's partial for this chunk
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          }
          const long long base = (long long)(c * BH + bh) * Lq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? rb : ra;
            if (row >= Lq) continue;
            if (t == 0) pml[base + row] = make_float2(m[r], l[r]);
            float* o = pacc + (base + row) * D + 2 * t;
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
              *reinterpret_cast<float2*>(o + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
          }
        }
      }
      __syncthreads();  // buffer s & 1 is consumed before step s + 2 refills it
    }
  }
}

__global__ void flash_merge_kernel(const float* __restrict__ pacc, const float2* __restrict__ pml,
                                   float* __restrict__ out, long long rows, int D, int NC) {
  const long long total = rows * D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / D;
    float mg = kInit;
    for (int c = 0; c < NC; ++c) mg = fmaxf(mg, pml[c * rows + row].x);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < NC; ++c) {
      const float2 ml = pml[c * rows + row];
      const float w = exp2f(ml.x - mg);
      l += w * ml.y;
      a += w * pacc[c * rows * D + i];
    }
    out[i] = a / fmaxf(l, 1e-30f);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const uint8_t* mask, float* out, float* pacc,
             float2* pml, int B, int H, int Lq, int Lk, int CK, float scale, cudaStream_t st) {
  const int NC = (Lk + CK - 1) / CK;
  const size_t smem = 2 * 2 * kKT * (D + 8) * sizeof(T) + (size_t)kQG * (CK + 8);
  auto kern = flash_partial_kernel<T, D>;
  int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int words = Lk % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  kern<<<dim3(NC, B), kThreads, smem, st>>>(q, k, v, mask, pacc, pml, H, Lq, Lk, CK, scale, words);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long rows = (long long)B * H * Lq;
  long long blocks = (rows * D + 255) / 256;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // the kernel strides over the rest
  flash_merge_kernel<<<(unsigned)blocks, 256, 0, st>>>(pacc, pml, out, rows, D, NC);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* pacc,
           void* pml, int BH, int H, int Lq, int Lk, int D, int CK, float scale, void* stream) {
  if (H < 1 || BH % H != 0 || BH / H > 65535 || Lq < 1 || Lk < 1 || CK < kKT ||
      CK > kMaxChunk || CK % kKT != 0 || (Lk + CK - 1) / CK > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  const uint8_t* mt = (const uint8_t*)mask;
  float* ot = (float*)out;
  float* pa = (float*)pacc;
  float2* pm = (float2*)pml;
  const int B = BH / H;
  switch (D) {
    case 8: return launch_d<T, 8>(qt, kt, vt, mt, ot, pa, pm, B, H, Lq, Lk, CK, scale, st);
    case 16: return launch_d<T, 16>(qt, kt, vt, mt, ot, pa, pm, B, H, Lq, Lk, CK, scale, st);
    case 32: return launch_d<T, 32>(qt, kt, vt, mt, ot, pa, pm, B, H, Lq, Lk, CK, scale, st);
    case 64: return launch_d<T, 64>(qt, kt, vt, mt, ot, pa, pm, B, H, Lq, Lk, CK, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, Lq, D), k and v (BH, Lk, D), all of one dtype, 16-byte aligned;
// mask bool (B, Lq, Lk) with B = BH / H, set = masked out; out f32
// (BH, Lq, D). D in {8, 16, 32, 64}. CK keys per chunk (a multiple of 64 up
// to 512) and NC = ceil(Lk / CK) chunks; scratch pacc f32 (NC, BH, Lq, D)
// and pml f32 (NC, BH, Lq, 2).
extern "C" int masked_attn_f32(const void* q, const void* k, const void* v, const void* mask,
                               void* out, void* pacc, void* pml, int BH, int H, int Lq, int Lk,
                               int D, int CK, float scale, void* stream) {
  return launch<float>(q, k, v, mask, out, pacc, pml, BH, H, Lq, Lk, D, CK, scale, stream);
}

extern "C" int masked_attn_bf16(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* pacc, void* pml, int BH, int H, int Lq, int Lk,
                                int D, int CK, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, mask, out, pacc, pml, BH, H, Lq, Lk, D, CK, scale,
                               stream);
}
