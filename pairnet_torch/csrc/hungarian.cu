// Batched linear sum assignment: the Jonker-Volgenant shortest augmenting
// path of the train step's two matchers, solved wholly on the card.
//
// Stands for the JAX package's device-resident solver
// pairnet_tpu/ops/hungarian.py::_solve_n_le_m (a lax.while_loop under jit
// and vmap, which never returns to the host). It is not a pl.pallas_call
// site. Without a kernel the PyTorch loop reads its loop flag on the host
// once per search step (~530 host syncs per train step).
//
// Computes, per problem, exactly what the plain loop
// (pairnet_torch/ops/hungarian.py::solve_n_le_m_plain) computes, in its
// order and rounding, so row2col is the same bit for bit:
//   for each row i: p[m] = i, minv = 1e18, way = 0, j0 = m, then do
//     used[j0] = 1; i0 = p[j0]; row_used[i0] = 1
//     cur_j = (cost[i0, j] - u[i0]) - v[j]
//     on available columns (not used): if cur_j < minv_j (IEEE: a NaN
//       never enters minv) then minv_j = cur_j, way_j = j0
//     masked_j = avail ? minv_j : 1e18; j1 = the FIRST column of the least
//       masked_j; delta = masked_j1
//     u += delta on used rows, v -= delta on used columns,
//     minv -= delta on available columns; j0 = j1
//   while p[j0] != -1; then walk way back to the virtual column m,
//   shifting the matches, and clear p[m].
// A search step marks one column used, so a row takes at most m + 1 steps:
// the loop is bounded there, which only a degenerate row (all NaN costs)
// reaches. The augmenting walk is bounded by the row's search steps, as
// the plain loop bounds it.
//
// Bound on an H100: neither bytes nor operations but the serial chain of
// search steps (each one depends on the previous step's argmin). At the
// step's shapes (4 problems of 64 x 100 and of 100 x 100) the costs are
// 102-160 KB, 0.03-0.05 us at 3.35 TB/s, against a few hundred dependent
// steps per problem. So the design shortens one step:
//   * one CTA per problem. Its 4 warps copy the cost matrix into shared
//     memory (when it fits in 200 KB; otherwise the rows are read from
//     global memory through the same pointer), then warps 1-3 leave and
//     warp 0 solves with no barrier but __syncwarp;
//   * lane l owns columns l, l + 32, ... (up to 8 at m <= 256): their minv,
//     way, v and used bits live in registers; it also owns rows l, l + 32,
//     ... (u and row_used in registers); p lives in shared memory;
//   * the argmin is two warp reductions (__reduce_min_sync): the least key
//     of the lanes' first minima, the IEEE order mapped to unsigned with
//     -0 and +0 made equal (as `<` treats them), then the lowest column
//     holding it, which keeps the first-minimum order; delta is read from
//     the owning lane, bit for bit;
//   * the augmenting walk reads way[j0] from its owner by a shuffle; lane 0
//     writes p. The final inversion takes, for a row that two columns claim
//     (a degenerate row), the higher column, as the plain loop's scatter
//     on the CPU does.
// No fast-math: f32 subtractions and compares as the plain loop does them.
//
// A second instance, hungarian_long_kernel, takes 256 < m <= 65536: the
// detection-only loss matches the encoder's S proposals (22,323 at
// 800x1344 with 4 levels; 37,485 at 1344x1344) against <= 100 GT boxes,
// which after the n <= m transpose is a (G, S) problem. The columns no
// longer fit in a warp's registers, so:
//   * one CTA of 1024 threads per problem; the costs are read from global
//     memory (a 64 x 22,323 problem is 5.7 MB, which the 50 MB L2 holds),
//     the column state (minv, way, v, used, p) lives in a global workspace
//     the wrapper allocates, the potentials u of the rows too;
//   * thread t owns columns t, t + 1024, ...; a search step is one pass
//     over them that also applies the previous step's minv -= delta (the
//     plain loop's update, in its order: it is the next step's first use),
//     then a block-wide argmin that keeps the first minimum: each thread's
//     first least key, the warps' least (key, column) by two
//     __reduce_min_sync, then warp 0 over the 32 warps the same way;
//   * u += delta and v -= delta touch only the rows and columns this
//     search visited, kept in a list (a search visits one of each a step),
//     so a step costs one pass over m plus O(steps);
//   * used flags are cleared through the visited list at the end of a
//     row, minv and way are reset by the first pass of each row.
// The same padding contract and bit-equal results as the plain loop; the
// same search-step bound and degenerate-row handling as the first instance.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxCols = 256;              // the kernel's limit on m
constexpr int kSlots = kMaxCols / 32;      // columns (and rows) a lane owns
constexpr int kThreads = 128;              // warps that stage the costs
constexpr int kMaxSmem = 200 * 1024;       // staged costs, at most
constexpr float kInf = 1e18f;              // the plain loop's _INF
constexpr unsigned kFull = 0xffffffffu;

// The IEEE order of x as an unsigned order, with -0 equal to +0. x is never
// NaN here: masked values are minv entries (NaN never enters) or kInf.
__device__ __forceinline__ unsigned order_key(float x) {
  if (x == 0.0f) x = 0.0f;
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
    hungarian_kernel(const float* __restrict__ cost, long long* __restrict__ row2col,
                     int* __restrict__ steps_out, int n, int m, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t nm = (size_t)n * m;
  const float* src = cost + (size_t)blockIdx.x * nm;
  float* cs = reinterpret_cast<float*>(smem);
  int* p = reinterpret_cast<int*>(smem + (staged ? nm * sizeof(float) : 0));  // m + 1
  int* inv = p + (m + 1);                                                      // n

  if (staged) {
    if ((nm & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(cs);
#pragma unroll 4
      for (size_t k = threadIdx.x; k < nm / 4; k += kThreads) d4[k] = __ldg(s4 + k);
    } else {
#pragma unroll 4
      for (size_t k = threadIdx.x; k < nm; k += kThreads) cs[k] = __ldg(src + k);
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const float* C = staged ? cs : src;
  const int lane = threadIdx.x;

  for (int j = lane; j <= m; j += 32) p[j] = -1;
  for (int r = lane; r < n; r += 32) inv[r] = -1;
  float u[kSlots], v[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) u[k] = v[k] = 0.0f;
  int total_steps = 0;
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    if (lane == 0) p[m] = i;
    __syncwarp();
    float minv[kSlots];
    int way[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      minv[k] = kInf;
      way[k] = 0;
    }
    unsigned used = 0, row_used = 0;  // bit k: column / row lane + 32k
    int j0 = m, steps = 0;
    do {
      if (j0 < m && (j0 & 31) == lane) used |= 1u << (j0 >> 5);
      const int i0 = p[j0];
      if ((i0 & 31) == lane) row_used |= 1u << (i0 >> 5);
      float u_own = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (k == (i0 >> 5)) u_own = u[k];
      const float ui0 = __shfl_sync(kFull, u_own, i0 & 31);
      const float* crow = C + (size_t)i0 * m;
      float best = __int_as_float(0x7f800000);  // +inf: above every masked value
      int best_j = INT_MAX;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = lane + 32 * k;
        if (j < m) {
          const bool avail = !((used >> k) & 1u);
          const float cur = (crow[j] - ui0) - v[k];
          if (avail && cur < minv[k]) {
            minv[k] = cur;
            way[k] = j0;
          }
          const float masked = avail ? minv[k] : kInf;
          if (masked < best) {  // strict: the first minimum, j rising with k
            best = masked;
            best_j = j;
          }
        }
      }
      const unsigned key = order_key(best);
      const unsigned least = __reduce_min_sync(kFull, key);
      const int j1 = (int)__reduce_min_sync(kFull, key == least ? (unsigned)best_j : 0xffffffffu);
      const float delta = __shfl_sync(kFull, best, j1 & 31);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if ((row_used >> k) & 1u) u[k] = u[k] + delta;
        if (lane + 32 * k < m) {
          if ((used >> k) & 1u) {
            v[k] = v[k] - delta;
          } else {
            minv[k] = minv[k] - delta;
          }
        }
      }
      j0 = j1;
      ++steps;
    } while (p[j0] != -1 && steps <= m);

    // augment: walk way back to the virtual column, shifting matches
    for (int s = 0; s < steps && j0 != m; ++s) {
      int w_own = 0;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (k == (j0 >> 5)) w_own = way[k];
      const int j1 = __shfl_sync(kFull, w_own, j0 & 31);
      if (lane == 0) p[j0] = p[j1];
      __syncwarp();
      j0 = j1;
    }
    if (lane == 0) p[m] = -1;
    __syncwarp();
    total_steps += steps;
  }

  for (int j = lane; j < m; j += 32)
    if (p[j] >= 0) atomicMax(&inv[p[j]], j);
  __syncwarp();
  long long* out = row2col + (size_t)blockIdx.x * n;
  for (int r = lane; r < n; r += 32) out[r] = inv[r];
  if (lane == 0) steps_out[blockIdx.x] = total_steps;
}

constexpr int kLongMaxCols = 65536;       // the long instance's limit on m
constexpr int kLongThreads = 1024;
constexpr int kLongWarps = kLongThreads / 32;

// Per-problem workspace of the long instance, in 4-byte words: minv (m),
// way (m), v (m + 1), used (m), p (m + 1), u (n), visited rows and
// columns (m + 2 each: a search takes at most m + 1 steps), inverse map (n).
__host__ __device__ inline size_t long_ws_words(int n, int m) {
  return 7 * (size_t)m + 6 + 2 * (size_t)n;
}

__global__ void __launch_bounds__(kLongThreads)
    hungarian_long_kernel(const float* __restrict__ cost, long long* __restrict__ row2col,
                          int* __restrict__ steps_out, int n, int m, int* __restrict__ ws_all) {
  __shared__ unsigned warp_key[kLongWarps];
  __shared__ int warp_col[kLongWarps];
  __shared__ float warp_val[kLongWarps];
  __shared__ int sh_j1, sh_i0, sh_nrows, sh_ncols, sh_go;
  __shared__ float sh_delta, sh_ui0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* C = cost + (size_t)blockIdx.x * n * m;
  int* ws = ws_all + (size_t)blockIdx.x * long_ws_words(n, m);
  float* minv = reinterpret_cast<float*>(ws);
  int* way = ws + m;
  float* v = reinterpret_cast<float*>(ws + 2 * (size_t)m);
  int* used = ws + 3 * (size_t)m + 1;
  int* p = ws + 4 * (size_t)m + 1;
  float* u = reinterpret_cast<float*>(ws + 5 * (size_t)m + 2);
  int* vrows = ws + 5 * (size_t)m + 2 + n;
  int* vcols = vrows + m + 2;
  int* inv = vcols + m + 2;

  for (int j = tid; j <= m; j += kLongThreads) {
    p[j] = -1;
    v[j] = 0.0f;
    if (j < m) used[j] = 0;
  }
  for (int r = tid; r < n; r += kLongThreads) {
    u[r] = 0.0f;
    inv[r] = -1;
  }
  int total_steps = 0;
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (tid == 0) {
      p[m] = i;
      sh_nrows = 0;
      sh_ncols = 0;
    }
    int j0 = m, steps = 0;
    float pending = 0.0f;  // the previous step's delta, owed to minv
    __syncthreads();
    while (true) {
      // mark j0 used, visit its row
      if (tid == 0) {
        if (j0 < m) used[j0] = 1;
        vcols[sh_ncols++] = j0;
        const int i0 = p[j0];
        vrows[sh_nrows++] = i0;
        sh_i0 = i0;
        sh_ui0 = u[i0];
      }
      __syncthreads();
      const int i0 = sh_i0;
      const float ui0 = sh_ui0;
      const float* crow = C + (size_t)i0 * m;
      float best = __int_as_float(0x7f800000);
      int best_j = INT_MAX;
      for (int j = tid; j < m; j += kLongThreads) {
        float masked = kInf;  // a used column: the plain loop's masked value
        if (!used[j]) {
          float mv;
          int wv;
          if (steps == 0) {
            mv = kInf;
            wv = 0;
          } else {
            mv = minv[j] - pending;
            wv = way[j];
          }
          const float cur = (__ldg(crow + j) - ui0) - v[j];
          if (cur < mv) {
            mv = cur;
            wv = j0;
          }
          minv[j] = mv;
          way[j] = wv;
          masked = mv;
        }
        if (masked < best) {  // strict: the first minimum, j rising
          best = masked;
          best_j = j;
        }
      }
      const unsigned key = order_key(best);
      const unsigned least = __reduce_min_sync(kFull, key);
      const unsigned col = __reduce_min_sync(kFull, key == least ? (unsigned)best_j : 0xffffffffu);
      if (lane == 0) {
        warp_key[warp] = least;
        warp_col[warp] = (int)col;
      }
      if (key == least && (unsigned)best_j == col) warp_val[warp] = best;
      __syncthreads();
      if (warp == 0) {
        const unsigned k2 = warp_key[lane];
        const unsigned l2 = __reduce_min_sync(kFull, k2);
        const unsigned c2 = __reduce_min_sync(kFull, k2 == l2 ? (unsigned)warp_col[lane]
                                                              : 0xffffffffu);
        if (k2 == l2 && (unsigned)warp_col[lane] == c2) {  // delta bit for bit
          sh_j1 = (int)c2;
          sh_delta = warp_val[lane];
        }
      }
      __syncthreads();
      const int j1 = sh_j1;
      const float delta = sh_delta;
      const int nr = sh_nrows, nc = sh_ncols;
      for (int k = tid; k < nr; k += kLongThreads) u[vrows[k]] = u[vrows[k]] + delta;
      for (int k = tid; k < nc; k += kLongThreads) v[vcols[k]] = v[vcols[k]] - delta;
      pending = delta;
      j0 = j1;
      ++steps;
      if (tid == 0) sh_go = p[j0] != -1 && steps <= m;
      __syncthreads();
      if (!sh_go) break;
    }

    // augment: walk way back to the virtual column, shifting matches
    if (tid == 0) {
      for (int s = 0; s < steps && j0 != m; ++s) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
      p[m] = -1;
    }
    // clear the used flags of this search's columns
    const int nc = sh_ncols;
    for (int k = tid; k < nc; k += kLongThreads)
      if (vcols[k] < m) used[vcols[k]] = 0;
    total_steps += steps;
    __syncthreads();
  }

  for (int j = tid; j < m; j += kLongThreads)
    if (p[j] >= 0) atomicMax(&inv[p[j]], j);
  __syncthreads();
  long long* out = row2col + (size_t)blockIdx.x * n;
  for (int r = tid; r < n; r += kLongThreads) out[r] = inv[r];
  if (tid == 0) steps_out[blockIdx.x] = total_steps;
}

}  // namespace

// cost f32 (B, n, m) contiguous, 1 <= n <= m <= 256 (PAD_COST-padded and
// clipped by the wrapper); row2col int64 (B, n): the column of each row;
// steps int32 (B,): the search steps each problem took, over all its rows.
extern "C" int hungarian_solve(const void* cost, void* row2col, void* steps, int B, int n,
                               int m, void* stream) {
  if (B < 1 || n < 1 || n > m || m > kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t idx_bytes = (size_t)(m + 1 + n) * sizeof(int);
  const size_t cost_bytes = (size_t)n * m * sizeof(float);
  const int staged = cost_bytes + idx_bytes <= (size_t)kMaxSmem;
  const size_t smem = (staged ? cost_bytes : 0) + idx_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  hungarian_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<long long*>(row2col),
      static_cast<int*>(steps), n, m, staged);
  return (int)cudaGetLastError();
}

// The workspace words per problem of hungarian_solve_long.
extern "C" long long hungarian_long_workspace(int n, int m) {
  return (long long)long_ws_words(n, m);
}

// As hungarian_solve, for 1 <= n <= m <= 65536: the long instance. ws is
// B * hungarian_long_workspace(n, m) 4-byte words of device memory, which
// the kernel initializes itself.
extern "C" int hungarian_solve_long(const void* cost, void* row2col, void* steps, int B, int n,
                                    int m, void* ws, void* stream) {
  if (B < 1 || n < 1 || n > m || m > kLongMaxCols) return (int)cudaErrorInvalidValue;
  hungarian_long_kernel<<<B, kLongThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<long long*>(row2col),
      static_cast<int*>(steps), n, m, static_cast<int*>(ws));
  return (int)cudaGetLastError();
}
