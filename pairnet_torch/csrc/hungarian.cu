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
// steps per problem (5,050 in a 100 x 100 problem padded to 3 valid
// columns). So the design shortens one step's dependent chain:
//   * one CTA per problem. Its 4 warps copy the cost matrix into shared
//     memory, rows padded to a multiple of S floats (when it fits; n = m =
//     256 does not, and that instantiation reads the rows from global
//     memory), then warps 1-3 leave and warp 0 solves with no barrier but
//     __syncwarp;
//   * lane l owns the contiguous columns [(31 - l) S, (32 - l) S), S the
//     least of 1, 2, 4, 8 with 32 S >= m, a template parameter: a row slice
//     is one shared-memory vector load (16 bytes at S = 4), and the ghost
//     columns past m (in the low lanes) are never available. The lane keeps
//     its columns' minv, way (as the search step that set it), v, p and
//     pu = u[p] (the potential of the row the column holds) in registers;
//   * a lane's masked values come from one compare and one select a slot
//     (the select's other side, minv or 1e18, is ready before the row
//     arrives), its least value from a tree of fminf, and the first slot
//     holding it off the chain. Then one warp reduction (__reduce_min_sync)
//     of the IEEE order as a signed key (-0 made +0, equal as `<` treats
//     them) and a ballot: the highest lane holding the least key holds the
//     first minimum, as columns fall with the lane. That lane sends delta,
//     p[j1] and pu[j1] in one round of independent shuffles: the next row
//     i0 and u[i0] arrive with the winner, with no shared-memory load or
//     select on the chain;
//   * off the chain, each step applies the plain loop's updates in its
//     order: minv -= delta on available columns, v -= delta and pu += delta
//     on used ones (a used column holds a visited row), and the inserted
//     row's u += delta. The winner lane records (j1, p[j1], way[j1]) as one
//     predicated 16-byte store into a winners list in shared memory, and
//     notes in a register whether the step was degenerate;
//   * between searches p (by column) and u (by row) live in shared memory:
//     at a search's end the visited rows' u are written back, the
//     augmenting path is walked from the winners list (p[c] = the row that
//     the step way(c) visited), and the owners reload p and pu, with no
//     branch;
//   * a degenerate search (a column whose way was never set, as a whole
//     NaN row leaves it, or a used column picked at cost 1e18) takes the
//     plain loop's walk over the columns' way; two columns may then hold
//     one row, so from then on the searches run a second copy of the step
//     loop in which u stays per row in shared memory and every visited row
//     adds each step's delta there, as the plain loop does. The final
//     inversion takes, for a row that two columns claim, the higher column,
//     as the plain loop's scatter on the CPU does.
// Each of these was kept because copies of the source without it measured
// slower on the card (PERF.md, section 6).
// No fast-math: f32 subtractions and compares as the plain loop does them.
//
// A second instance, hungarian_long_kernel, takes 256 < m <= 65536: the
// detection-only loss matches the encoder's S proposals (22,323 at
// 800x1344 with 4 levels; 37,485 at 1344x1344) against <= 100 GT boxes,
// which after the n <= m transpose is a (G, S) problem. A search step is a
// pass over all m columns, and one SM's path to L2 bounded a pass over
// state kept in global memory. So a problem runs on one thread-block
// cluster of K CTAs (16 where the card can place them, else 8, 4, 2):
//   * CTA r owns the columns [r * cs, (r + 1) * cs), cs = ceil(m / K); their
//     minv, way, v, p and used flags live in its shared memory (17 bytes a
//     column: 24 KB at m = 22,323, 70 KB at 65,536 with K = 16), thread t
//     owns the slice's columns t, t + 256, ... . A step reads only the
//     slice of cost row i0 (costs stay in global memory, read through L2);
//   * the pass applies the previous step's minv -= delta (the plain loop's
//     update, in its order: it is the next step's first use) and the
//     cur < minv update, with no branch on the used flag so that a
//     thread's loads go out together; then each warp reduces to its first
//     least (order_key, column) pair (two __reduce_min_sync), and after a
//     CTA barrier warp 0 the 8 warps' pairs to the CTA's (column, value,
//     p, way): its slot in shared memory, double buffered by step parity;
//   * one cluster barrier (barrier.cluster arrive.release / wait.acquire)
//     a step. Then warp 0 of every CTA reads the K slots through
//     distributed shared memory (a lane each), merges them the same way
//     and hands the winner to its CTA through shared memory and a CTA
//     barrier, so all CTAs agree on j1 and delta bit for bit; the slot
//     carries p[j1] (the next row i0 and the loop flag) and way[j1]. (Every
//     warp reading the slots itself, or each CTA pushing its slot to the
//     others' shared memory behind an mbarrier, measured slower: PERF.md);
//   * way is kept as the search step whose j0 improved the column, so one
//     search's winners (column, delta, p, way), replicated in every CTA's
//     shared memory (global memory past 2,048 steps), are all that the
//     augmenting walk and the potentials need: each CTA walks the path
//     locally and rewrites p of its own columns, and the updates the plain
//     loop makes every step (u += delta on visited rows, v -= delta on used
//     columns) are made once at the end of the search, each entry adding
//     the same deltas in the same order. A row is visited once a search,
//     so a step reads u[i0] as the search found it;
//   * a degenerate search (a column whose way was never set, as a whole
//     NaN row leaves it, or a used column picked at cost 1e18) walks the
//     plain loop's walk through distributed shared memory, and from then
//     on a revisited row's u and the end-of-search updates look back
//     through the winners, so even these searches end as the plain loop's.
// Each CTA keeps its own copy of u in the workspace the wrapper allocates.
// The same padding contract and bit-equal results as the plain loop; the
// same search-step bound (steps <= m) and degenerate-row handling as the
// first instance; the inversion takes the higher column for a row that two
// columns claim, as the plain loop's scatter on the CPU does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxCols = 256;              // the kernel's limit on m
constexpr int kThreads = 128;              // warps that stage the costs
constexpr int kMaxSmem = 227 * 1024;       // a CTA's shared memory, at most
constexpr float kInf = 1e18f;              // the plain loop's _INF
constexpr unsigned kFull = 0xffffffffu;

// The IEEE order of x as an unsigned order, with -0 equal to +0. x is never
// NaN here: masked values are minv entries (NaN never enters) or kInf.
__device__ __forceinline__ unsigned order_key(float x) {
  if (x == 0.0f) x = 0.0f;
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Columns a lane owns for m columns: the least of 1, 2, 4, 8 covering m.
inline int short_slots(int m) { return m <= 32 ? 1 : m <= 64 ? 2 : m <= 128 ? 4 : 8; }
// Cost row stride in shared memory: m padded to a multiple of S.
__host__ __device__ inline int short_stride(int m, int S) { return (m + S - 1) / S * S; }
// Shared memory of the short instance, in 4-byte words beside the staged
// costs: the winners list (m + 2 int4 records, first: 16-byte aligned), pS
// (m), uS (n), stamp (n), the visited rows (m + 2), the columns' ways for
// the plain walk (m); then slack for the ghost lanes' reads past the end.
__host__ __device__ inline size_t short_words(int n, int m, int S) {
  return 4 * ((size_t)m + 2) + (size_t)m + 2 * n + ((size_t)m + 2) + m + 32 * S;
}

// The short instance's shared memory.
struct ShortSmem {
  int4* rec;        // the search's winners: (column, its p, its way as a step or -2 if used)
  const float* cs;  // the staged costs, rows padded to a multiple of S
  int* pS;          // between searches: the row each column holds
  float* uS;        // between searches: u of each row (during them too, after a degenerate one)
  int* stamp;       // the search that last visited a row, + 1 (per-row u)
  int* vis;         // the rows a search visited (per-row u)
  int* wayS;        // the columns' ways, for the plain walk
};

// The key of a masked value whose signed order is the IEEE order, with -0
// made +0 (x + 0), so that -0 and +0 tie as `<` treats them. x is never
// NaN here: masked values are minv entries (NaN never enters) or kInf.
__device__ __forceinline__ int order_key_signed(float x) {
  const int b = __float_as_int(x + 0.0f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// One search, inserting row i: the steps it took. The lane's columns
// [base, base + S) keep minv, way, v, p and pu in registers; the winner's
// lane sends delta, p[j1] and pu[j1] (the next row and its u). kDup: after
// a degenerate search, u per row in uS (two columns may hold one row).
template <int S, bool kStaged, bool kDup>
__device__ __forceinline__ int short_search(const ShortSmem& sm, const float* src, int i, int m,
                                            int ms, int lane, float (&v)[S], float (&pu)[S],
                                            const int (&p)[S], unsigned& used, float& ui,
                                            bool& degen, float (&minv)[S], int (&way)[S]) {
  const int base = (31 - lane) * S;
  int i0 = i, steps = 0, nv = 0;
  float ui0 = 0.0f;
  while (true) {
    if (kDup) {  // mark i0 visited, read its u as the plain loop holds it
      const bool fresh = sm.stamp[i0] != i + 1;
      __syncwarp();
      if (fresh) {
        if (lane == 0) {
          sm.stamp[i0] = i + 1;
          sm.vis[nv] = i0;
        }
        ++nv;
      }
      ui0 = sm.uS[i0];
    }
    float c[S];
    if (kStaged) {
      const float* crow = sm.cs + (size_t)i0 * ms + base;
      if constexpr (S == 1) {
        c[0] = *crow;
      } else if constexpr (S == 2) {
        const float2 q = *reinterpret_cast<const float2*>(crow);
        c[0] = q.x;
        c[1] = q.y;
      } else {
#pragma unroll
        for (int h = 0; h < S; h += 4) {
          const float4 q = *reinterpret_cast<const float4*>(crow + h);
          c[h] = q.x;
          c[h + 1] = q.y;
          c[h + 2] = q.z;
          c[h + 3] = q.w;
        }
      }
    } else {
      const float* crow = src + (size_t)i0 * m + base;
#pragma unroll
      for (int k = 0; k < S; ++k) c[k] = base + k < m ? __ldg(crow + k) : 0.0f;
    }
    float val[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const bool avail = !((used >> k) & 1u);
      const float mm = avail ? minv[k] : kInf;
      const float cur = (c[k] - ui0) - v[k];
      const bool better = avail && cur < minv[k];
      val[k] = better ? cur : mm;
      if (better) {
        minv[k] = cur;
        way[k] = steps;
      }
    }
    float lo[S];
#pragma unroll
    for (int k = 0; k < S; ++k) lo[k] = val[k];
#pragma unroll
    for (int w = 1; w < S; w *= 2)  // the least value
#pragma unroll
      for (int k = 0; k + w < S; k += 2 * w) lo[k] = fminf(lo[k], lo[k + w]);
    int bk = 0;
#pragma unroll
    for (int k = S - 1; k >= 0; --k)  // the first slot holding it
      if (val[k] == lo[0]) bk = k;
    int bp = -1, bw = -1;
    float bpu = 0.0f, best = val[0];
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k == bk) {
        best = val[k];
        bp = p[k];
        bpu = pu[k];
        bw = way[k];
      }
    const bool bused = (used >> bk) & 1u;
    const float send_pu = bused ? bpu + best : bpu;  // a used column's row gets this delta too
    const int key = order_key_signed(lo[0]);
    const int least = __reduce_min_sync(kFull, key);
    const int wl = 31 - __clz(__ballot_sync(kFull, key == least));
    const float delta = __shfl_sync(kFull, best, wl);
    const int row = __shfl_sync(kFull, bp, wl);
    const float row_u = __shfl_sync(kFull, send_pu, wl);
    const bool won = lane == wl;
    if (won) sm.rec[steps] = make_int4(base + bk, bp, bused ? -2 : bw, 0);
    degen |= won && (bused || bw < 0);
    if (kDup) {
      __syncwarp();
      for (int t = lane; t < nv; t += 32) sm.uS[sm.vis[t]] = sm.uS[sm.vis[t]] + delta;
      __syncwarp();
    } else {
      ui = ui + delta;
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if ((used >> k) & 1u) {
        v[k] = v[k] - delta;
        pu[k] = pu[k] + delta;
      } else {
        minv[k] = minv[k] - delta;
      }
    }
    if (won) used |= 1u << bk;
    ++steps;
    i0 = row;
    ui0 = row_u;
    if (row == -1 || steps > m) return steps;
  }
}

// One problem a CTA. S: columns a lane owns; kStaged: the costs in shared
// memory (rows padded to a multiple of S), else read from global memory.
template <int S, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    hungarian_kernel(const float* __restrict__ cost, long long* __restrict__ row2col,
                     int* __restrict__ steps_out, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ms = short_stride(m, S);
  const float* src = cost + (size_t)blockIdx.x * n * m;
  ShortSmem sm;
  sm.rec = reinterpret_cast<int4*>(smem);
  float* cs = reinterpret_cast<float*>(sm.rec + (m + 2));
  sm.cs = cs;
  sm.pS = reinterpret_cast<int*>(cs + (kStaged ? (size_t)n * ms : 0));
  sm.uS = reinterpret_cast<float*>(sm.pS + m);
  sm.stamp = reinterpret_cast<int*>(sm.uS + n);
  sm.vis = sm.stamp + n;
  sm.wayS = sm.vis + (m + 2);

  if (kStaged) {
    if (ms == m && ((size_t)n * m & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(cs);
#pragma unroll 4
      for (int k = threadIdx.x; k < n * m / 4; k += kThreads) d4[k] = __ldg(s4 + k);
    } else {
      for (int k = threadIdx.x; k < n * ms; k += kThreads) {
        const int r = k / ms, c = k - r * ms;
        cs[k] = c < m ? __ldg(src + (size_t)r * m + c) : 0.0f;
      }
    }
  }
  for (int j = threadIdx.x; j < m; j += kThreads) sm.pS[j] = -1;
  for (int r = threadIdx.x; r < n; r += kThreads) {
    sm.uS[r] = 0.0f;
    sm.stamp[r] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int base = (31 - lane) * S;  // the lane's first column

  unsigned ghost = 0;  // bit k: column base + k is past m
  float v[S], pu[S];
  int p[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (base + k >= m) ghost |= 1u << k;
    v[k] = pu[k] = 0.0f;
    p[k] = -1;
  }
  int total_steps = 0;
  bool dup = false;  // after a degenerate search: u per row in uS

  for (int i = 0; i < n; ++i) {
    float minv[S];
    int way[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      minv[k] = kInf;
      way[k] = -1;  // never set: the plain loop's way of column 0
    }
    unsigned used = ghost;  // bit k: column base + k used (ghosts always)
    float ui = 0.0f;        // u of row i, the row being inserted
    bool degen = false;     // this lane's winner was degenerate
    const int steps =
        dup ? short_search<S, kStaged, true>(sm, src, i, m, ms, lane, v, pu, p, used, ui, degen,
                                             minv, way)
            : short_search<S, kStaged, false>(sm, src, i, m, ms, lane, v, pu, p, used, ui, degen,
                                              minv, way);
    __syncwarp();  // the winners list
    const bool degenerate = __any_sync(kFull, degen) || steps > m;
    if (!dup) {  // u of the visited rows: the used columns' rows and row i
#pragma unroll
      for (int k = 0; k < S; ++k)
        if ((((used & ~ghost) >> k) & 1u) && p[k] >= 0) sm.uS[p[k]] = pu[k];
      if (lane == 0) sm.uS[i] = ui;
    }
    if (degenerate) {  // the plain loop's walk over the columns' way
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (!((ghost >> k) & 1u)) sm.wayS[base + k] = way[k];
      __syncwarp();
      if (lane == 0) {
        int j = sm.rec[steps - 1].x;
        for (int s = 0; s < steps && j != m; ++s) {
          const int w = sm.wayS[j];
          const int jn = w < 0 ? 0 : (w == 0 ? m : sm.rec[w - 1].x);
          sm.pS[j] = jn == m ? i : sm.pS[jn];
          j = jn;
        }
      }
      dup = true;
    } else if (lane == 0) {  // from the winners: p[c_t] = the row step way(c_t) visited
      for (int t = steps, hops = 0; t != 0 && hops < steps; ++hops) {  // way(c_t) < t
        const int4 r = sm.rec[t - 1];
        sm.pS[r.x] = r.z == 0 ? i : sm.rec[r.z - 1].y;
        t = r.z;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < S; ++k)  // a ghost reads past pS's m entries, in bounds
      p[k] = (ghost >> k) & 1u ? -1 : sm.pS[base + k];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float uk = sm.uS[max(p[k], 0)];
      pu[k] = !dup && p[k] >= 0 ? uk : 0.0f;
    }
    total_steps += steps;
  }

  int* inv = sm.stamp;
  for (int r = lane; r < n; r += 32) inv[r] = -1;
  __syncwarp();
  for (int j = lane; j < m; j += 32)
    if (sm.pS[j] >= 0) atomicMax(&inv[sm.pS[j]], j);
  __syncwarp();
  long long* out = row2col + (size_t)blockIdx.x * n;
  for (int r = lane; r < n; r += 32) out[r] = inv[r];
  if (lane == 0) steps_out[blockIdx.x] = total_steps;
}

// Launch one instantiation with smem bytes of shared memory.
template <int S, bool kStaged>
int launch_instance(const float* cost, long long* row2col, int* steps, int B, int n, int m,
                    size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hungarian_kernel<S, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  hungarian_kernel<S, kStaged><<<B, kThreads, smem, stream>>>(cost, row2col, steps, n, m);
  return (int)cudaGetLastError();
}

// The instantiation for S slots: staged when the padded costs fit.
template <int S>
int launch_short(const float* cost, long long* row2col, int* steps, int B, int n, int m,
                 cudaStream_t stream) {
  const size_t words = short_words(n, m, S) * sizeof(int);
  const size_t staged = (size_t)n * short_stride(m, S) * sizeof(float) + words;
  if (staged <= (size_t)kMaxSmem)
    return launch_instance<S, true>(cost, row2col, steps, B, n, m, staged, stream);
  return launch_instance<S, false>(cost, row2col, steps, B, n, m, words, stream);
}

constexpr int kLongMaxCols = 65536;     // the long instance's limit on m
constexpr int kLongThreads = 256;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kMaxCluster = 16;         // CTAs a problem, at most (non-portable above 8)
constexpr int kListCap = 2048;          // search winners held in shared memory
constexpr int kChunk = 8;               // costs a thread loads before it uses them
constexpr int kLongMaxSmem = 227 * 1024;
constexpr int kWayInit = -1;            // way as the plain loop starts it: column 0
constexpr int kWayUsed = -2;            // published for a used column picked at cost kInf

// Per-CTA workspace of the long instance, in 4-byte words: u (n, padded to
// 16 bytes), then the search winners past kListCap (m + 2 int4 records: a
// search takes at most m + 1 steps).
__host__ __device__ inline size_t long_u_words(int n) { return ((size_t)n + 3) & ~(size_t)3; }
__host__ __device__ inline size_t long_cta_words(int n, int m) {
  return long_u_words(n) + 4 * ((size_t)m + 2);
}
__host__ __device__ inline size_t long_ws_words(int n, int m) {
  return (size_t)kMaxCluster * long_cta_words(n, m);
}
// Dynamic shared memory: the CTA's slot (two step parities), its warps'
// slots and the step's winner, the search's winners, then minv, way, v, p (4
// bytes a column each) and used (1 byte a column).
inline size_t long_smem_bytes(int cs, int lc) {
  return (size_t)(3 + kLongWarps + lc) * sizeof(int4) + (size_t)cs * (4 * sizeof(float) + 1);
}

// The least (order_key(value), column) of the warp's slots (column, value
// bits, p, way), column -1 for none; every lane gets it.
__device__ __forceinline__ int4 least_slot(int4 s) {
  const unsigned k = s.x >= 0 ? order_key(__int_as_float(s.y)) : 0xffffffffu;
  const unsigned c = s.x >= 0 ? (unsigned)s.x : 0xffffffffu;
  const unsigned lk = __reduce_min_sync(kFull, k);
  const unsigned lc = __reduce_min_sync(kFull, k == lk ? c : 0xffffffffu);
  const int src = __ffs(__ballot_sync(kFull, k == lk && c == lc)) - 1;
  return make_int4(__shfl_sync(kFull, s.x, src), __shfl_sync(kFull, s.y, src),
                   __shfl_sync(kFull, s.z, src), __shfl_sync(kFull, s.w, src));
}

// Winner s of the current search: (j1, delta bits, p[j1], way[j1] as a step).
__device__ __forceinline__ int4 winner(const int4* list, const int4* spill, int lc, int s) {
  return s < lc ? list[s] : __ldcg(spill + s);
}

__global__ void __launch_bounds__(kLongThreads)
    hungarian_long_kernel(const float* __restrict__ cost, long long* __restrict__ row2col,
                          int* __restrict__ steps_out, int n, int m, int K, int cs, int lc,
                          int* ws_all) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  int4* slots = reinterpret_cast<int4*>(smem);  // the CTA's least, by step parity
  int4* warp_best = slots + 2;                   // each warp's least
  int4* won = warp_best + kLongWarps;            // the step's winner
  int4* list = won + 1;
  float* minv = reinterpret_cast<float*>(list + lc);
  int* way = reinterpret_cast<int*>(minv + cs);
  float* v = reinterpret_cast<float*>(way + cs);
  int* p = reinterpret_cast<int*>(v + cs);
  unsigned char* used = reinterpret_cast<unsigned char*>(p + cs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int prob = blockIdx.x / K;
  const int base = rank * cs;
  const int cnt = max(0, min(cs, m - base));
  const float* C = cost + (size_t)prob * n * m + base;  // this CTA's slice of row 0
  int* ws = ws_all + ((size_t)prob * kMaxCluster + rank) * long_cta_words(n, m);
  float* u = reinterpret_cast<float*>(ws);
  int4* spill = reinterpret_cast<int4*>(ws + long_u_words(n));
  long long* out = row2col + (size_t)prob * n;

  for (int jj = tid; jj < cnt; jj += kLongThreads) {
    v[jj] = 0.0f;
    p[jj] = -1;
    used[jj] = 0;
  }
  for (int r = tid; r < n; r += kLongThreads) u[r] = 0.0f;
  if (rank == 0)
    for (int r = tid; r < n; r += kLongThreads) out[r] = -1;
  cluster.sync();  // the whole cluster runs, row2col is cleared before any atomicMax

  int total_steps = 0;
  unsigned gstep = 0;  // steps over all rows: the parity of the slots
  bool dup = false;    // after a degenerate walk two columns may hold one row
  for (int i = 0; i < n; ++i) {
    int i0 = i, j1 = m, steps = 0;
    float pending = 0.0f;  // the previous step's delta, owed to minv
    bool scan = dup, irregular = false;
    while (true) {
      // u[i0] as the plain loop holds it now: as the search found it, unless
      // (degenerate searches only) the row was visited earlier in this one
      float ui0 = u[i0];
      if (scan && steps > 0) {
        int f = -1;
        for (int t = 0; t < steps && f < 0; ++t)
          if ((t == 0 ? i : winner(list, spill, lc, t - 1).z) == i0) f = t;
        if (f >= 0) {
          for (int t = f; t < steps - 1; ++t)
            ui0 = ui0 + __int_as_float(winner(list, spill, lc, t).y);
          ui0 = ui0 + pending;
        }
      }
      const float* crow = C + (size_t)i0 * m;
      float best = 0.0f;
      int best_jj = -1;
      for (int c0 = 0; c0 < cnt; c0 += kLongThreads * kChunk) {
        float cv[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int jj = c0 + tid + k * kLongThreads;
          cv[k] = jj < cnt ? __ldg(crow + jj) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {  // no branch on used: every load issued at once
          const int jj = c0 + tid + k * kLongThreads;
          const bool in = jj < cnt;
          const bool avail = in && !used[jj];
          float mv = kInf;
          int wv = kWayInit;
          if (steps > 0 && in) {
            mv = minv[jj] - pending;
            wv = way[jj];
          }
          const float cur = (cv[k] - ui0) - (in ? v[jj] : 0.0f);
          if (cur < mv) {
            mv = cur;
            wv = steps;
          }
          if (avail) {
            minv[jj] = mv;
            way[jj] = wv;
          }
          const float masked = avail ? mv : kInf;  // a used column: the plain loop's masked value
          if (in && (best_jj < 0 || masked < best)) {  // strict: the first minimum, jj rising
            best = masked;
            best_jj = jj;
          }
        }
      }
      // the warp's first least (key, column), then the CTA's: its slot
      const unsigned key = best_jj >= 0 ? order_key(best) : 0xffffffffu;
      const unsigned gcol = best_jj >= 0 ? (unsigned)(base + best_jj) : 0xffffffffu;
      const unsigned least = __reduce_min_sync(kFull, key);
      const unsigned col = __reduce_min_sync(kFull, key == least ? gcol : 0xffffffffu);
      if (col == 0xffffffffu) {
        if (lane == 0) warp_best[warp] = make_int4(-1, 0, 0, 0);  // no column
      } else if (key == least && gcol == col) {
        warp_best[warp] = make_int4(
            (int)col, __float_as_int(best), p[best_jj], used[best_jj] ? kWayUsed : way[best_jj]);
      }
      __syncthreads();
      const unsigned par = gstep & 1u;
      if (warp == 0) {
        const int4 s = lane < kLongWarps ? warp_best[lane] : make_int4(-1, 0, 0, 0);
        const int4 w = least_slot(s);
        if (lane == 0) slots[par] = w;
      }
      cluster.sync();
      // warp 0 merges the cluster's K slots (the same winner in every CTA)
      if (warp == 0) {
        const int4 w = least_slot(lane < K ? *cluster.map_shared_rank(slots + par, (unsigned)lane)
                                           : make_int4(-1, 0, 0, 0));
        if (lane == 0) *won = w;
      }
      __syncthreads();
      const int4 win = *won;
      j1 = win.x;
      const int delta_bits = win.y;
      const int prow = win.z;
      const int wstep = win.w;

      const int jj1 = j1 - base;  // mark j1 used: its owner thread
      if (jj1 >= 0 && jj1 < cnt && jj1 % kLongThreads == tid) used[jj1] = 1;
      if (tid == 0) {
        const int4 rec = make_int4(j1, delta_bits, prow, wstep);
        if (steps < lc) {
          list[steps] = rec;
        } else {
          __stcg(spill + steps, rec);
        }
      }
      if (wstep < 0) scan = irregular = true;
      pending = __int_as_float(delta_bits);
      ++steps;
      ++gstep;
      i0 = prow;
      if (prow == -1 || steps > m) break;
    }
    __syncthreads();  // the last winner and the column state, CTA-wide

    // augment: walk way back to the virtual column, shifting matches
    if (irregular || steps > m) {
      cluster.sync();  // every CTA's way and p final
      if (rank == 0 && tid == 0) {  // the plain loop's walk, through DSMEM
        int j = j1;
        for (int s = 0; s < steps && j != m; ++s) {
          const int r = j / cs;
          const int w = cluster.map_shared_rank(way, (unsigned)r)[j - r * cs];
          const int jn = w < 0 ? 0 : (w == 0 ? m : winner(list, spill, lc, w - 1).x);
          const int rn = jn / cs;
          const int pv = jn == m ? i : cluster.map_shared_rank(p, (unsigned)rn)[jn - rn * cs];
          cluster.map_shared_rank(p, (unsigned)r)[j - r * cs] = pv;
          j = jn;
        }
      }
      cluster.sync();
      dup = true;
    } else if (tid == 0) {  // the path from the winners: p[c_t] = the row of step way(c_t)
      for (int t = steps, hops = 0; t != 0 && hops < steps; ++hops) {  // way(c_t) < t
        const int4 rec = winner(list, spill, lc, t - 1);
        const int jj = rec.x - base;
        if (jj >= 0 && jj < cnt) p[jj] = rec.w == 0 ? i : winner(list, spill, lc, rec.w - 1).z;
        t = rec.w;
      }
    }
    // v -= delta on the columns used from step t on (the column step t - 1
    // picked), u += delta on the rows visited from step t on: the plain
    // loop's per-step updates, made now in its order
    for (int t = 1 + tid; t < steps; t += kLongThreads) {
      const int c = winner(list, spill, lc, t - 1).x;
      const int jj = c - base;
      if (jj < 0 || jj >= cnt) continue;
      bool seen = false;
      for (int t2 = 0; scan && t2 < t - 1 && !seen; ++t2) seen = winner(list, spill, lc, t2).x == c;
      if (seen) continue;
      float vv = v[jj];
      for (int s = t; s < steps; ++s) vv = vv - __int_as_float(winner(list, spill, lc, s).y);
      v[jj] = vv;
    }
    for (int t = tid; t < steps; t += kLongThreads) {
      const int r = t == 0 ? i : winner(list, spill, lc, t - 1).z;
      bool seen = false;
      for (int t2 = 0; scan && t2 < t && !seen; ++t2)
        seen = (t2 == 0 ? i : winner(list, spill, lc, t2 - 1).z) == r;
      if (seen) continue;
      float uu = u[r];
      for (int s = t; s < steps; ++s) uu = uu + __int_as_float(winner(list, spill, lc, s).y);
      u[r] = uu;
    }
    for (int t = tid; t < steps; t += kLongThreads) {
      const int jj = winner(list, spill, lc, t).x - base;
      if (jj >= 0 && jj < cnt) used[jj] = 0;
    }
    total_steps += steps;
    __syncthreads();
  }

  for (int jj = tid; jj < cnt; jj += kLongThreads)
    if (p[jj] >= 0) atomicMax(out + p[jj], (long long)(base + jj));
  if (rank == 0 && tid == 0) steps_out[prob] = total_steps;
  cluster.sync();  // no CTA leaves while another may still read its slots
}

// The long instance's cluster for B problems of m columns: the largest K of
// 16, 8, 4, 2 whose cluster, with its shared memory, the card can place
// (cudaOccupancyMaxActiveClusters). Fills cfg and attr for the launch and
// returns K, or 0 when no cluster fits.
int long_cluster(int B, int m, int lc, cudaStream_t stream, cudaLaunchAttribute* attr,
                 cudaLaunchConfig_t* cfg) {
  for (int K = kMaxCluster; K >= 2; K /= 2) {
    const size_t smem = long_smem_bytes((m + K - 1) / K, lc);
    if (smem > (size_t)kLongMaxSmem) continue;
    if (cudaFuncSetAttribute(hungarian_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        (K > 8 && cudaFuncSetAttribute(hungarian_long_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed,
                                       1) != cudaSuccess)) {
      (void)cudaGetLastError();
      continue;
    }
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)K;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)(B * K));
    cfg->blockDim = dim3(kLongThreads);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, hungarian_long_kernel, cfg) == cudaSuccess &&
        clusters > 0)
      return K;
    (void)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// cost f32 (B, n, m) contiguous, 1 <= n <= m <= 256 (PAD_COST-padded and
// clipped by the wrapper); row2col int64 (B, n): the column of each row;
// steps int32 (B,): the search steps each problem took, over all its rows.
extern "C" int hungarian_solve(const void* cost, void* row2col, void* steps, int B, int n,
                               int m, void* stream) {
  if (B < 1 || n < 1 || n > m || m > kMaxCols) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cost);
  long long* r = static_cast<long long*>(row2col);
  int* s = static_cast<int*>(steps);
  cudaStream_t st = (cudaStream_t)stream;
  switch (short_slots(m)) {
    case 1: return launch_short<1>(c, r, s, B, n, m, st);
    case 2: return launch_short<2>(c, r, s, B, n, m, st);
    case 4: return launch_short<4>(c, r, s, B, n, m, st);
    default: return launch_short<8>(c, r, s, B, n, m, st);
  }
}

// The workspace words per problem of hungarian_solve_long.
extern "C" long long hungarian_long_workspace(int n, int m) {
  return (long long)long_ws_words(n, m);
}

// As hungarian_solve, for 1 <= n <= m <= 65536: the long instance, one
// cluster of K CTAs per problem (hungarian_long_cluster). ws is
// B * hungarian_long_workspace(n, m) 4-byte words of device memory, which
// the kernel initializes itself. Returns cudaErrorInvalidConfiguration,
// launching nothing, when no cluster fits.
extern "C" int hungarian_solve_long(const void* cost, void* row2col, void* steps, int B, int n,
                                    int m, void* ws, void* stream) {
  if (B < 1 || n < 1 || n > m || m > kLongMaxCols) return (int)cudaErrorInvalidValue;
  const int lc = m + 2 < kListCap ? m + 2 : kListCap;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const int K = long_cluster(B, m, lc, (cudaStream_t)stream, &attr, &cfg);
  if (K == 0) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, hungarian_long_kernel, static_cast<const float*>(cost),
      static_cast<long long*>(row2col), static_cast<int*>(steps), n, m, K, (m + K - 1) / K, lc,
      static_cast<int*>(ws));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The cluster size hungarian_solve_long launches for m columns, 0 if none fits.
extern "C" int hungarian_long_cluster(int m) {
  if (m < 1 || m > kLongMaxCols) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  return long_cluster(1, m, m + 2 < kListCap ? m + 2 : kListCap, nullptr, &attr, &cfg);
}
