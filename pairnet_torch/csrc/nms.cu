// Greedy non-maximum suppression over boxes already sorted by score: the
// RPN's proposal NMS and the detection head's class-offset NMS of the
// two-stage Panoptic FPN detector, both on the card.
//
// Stands for the JAX package's pairnet_tpu/ops/nms.py::nms, a lax.fori_loop
// of N steps under jit (not a pl.pallas_call site). In eager PyTorch that
// loop is N iterations of several launches each (the RPN's N = 4,819 boxes
// an image at 800x1344: tens of thousands of launches a forward).
//
// Computes, per image, exactly what the plain sweep
// (pairnet_torch/ops/nms.py::nms_sorted_plain) computes:
//   keep[i] = valid[i] && !suppressed[i], for i = 0 .. N-1 in order;
//   a kept box i suppresses every j with IoU(i, j) > thr,
// with the IoU of ops/boxes.py::box_iou in its operation order and rounding:
//   inter = max(min(ax1, bx1) - max(ax0, bx0), 0) * max(min(ay1, by1) - max(ay0, by0), 0)
//   union = (area(a) + area(b)) - inter,  area = max(x1 - x0, 0) * max(y1 - y0, 0)
//   iou = inter / max(union, 1e-7)
// Every product, sum and quotient is an explicit round-to-nearest intrinsic,
// so nvcc contracts nothing into an FMA and the keep mask is the plain
// version's bit for bit. (Only on NaN coordinates could fmaxf/fminf differ
// from torch.maximum/minimum, which propagate NaN.)
//
// Bound on an H100: neither bytes (N * 20 bytes an image: 0.03 us at
// 3.35 TB/s) nor operations, but the serial chain of the sweep: box i is
// kept or not only after every earlier kept box has swept over it. So the
// IoUs leave the chain, and what stays in it is bit tests:
//   * nms_mask_kernel computes, for every pair, whether a box suppresses a
//     later one: grid (column block, row block, image) of 64-box blocks,
//     the upper triangle only; the CTA's 64 column boxes in shared memory,
//     thread k takes row box i = 64 * rb + k and writes one 64-bit word,
//     bit c set when j = 64 * cb + c > i and IoU(i, j) > thr (box_iou
//     below: every compare is the plain sweep's). Only pairs that overlap
//     take the divide; the others' IoU is +-0, as box_iou gives them. The
//     words are scratch the wrapper allocates: B * N * ceil(N / 64) of
//     them (5.9 MB at the RPN's 2 x 4,819 boxes; 18.9 MB an image at
//     N = 12,288);
//   * nms_sweep_kernel, one CTA of 1024 threads an image, keeps a removed
//     bit per box in shared memory, starting from ~valid (an invalid box is
//     never kept and suppresses nothing) with the bits past N set, and the
//     diagonal words (row i's word of its own block) beside it. For each
//     64-box block t, warp 0 resolves the block's diagonal: lane l holds
//     the diagonal words of rows l and l + 32, and a round ORs the words of
//     the rows kept so far (two warp reductions) and keeps the candidates
//     they leave, from kept = all candidates until nothing changes. A word
//     only suppresses later boxes, so after r rounds boxes 0 .. r - 1 are
//     decided as the greedy sweep decides them: the fixed point is the
//     greedy sweep's, reached in at most 64 rounds (as many as the longest
//     chain of suppressions in the block, plus one). Its lanes write keep.
//     One barrier publishes the kept bits; then the other 31 warps OR the
//     kept rows' words into the removed words from t + 2 on (thread (g, w):
//     the 16 rows of quarter g at word w, loaded before the barrier, then a
//     shared atomicOr), while warp 0 ORs the kept rows' words at t + 1
//     (loaded the same way) by a warp reduction and goes on to block
//     t + 1. The next barrier closes those ORs. So the sweep takes
//     ceil(N / 64) barriers an image (76 at N = 4,819), one more after its
//     setup, instead of one a kept box.
// One call of nms_sorted is these two launches on the stream. No host sync.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBoxes = 12288;  // the sweep's (N + N / 64) words of shared memory <= 227 KB
constexpr int kBits = 64;          // boxes a mask word covers
constexpr int kSweepThreads = 1024;
constexpr int kWordSlots = 248;    // words the 31 OR warps cover at once (>= 12288 / 64)
constexpr int kGroupRows = kBits / ((kSweepThreads - 32) / kWordSlots);  // rows a thread ORs: 16
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float box_inter(float4 a, float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  return __fmul_rn(w, h);
}

__device__ __forceinline__ float box_iou(float4 a, float4 b) {
  const float inter = box_inter(a, b);
  const float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-7f));
}

__global__ void __launch_bounds__(kBits)
    nms_mask_kernel(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask,
                    int n, int words, float thr) {
  const int cb = blockIdx.x, rb = blockIdx.y;
  if (cb < rb) return;  // the lower triangle: never read
  __shared__ float4 cols[kBits];
  const size_t base = (size_t)blockIdx.z * n;
  const int j = cb * kBits + threadIdx.x;
  if (j < n) cols[threadIdx.x] = boxes[base + j];
  __syncthreads();
  const int i = rb * kBits + threadIdx.x;
  if (i >= n) return;
  const float4 a = boxes[base + i];
  const int jn = min(kBits, n - cb * kBits);
  const int k0 = cb == rb ? threadIdx.x + 1 : 0;
  // the pairs that overlap (inter != 0, NaN included) take the divide; the
  // others have IoU +-0, which box_iou returns for them bit for bit
  unsigned long long cand = 0, flat = 0;
  for (int k = k0; k < jn; ++k) {
    if (box_inter(a, cols[k]) != 0.0f) {
      cand |= 1ull << k;
    } else {
      flat |= 1ull << k;
    }
  }
  unsigned long long bits = 0.0f > thr ? flat : 0ull;
  while (cand) {
    const int k = __ffsll((long long)cand) - 1;
    cand &= cand - 1;
    if (box_iou(a, cols[k]) > thr) bits |= 1ull << k;
  }
  mask[(base + i) * words + cb] = bits;
}

// One CTA an image. Warp 0 resolves each block's diagonal (by rounds) and,
// from the kept rows' words it loaded, the next block's removed word; the other
// warps OR the kept rows into the words after that. Block t's barrier
// publishes kept_t and closes the ORs of block t - 1, so warp 0 reads
// removed[t + 1] complete but for block t's share, which it adds itself.
__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                     const unsigned char* __restrict__ valid, unsigned char* __restrict__ keep,
                     int n, int words) {
  extern __shared__ unsigned long long sweep_smem[];
  unsigned long long* removed = sweep_smem;    // words: a bit per box
  unsigned long long* kept_at = removed + words;  // 2: block t's kept bits, by parity
  unsigned long long* diag = kept_at + 2;      // words * 64: each box's word of its own block
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t base = (size_t)blockIdx.x * n;
  const unsigned long long* M = mask + base * words;
  unsigned* removed32 = reinterpret_cast<unsigned*>(removed);  // a warp's 32 boxes a half word
  for (int i = tid; i < words * kBits; i += kSweepThreads) {
    const unsigned gone = __ballot_sync(kFull, i >= n || !valid[base + i]);
    if (lane == 0) removed32[i / 32] = gone;
    diag[i] = i < n ? M[(size_t)i * words + i / kBits] : 0ull;
  }
  __syncthreads();
  // the OR warps: thread (g, slot) takes rows [16 g, 16 g + 16) of a block at word t + 2 + slot
  const int worker = tid - 32;
  const int g = worker / kWordSlots, slot = worker % kWordSlots;
  unsigned long long cur = removed[0];  // warp 0: block t's removed word, complete
  for (int t = 0; t < words; ++t) {
    const int r0 = t * kBits;
    const bool next = t + 1 < words;
    const int w = t + 2 + slot;  // an OR thread's word
    const int rg = r0 + g * kGroupRows;
    // words of block t's rows, loaded before its kept rows are known: warp 0
    // two rows at word t + 1 a lane, an OR thread its 16 rows at word w
    unsigned long long later[kGroupRows];
    if (tid < 32) {
      later[0] = next && r0 + lane < n ? M[(size_t)(r0 + lane) * words + t + 1] : 0ull;
      later[1] = next && r0 + 32 + lane < n ? M[(size_t)(r0 + 32 + lane) * words + t + 1] : 0ull;
      // the block's kept boxes: the fixed point of kept = cand & ~(the OR of
      // the kept rows' diagonal words), reached by rounds of two warp
      // reductions from kept = cand. A diagonal word only suppresses later
      // boxes, so after round r boxes 0 .. r - 1 are decided as the greedy
      // sweep decides them, and the fixed point is the greedy sweep's
      const unsigned long long d0 = diag[r0 + lane], d1 = diag[r0 + 32 + lane];
      const unsigned long long cand = ~cur;  // bits past n are set in cur: never kept
      unsigned long long kept = cand;
      for (int round = 0; round < kBits; ++round) {
        const unsigned long long mine = ((kept >> lane) & 1ull ? d0 : 0ull) |
                                        ((kept >> (32 + lane)) & 1ull ? d1 : 0ull);
        const unsigned lo = __reduce_or_sync(kFull, (unsigned)mine);
        const unsigned hi = __reduce_or_sync(kFull, (unsigned)(mine >> 32));
        const unsigned long long now = cand & ~(((unsigned long long)hi << 32) | lo);
        if (now == kept) break;
        kept = now;
      }
      if (lane == 0) kept_at[t & 1] = kept;
      if (r0 + lane < n) keep[base + r0 + lane] = (unsigned char)((kept >> lane) & 1ull);
      if (r0 + 32 + lane < n)
        keep[base + r0 + 32 + lane] = (unsigned char)((kept >> (32 + lane)) & 1ull);
    } else {
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r)
        later[r] = (w < words && rg + r < n) ? M[(size_t)(rg + r) * words + w] : 0ull;
    }
    __syncthreads();  // kept_t published; the ORs of block t - 1 done
    const unsigned long long kept = kept_at[t & 1];
    if (tid < 32) {
      if (next) {
        const unsigned long long own = ((kept >> lane) & 1ull ? later[0] : 0ull) |
                                       ((kept >> (32 + lane)) & 1ull ? later[1] : 0ull);
        const unsigned lo = __reduce_or_sync(kFull, (unsigned)own);
        const unsigned hi = __reduce_or_sync(kFull, (unsigned)(own >> 32));
        cur = removed[t + 1] | ((unsigned long long)hi << 32) | lo;
      }
    } else if (w < words && kept) {
      const unsigned q = (unsigned)(kept >> (g * kGroupRows)) & ((1u << kGroupRows) - 1u);
      unsigned long long acc = 0;
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r)
        if ((q >> r) & 1u) acc |= later[r];
      if (acc) atomicOr(&removed[w], acc);
    }
  }
}

}  // namespace

// The largest N an image may have.
extern "C" int nms_max_boxes() { return kMaxBoxes; }

// Bytes of the scratch nms_sorted needs for B images of n boxes: the
// pairwise suppression words.
extern "C" long long nms_scratch_bytes(int B, int n) {
  const long long words = (n + kBits - 1) / kBits;
  return (long long)B * n * words * (long long)sizeof(unsigned long long);
}

// The mask kernel alone: boxes f32 (B, N, 4) into scratch.
extern "C" int nms_mask(const void* boxes, void* scratch, int B, int n, float thr, void* stream) {
  if (B < 1 || n < 1 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  const int words = (n + kBits - 1) / kBits;
  nms_mask_kernel<<<dim3(words, words, B), kBits, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(boxes), static_cast<unsigned long long*>(scratch), n, words, thr);
  return (int)cudaGetLastError();
}

// The sweep alone: the words nms_mask wrote and valid into keep.
extern "C" int nms_sweep(const void* scratch, const void* valid, void* keep, int B, int n,
                         void* stream) {
  if (B < 1 || n < 1 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  const int words = (n + kBits - 1) / kBits;
  const size_t smem = (size_t)(words + 2 + words * kBits) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_sweep_kernel<<<B, kSweepThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(scratch), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, words);
  return (int)cudaGetLastError();
}

// boxes f32 (B, N, 4) xyxy contiguous, sorted by score (invalid entries
// last); valid uint8 (B, N); keep uint8 (B, N), written in sorted order;
// scratch nms_scratch_bytes(B, N) bytes of device memory. Two launches:
// the mask kernel, then the sweep.
extern "C" int nms_sorted(const void* boxes, const void* valid, void* keep, void* scratch, int B,
                          int n, float thr, void* stream) {
  const int e = nms_mask(boxes, scratch, B, n, thr, stream);
  return e != 0 ? e : nms_sweep(scratch, valid, keep, B, n, stream);
}
