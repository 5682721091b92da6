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
// kept or not only after every earlier kept box has swept over it. The
// design is the simple one:
//   * one CTA per image (blockIdx.x), 1024 threads; the image's boxes and a
//     suppressed flag per box live in shared memory (N * 17 bytes: 82 KB at
//     N = 4,819, under the dynamic shared-memory limit the launcher raises);
//   * the CTA walks i = 0 .. N-1; every thread reads the flag of box i, so
//     all agree whether it is kept; a kept box's later boxes j > i are
//     split over the threads, each setting suppressed[j] when IoU > thr,
//     then one barrier. A box that is not kept costs no barrier: nothing was
//     written since the last one.
// So the sweep takes one barrier per kept box. No host sync. A precomputed
// IoU bitmask or warp-level sweeps would be faster (later work).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBoxes = 12288;  // N * 17 bytes of shared memory <= 227 KB

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f), fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float box_iou(float4 a, float4 b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-7f));
}

__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float4* __restrict__ boxes, const unsigned char* __restrict__ valid,
               unsigned char* __restrict__ keep, int n, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* bs = reinterpret_cast<float4*>(smem);
  unsigned char* supp = smem + (size_t)n * sizeof(float4);
  const size_t base = (size_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    bs[j] = boxes[base + j];
    supp[j] = valid[base + j] ? 0 : 2;  // 2: never kept, suppresses nothing
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (supp[i] != 0) continue;  // every thread reads the same flag
    const float4 a = bs[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads)
      if (supp[j] == 0 && box_iou(a, bs[j]) > thr) supp[j] = 1;
    __syncthreads();
  }
  // a box whose flag is still clear was kept when the walk reached it
  for (int j = threadIdx.x; j < n; j += kThreads) keep[base + j] = supp[j] == 0;
}

}  // namespace

// The largest N an image may have.
extern "C" int nms_max_boxes() { return kMaxBoxes; }

// boxes f32 (B, N, 4) xyxy contiguous, sorted by score (invalid entries
// last); valid uint8 (B, N); keep uint8 (B, N), written in sorted order.
extern "C" int nms_sorted(const void* boxes, const void* valid, void* keep, int B, int n,
                          float thr, void* stream) {
  if (B < 1 || n < 1 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * (sizeof(float4) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float4*>(boxes), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, thr);
  return (int)cudaGetLastError();
}
