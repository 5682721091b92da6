// Native data-path kernels for the host-side pipeline.
//
// The reference's input pipeline runs on native code (torch C++ dataloader
// workers, mmcv/libjpeg decode + SIMD resize; ref SURVEY.md §2.4). This
// library provides the TPU build's equivalents, exposed via ctypes
// (pairnet_torch/native/__init__.py; a copy of pairnet_tpu/native/preprocess.cc):
//   - bilinear uint8 image resize (half-pixel centers, PIL/torch-compatible)
//   - fused normalize (ImageNet mean/std) + pad into the fixed canvas
//   - panoptic RGB -> segment-id decode (rgb2id)
//   - per-segment binary mask extraction + nearest-neighbor downsample
// All loops are OpenMP-parallel.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>

extern "C" {

// Bilinear resize uint8 HWC image (align_corners=false, half-pixel centers).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sh / dh - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(std::max(y0 + 1, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sw / dw - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(std::max(x0 + 1, 0), sw - 1);
      for (int k = 0; k < c; ++k) {
        float v00 = src[(y0c * sw + x0c) * c + k];
        float v01 = src[(y0c * sw + x1c) * c + k];
        float v10 = src[(y1c * sw + x0c) * c + k];
        float v11 = src[(y1c * sw + x1c) * c + k];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        dst[(y * dw + x) * c + k] = (uint8_t)std::min(std::max(v + 0.5f, 0.f), 255.f);
      }
    }
  }
}

// Normalize (x - mean) / std into a zero-initialized f32 canvas (ph, pw, 3).
void normalize_pad_f32(const uint8_t* src, int h, int w,
                       const float* mean, const float* stddev,
                       float* canvas, int ph, int pw) {
  std::memset(canvas, 0, sizeof(float) * ph * pw * 3);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      for (int k = 0; k < 3; ++k) {
        canvas[(y * pw + x) * 3 + k] =
            (src[(y * w + x) * 3 + k] - mean[k]) / stddev[k];
      }
    }
  }
}

// Panoptic RGB (H, W, 3) -> int64 ids: r + 256 g + 65536 b.
void rgb2id(const uint8_t* rgb, int n, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    out[i] = (int64_t)rgb[i * 3] + 256 * (int64_t)rgb[i * 3 + 1] +
             65536 * (int64_t)rgb[i * 3 + 2];
  }
}

// Per-segment binary masks, nearest-downsampled to (mh, mw).
// seg_ids: (h, w) int64; ids: (n_seg,) int64; out: (n_seg, mh, mw) f32.
void extract_masks_downsample(const int64_t* seg_ids, int h, int w,
                              const int64_t* ids, int n_seg,
                              float* out, int mh, int mw) {
#pragma omp parallel for schedule(static)
  for (int s = 0; s < n_seg; ++s) {
    int64_t id = ids[s];
    for (int y = 0; y < mh; ++y) {
      int sy = std::min((int)((y + 0.5f) * h / mh), h - 1);
      for (int x = 0; x < mw; ++x) {
        int sx = std::min((int)((x + 0.5f) * w / mw), w - 1);
        out[((int64_t)s * mh + y) * mw + x] =
            seg_ids[sy * w + sx] == id ? 1.0f : 0.0f;
      }
    }
  }
}

}  // extern "C"
