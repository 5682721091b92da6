"""RoIAlign (mmcv / Detectron2 semantics, aligned=True), batched over images.

Counterpart of ``pairnet_tpu/ops/roi_align.py``: each output bin averages
``sampling_ratio``^2 regular samples, bilinear through
``ops/sampling.py::point_sample``; ``map_rois_to_levels`` is mmdet's
SingleRoIExtractor level mapping, floor(log2(sqrt(area) / finest_scale +
1e-6)) clamped to the levels.

JAX samples every level for every roi and then picks one. At 4,032 union
boxes, 4 levels, 14x14 samples and 256 channels that is ~0.8 GB a level an
image, so :func:`multilevel_roi_align` samples each roi only at its own
level, in chunks of rois. The samples of one roi do not depend on the other
rois, so the result is the all-levels one bit for bit.
"""

from __future__ import annotations

import torch

from pairnet_torch.ops.sampling import point_sample

ROI_CHUNK = 1024  # rois sampled at a time: bounds the (rois, 14 x 14, C) temporaries


def roi_align(feat, rois, spatial_scale: float, output_size: int = 7, sampling_ratio: int = 2):
    """feat (B, H, W, C), rois (B, N, 4) xyxy in image pixels -> (B, N, P, P, C)."""
    B, H, W, C = feat.shape
    N = rois.shape[1]
    s, P = sampling_ratio, output_size
    boxes = rois.float() * spatial_scale - 0.5  # aligned=True
    x0, y0, x1, y1 = boxes.unbind(-1)
    bin_w = (x1 - x0).clamp_min(1e-6) / P
    bin_h = (y1 - y0).clamp_min(1e-6) / P
    grid = (torch.arange(P * s, dtype=torch.float32, device=feat.device) + 0.5) / s
    xs = x0[..., None] + grid * bin_w[..., None]  # (B, N, P*s)
    ys = y0[..., None] + grid * bin_h[..., None]
    # point_sample's align_corners=False convention: pixel p <- (p + 0.5) / size
    px = (xs + 0.5) / W
    py = (ys + 0.5) / H
    pts = torch.stack([px[:, :, None, :].expand(B, N, P * s, P * s),
                       py[:, :, :, None].expand(B, N, P * s, P * s)], dim=-1)
    sampled = point_sample(feat, pts.reshape(B, N, -1, 2)).reshape(B, N, P, s, P, s, C)
    return sampled.mean(dim=(3, 5))


def map_rois_to_levels(rois, num_levels: int, finest_scale: int = 56):
    """The FPN level of each roi (..., 4): int64 in [0, num_levels)."""
    scale = torch.sqrt((rois[..., 2] - rois[..., 0]).clamp_min(0)
                       * (rois[..., 3] - rois[..., 1]).clamp_min(0))
    lvls = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvls.clamp(0, num_levels - 1).long()


def multilevel_roi_align(feats, strides, rois, output_size: int = 7, sampling_ratio: int = 2,
                         finest_scale: int = 56):
    """FPN RoIAlign: feats per level (B, H_l, W_l, C), rois (B, N, 4) in
    image pixels -> (B, N, P, P, C), each roi sampled at its mapped level."""
    B, N = rois.shape[:2]
    C = feats[0].shape[-1]
    P = output_size
    out = feats[0].new_zeros((B * N, P, P, C), dtype=torch.float32)
    lvls = map_rois_to_levels(rois, len(feats), finest_scale).reshape(-1)
    flat_rois = rois.reshape(-1, 4)
    # segments of one level and one image, in that order: one host sync
    key = lvls * B + torch.arange(B * N, device=rois.device) // N
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=len(feats) * B).tolist()
    start = 0
    for seg, count in enumerate(counts):
        lvl, b = divmod(seg, B)
        for lo in range(start, start + count, ROI_CHUNK):
            sel = order[lo:min(lo + ROI_CHUNK, start + count)]
            out[sel] = roi_align(feats[lvl][b:b + 1], flat_rois[sel][None], 1.0 / strides[lvl],
                                 output_size, sampling_ratio)[0]
        start += count
    return out.reshape(B, N, P, P, C).to(feats[0].dtype)
