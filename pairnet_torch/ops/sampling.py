"""Bilinear point sampling (gather + lerp), batched.

Counterpart of ``pairnet_tpu/ops/sampling.py``: a point p in [0, 1] maps to
the pixel coordinate ``p * size - 0.5``, as ``grid_sample(align_corners=False,
padding_mode="zeros")`` does; corners outside the map contribute zero. The
batch dimension is written out where the JAX package vmaps.
"""

from __future__ import annotations

import torch


def point_sample(feat, points):
    """Sample ``feat`` (B, H, W, C) at ``points`` (B, ..., 2), (x, y) in
    [0, 1]. Returns (B, ..., C); zero padding outside the map."""
    B, H, W, C = feat.shape
    pts_shape = points.shape[1:-1]
    pts = points.reshape(B, -1, 2).float()
    x = pts[..., 0] * W - 0.5
    y = pts[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = feat.reshape(B, H * W, C)

    def corner(xi, yi, w):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * (w * inside)[..., None]

    out = (
        corner(x0, y0, wx0 * wy0)
        + corner(x0 + 1, y0, wx1 * wy0)
        + corner(x0, y0 + 1, wx0 * wy1)
        + corner(x0 + 1, y0 + 1, wx1 * wy1)
    )
    return out.reshape(B, *pts_shape, C)


def sample_mask_points(masks, points):
    """Sample stacks of masks (B, N, H, W) at shared points (B, P, 2) ->
    (B, N, P)."""
    return point_sample(masks.permute(0, 2, 3, 1), points).transpose(1, 2)
