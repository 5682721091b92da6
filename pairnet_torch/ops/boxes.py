"""Box and mask geometry on tensors (fixed shapes, any device).

Counterpart of ``pairnet_tpu/ops/boxes.py``: torchvision's ``box_convert``,
``masks_to_boxes``, pairwise box IoU and generalized IoU (the DETR matching
costs and losses), and pairwise mask IoU as one matmul.
"""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(b):
    return (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)


def box_iou(a, b, eps=1e-7):
    """Pairwise IoU of xyxy boxes a (..., N, 4) and b (..., M, 4): (iou,
    union), each (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp_min(eps), union


def generalized_box_iou(a, b, eps=1e-7):
    """Pairwise GIoU (..., N, M) of xyxy boxes."""
    iou, union = box_iou(a, b, eps)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    hull = (wh[..., 0] * wh[..., 1]).clamp_min(eps)
    return iou - (hull - union) / hull


def masks_to_boxes(masks):
    """(N, H, W) {0, 1} masks -> (N, 4) xyxy f32 boxes; empty masks give zeros."""
    N, H, W = masks.shape
    m = masks > 0.5
    ys = torch.arange(H, dtype=torch.float32, device=masks.device)
    xs = torch.arange(W, dtype=torch.float32, device=masks.device)
    big = 1e8
    x_any = m.any(dim=1)  # (N, W)
    y_any = m.any(dim=2)  # (N, H)
    x0 = torch.where(x_any, xs, big).amin(dim=1)
    x1 = torch.where(x_any, xs + 1, -big).amax(dim=1)
    y0 = torch.where(y_any, ys, big).amin(dim=1)
    y1 = torch.where(y_any, ys + 1, -big).amax(dim=1)
    empty = ~m.flatten(1).any(dim=1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1)
    return torch.where(empty[:, None], 0.0, boxes)


def mask_iou(a, b, eps=1e-7):
    """Pairwise IoU (N, M) of masks a (N, H, W) and b (M, H, W) in {0, 1}."""
    af = (a > 0.5).flatten(1).float()
    bf = (b > 0.5).flatten(1).float()
    inter = af @ bf.T
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return inter / union.clamp_min(eps)
