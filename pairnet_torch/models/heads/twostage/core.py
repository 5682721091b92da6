"""Two-stage relation-head substrate: RoI and union extraction, frequency
bias, pair sampling, box encodings.

Counterpart of ``pairnet_tpu/models/heads/twostage/core.py``:

* :class:`VisualSpatialExtractor`: multi-level RoIAlign 7x7 -> flatten -> a
  2-layer FC head; union features add a 2-channel rasterized sub/obj
  rectangle mask (27x27) through conv(7x7, s2) -> maxpool -> conv(3x3);
* :class:`FrequencyBias`: (sub, obj) labels -> a predicate row of a table;
* host-side pair sampling (numpy, fixed shapes): :func:`sample_train_pairs`,
  :func:`all_test_pairs`, :func:`detect_relsample`;
* :func:`encode_box_info`.

Every BatchNorm of the two-stage heads uses its running statistics, as
JAX's ``use_running_average=True`` does: :class:`RunningBatchNorm` has an
affine that trains and statistics that no step changes, in ``train()`` too.
Module names are the reference's (``visual_bbox_head.{0,2}``,
``spatial_conv.{0,2}.{conv,bn}``, ``freq_bias.obj_baseline``), so the JAX
package's converters read the port's ``state_dict()``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.frameworks.panoptic_fpn import ChwLinear
from pairnet_torch.ops.roi_align import multilevel_roi_align


def take(x, idx):
    """x (B, N, ...) at idx (B, ...) along dim 1 (JAX's ``vmap(a[i])``)."""
    b = torch.arange(x.shape[0], device=x.device).reshape(-1, *([1] * (idx.dim() - 1)))
    return x[b, idx.long()]


def encode_box_info(boxes, img_hw):
    """(B, N, 4) xyxy + (B, 2) (h, w) -> (B, N, 9) normalized box statistics."""
    hei = img_hw[:, 0].float()[:, None]
    wid = img_hw[:, 1].float()[:, None]
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    x = boxes[..., 0] + 0.5 * w
    y = boxes[..., 1] + 0.5 * h
    return torch.stack([w / wid, h / hei, x / wid, y / hei, boxes[..., 0] / wid,
                        boxes[..., 1] / hei, boxes[..., 2] / wid, boxes[..., 3] / hei,
                        w * h / (wid * hei)], -1)


class RunningBatchNorm(nn.Module):
    """BatchNorm on its running statistics (flax ``use_running_average=True``,
    eps 1e-5) over ``channel_dim``: ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias``. ``weight`` and ``bias`` train; the statistics are
    buffers that no forward updates."""

    def __init__(self, num_features: int, eps: float = 1e-5, channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        mul = (torch.rsqrt(self.running_var + self.eps) * self.weight).reshape(shape)
        return (x - self.running_mean.reshape(shape)) * mul + self.bias.reshape(shape)


class FrequencyBias(nn.Module):
    """(sub_label, obj_label) 1-based -> predicate bias row (R + 1): a
    (C * C, R + 1) table, zero unless trained or loaded (JAX initializes it
    from the dataset statistics when given, else zeros)."""

    def __init__(self, num_classes: int, num_predicates: int):
        super().__init__()
        self.num_classes = num_classes
        self.obj_baseline = nn.Embedding(num_classes * num_classes, num_predicates)

    def reset_parameters(self):
        with torch.no_grad():
            self.obj_baseline.weight.zero_()

    def forward(self, pair_labels):
        C = self.num_classes
        idx = ((pair_labels[..., 0].long() - 1).clamp(0, C - 1) * C
               + (pair_labels[..., 1].long() - 1).clamp(0, C - 1))
        return self.obj_baseline.weight[idx]


class ConvReluBN(nn.Module):
    """mmcv ConvModule(conv, ReLU, then BN) of the spatial rect branch."""

    def __init__(self, cin, cout, kernel_size, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2)
        self.bn = RunningBatchNorm(cout, channel_dim=1)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class MaxPool(nn.Module):
    def forward(self, x):  # 3x3, stride 2, padded with -inf
        return F.max_pool2d(x, 3, stride=2, padding=1)


class VisualSpatialExtractor(nn.Module):
    """RoIAlign features of boxes or union boxes (+ spatial rects) ->
    (B, P, fc_out)."""

    def __init__(self, fc_out_channels: int = 1024, in_channels: int = 256,
                 with_spatial: bool = False, roi_size: int = 7, strides=(4, 8, 16, 32),
                 spatial_size: int = 27):
        super().__init__()
        self.roi_size, self.strides, self.spatial_size = roi_size, tuple(strides), spatial_size
        self.visual_bbox_head = nn.Sequential(
            ChwLinear(in_channels, roi_size, roi_size, fc_out_channels), nn.ReLU(),
            nn.Linear(fc_out_channels, fc_out_channels), nn.ReLU())
        if with_spatial:
            self.spatial_conv = nn.Sequential(
                ConvReluBN(2, in_channels // 2, 7, stride=2), MaxPool(),
                ConvReluBN(in_channels // 2, in_channels, 3))

    def rects(self, img_hw, sub_rois, obj_rois):
        """(B, P, 2, S, S) rasterized sub and obj rectangles on an S x S grid."""
        S = self.spatial_size
        hw = img_hw.float()
        scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)[:, None]
        grid = torch.arange(S, dtype=torch.float32, device=hw.device)

        def rect(b):
            b = b / scale * S
            xs_in = (grid >= torch.floor(b[..., 0:1])) & (grid <= torch.ceil(b[..., 2:3]))
            ys_in = (grid >= torch.floor(b[..., 1:2])) & (grid <= torch.ceil(b[..., 3:4]))
            return (ys_in[..., :, None] & xs_in[..., None, :]).float()

        return torch.stack([rect(sub_rois), rect(obj_rois)], 2)

    def forward(self, feats, rois, img_hw=None, sub_rois=None, obj_rois=None):
        """feats: FPN levels (B, H, W, C); rois (B, P, 4) xyxy pixels."""
        roi_feats = multilevel_roi_align(list(feats), self.strides, rois, self.roi_size)
        B, P = rois.shape[:2]
        roi_feats = roi_feats.reshape(B * P, *roi_feats.shape[2:])  # (BP, 7, 7, C)
        if hasattr(self, "spatial_conv"):
            rects = self.rects(img_hw, sub_rois, obj_rois).to(roi_feats.dtype)
            spatial = self.spatial_conv(rects.reshape(B * P, 2, *rects.shape[-2:]))
            roi_feats = roi_feats + spatial.permute(0, 2, 3, 1)
        return self.visual_bbox_head(roi_feats).reshape(B, P, -1)


def union_boxes(boxes, pairs):
    """(B, N, 4), (B, P, 2) -> (B, P, 4) enclosing boxes."""
    s = take(boxes, pairs[..., 0])
    o = take(boxes, pairs[..., 1])
    return torch.cat([torch.minimum(s[..., :2], o[..., :2]),
                      torch.maximum(s[..., 2:], o[..., 2:])], -1)


# ---------------- host-side pair sampling (fixed shapes) -------------------


def sample_train_pairs(relation_map: np.ndarray, n_valid: int, max_pairs: int,
                       pos_fraction: float = 0.25, rng: np.random.Generator | None = None):
    """gtbox_relsample semantics: every GT-related pair is a positive (at
    most ``max_pairs * pos_fraction``, drawn from ``rng``), background pairs
    are drawn from the unrelated i != j pairs. Returns fixed-shape (pairs
    (max_pairs, 2), labels (max_pairs,), valid (max_pairs,))."""
    rng = rng or np.random.default_rng()
    num_pos_max = int(max_pairs * pos_fraction)
    ps, po = np.nonzero(relation_map[:n_valid, :n_valid])
    pos_labels = relation_map[ps, po]
    if len(ps) > num_pos_max:
        sel = rng.permutation(len(ps))[:num_pos_max]
        ps, po, pos_labels = ps[sel], po[sel], pos_labels[sel]

    ii, jj = np.meshgrid(np.arange(n_valid), np.arange(n_valid), indexing="ij")
    neg_mask = (ii != jj) & (relation_map[:n_valid, :n_valid] == 0)
    ns, no = np.nonzero(neg_mask)
    n_neg = min(len(ns), max_pairs - len(ps))
    if len(ns) > n_neg:
        sel = rng.permutation(len(ns))[:n_neg]
        ns, no = ns[sel], no[sel]

    pairs = np.zeros((max_pairs, 2), np.int32)
    labels = np.zeros((max_pairs,), np.int32)
    valid = np.zeros((max_pairs,), bool)
    k = len(ps)
    pairs[:k, 0], pairs[:k, 1] = ps, po
    labels[:k] = pos_labels
    pairs[k : k + len(ns), 0], pairs[k : k + len(ns), 1] = ns, no
    valid[: k + len(ns)] = True
    return pairs, labels, valid


def all_test_pairs(n_valid: int, max_n: int):
    """All ordered pairs i != j over ``max_n`` slots, in row order; a pair
    is valid when both slots are below ``n_valid``."""
    ii, jj = np.meshgrid(np.arange(max_n), np.arange(max_n), indexing="ij")
    off = ii != jj
    pairs = np.stack([ii[off], jj[off]], -1).astype(np.int32)
    valid = (pairs[:, 0] < n_valid) & (pairs[:, 1] < n_valid)
    return pairs, valid


def _np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)

    union = area(a)[:, None] + area(b)[None] - inter
    return inter / np.maximum(union, 1e-9)


def detect_relsample(det_boxes: np.ndarray, det_labels: np.ndarray, gt_boxes: np.ndarray,
                     gt_labels: np.ndarray, relation_map: np.ndarray, max_pairs: int,
                     pos_iou_thr: float = 0.5, pos_fraction: float = 0.25,
                     require_overlap: bool = False, rng: np.random.Generator | None = None):
    """sgdet-mode relation sampling: detections match GT instances of the
    same label with IoU > ``pos_iou_thr``; GT relations map to every matched
    detection pair (foreground), the other non-background detection pairs
    are background. Returns fixed-shape (pairs, labels, valid)."""
    rng = rng or np.random.default_rng()
    N = det_boxes.shape[0]
    ious = _np_box_iou(gt_boxes, det_boxes)  # (G, N)
    is_match = (gt_labels[:, None] == det_labels[None]) & (ious > pos_iou_thr)
    fg_det = det_labels > 0

    pos_pairs, pos_labels = [], []
    gs, go = np.nonzero(relation_map)
    for g_s, g_o in zip(gs, go):
        p = relation_map[g_s, g_o]
        for i in np.nonzero(is_match[g_s])[0]:
            for j in np.nonzero(is_match[g_o])[0]:
                if i != j:
                    pos_pairs.append((i, j))
                    pos_labels.append(p)

    num_pos_max = int(max_pairs * pos_fraction)
    if len(pos_pairs) > num_pos_max:
        sel = rng.permutation(len(pos_pairs))[:num_pos_max]
        pos_pairs = [pos_pairs[k] for k in sel]
        pos_labels = [pos_labels[k] for k in sel]

    possible = np.ones((N, N), bool)
    np.fill_diagonal(possible, False)
    possible[~fg_det] = False
    possible[:, ~fg_det] = False
    if require_overlap:
        self_iou = _np_box_iou(det_boxes, det_boxes)
        possible &= (self_iou > 0) & (self_iou < 1)
    for s, o in pos_pairs:
        possible[s, o] = False
    ns, no = np.nonzero(possible)
    n_neg = min(len(ns), max_pairs - len(pos_pairs))
    if len(ns) > n_neg:
        sel = rng.permutation(len(ns))[:n_neg]
        ns, no = ns[sel], no[sel]

    pairs = np.zeros((max_pairs, 2), np.int32)
    labels = np.zeros((max_pairs,), np.int32)
    valid = np.zeros((max_pairs,), bool)
    k = len(pos_pairs)
    if k:
        pairs[:k] = np.asarray(pos_pairs, np.int32)
        labels[:k] = np.asarray(pos_labels, np.int32)
    pairs[k : k + len(ns), 0], pairs[k : k + len(ns), 1] = ns, no
    valid[: k + len(ns)] = True
    return pairs, labels, valid
