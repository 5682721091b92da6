"""Panoptic FPN detector (inference) for two-stage sgdet.

Counterpart of ``pairnet_tpu/models/frameworks/panoptic_fpn.py``: RPN ->
RoI box head -> class-aware NMS -> FCN mask head -> semantic head ->
:func:`heuristic_fusion_segments`, the per-segment boxes and labels the
relation heads take. The reference freezes this detector and runs it in
eval mode, so it is inference only; it runs in f32 whatever the relation
head's dtype. Everything is fixed shape: per-level top-k proposals, padded
detections, masked NMS. Both NMS calls (the RPN's, thr 0.7, and the
detections' class-offset one) go through ``ops/nms.py``, one kernel launch
each for the whole batch on the card.

Images come in NHWC, as in the JAX package, and the convolutions run NCHW;
the semantic logits go out NHWC, as JAX returns them. Module names are
mmdet's (``rpn_head.rpn_conv``, ``roi_head.bbox_head.shared_fcs.0``,
``roi_head.mask_head.convs.{i}.conv``, ``roi_head.mask_head.upsample``,
``semantic_head.conv_upsample_layers.{i}.conv.{j}.{conv,gn}``), so
``convert_panoptic_fpn`` reads the port's ``state_dict()``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.necks.fpn import FPN, ConvModule
from pairnet_torch.models.necks.pixel_decoder import bilinear_resize
from pairnet_torch.ops.nms import batched_nms, nms, score_order
from pairnet_torch.ops.roi_align import multilevel_roi_align
from pairnet_torch.ops.sampling import point_sample


def make_anchors(h: int, w: int, stride: int, scales=(8,), ratios=(0.5, 1.0, 2.0), device=None):
    """(h * w * A, 4) xyxy anchors, mmdet AnchorGenerator semantics."""
    base = []
    for s in scales:
        for r in ratios:
            size = s * stride
            aw = size * (1.0 / r) ** 0.5
            ah = size * r ** 0.5
            base.append([-aw / 2, -ah / 2, aw / 2, ah / 2])
    base = torch.tensor(base, dtype=torch.float32, device=device)
    ys = (torch.arange(h, device=device) * stride).float()
    xs = (torch.arange(w, device=device) * stride).float()
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    shifts = torch.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def delta2bbox(anchors, deltas, means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
               max_hw=None):
    """mmdet DeltaXYWHBBoxCoder.decode of (..., 4) deltas on (..., 4)
    anchors; ``max_hw`` (B, 2) (h, w) clips the boxes of (B, K, 4) to each
    image."""
    deltas = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    dw = deltas[..., 2].clamp(-4.0, 4.0)
    dh = deltas[..., 3].clamp(-4.0, 4.0)
    cx = ax + deltas[..., 0] * aw
    cy = ay + deltas[..., 1] * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if max_hw is not None:
        hw = max_hw.float()
        hi = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)[:, None]
        boxes = torch.minimum(boxes.clamp_min(0.0), hi)
    return boxes


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(in_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            x = F.relu(self.rpn_conv(f))
            outs.append((self.rpn_cls(x), self.rpn_reg(x)))
        return outs


class ChwLinear(nn.Linear):
    """A Linear over a flattened (C, H, W) roi, as mmdet flattens it; the
    JAX package flattens (H, W, C), and its converter permutes the rows."""

    def __init__(self, c: int, h: int, w: int, out_features: int):
        super().__init__(c * h * w, out_features)
        self.roi_shape = (c, h, w)

    def forward(self, roi_feats):  # (N, H, W, C)
        return super().forward(roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1))


class BBoxHead(nn.Module):
    """mmdet Shared2FCBBoxHead, keeping the full score distributions."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, fc_dim: int = 1024):
        super().__init__()
        self.shared_fcs = nn.ModuleList([ChwLinear(in_channels, 7, 7, fc_dim),
                                         nn.Linear(fc_dim, fc_dim)])
        self.fc_cls = nn.Linear(fc_dim, num_classes + 1)
        self.fc_reg = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, roi_feats):  # (N, 7, 7, C)
        x = F.relu(self.shared_fcs[0](roi_feats))
        x = F.relu(self.shared_fcs[1](x))
        return self.fc_cls(x), self.fc_reg(x)


class MaskHead(nn.Module):
    """FCN mask head: 4 convs + a 2x2 stride-2 deconv -> per-class 28x28."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80):
        super().__init__()
        self.convs = nn.ModuleList(ConvModule(in_channels, in_channels, 3) for _ in range(4))
        self.upsample = nn.ConvTranspose2d(in_channels, in_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, roi_feats):  # (N, 14, 14, C) -> (N, classes, 28, 28)
        x = roi_feats.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.conv_logits(F.relu(self.upsample(x)))


class ConvGNModule(nn.Module):
    """mmcv ConvModule(conv3x3 without bias, GroupNorm(32, eps 1e-5), ReLU)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.gn = nn.GroupNorm(min(32, cout), cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class ConvUpsample(nn.Module):
    def __init__(self, cin, cout, num_layers, num_upsample):
        super().__init__()
        self.num_upsample = num_upsample
        self.conv = nn.ModuleList(ConvGNModule(cin if j == 0 else cout, cout)
                                  for j in range(num_layers))

    def forward(self, x):
        n_up = self.num_upsample
        for layer in self.conv:
            x = layer(x)
            if n_up > 0:
                n_up -= 1
                x = bilinear_resize(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        return x


class SemanticHead(nn.Module):
    """mmdet PanopticFPNHead: per FPN level i (0..3) ``max(1, i)``
    conv-GN-ReLU layers and ``i`` x2 bilinear upsamplings, summed and
    1x1-projected to ``num_stuff + 1`` logits (channel 0: all things)."""

    def __init__(self, in_channels: int = 256, num_stuff: int = 53, inner_channels: int = 128):
        super().__init__()
        self.conv_upsample_layers = nn.ModuleList(
            ConvUpsample(in_channels, inner_channels, max(1, i), i) for i in range(4))
        self.conv_logits = nn.Conv2d(inner_channels, num_stuff + 1, 1)

    def forward(self, feats):
        acc = None
        for layer, f in zip(self.conv_upsample_layers, feats[:4]):
            x = layer(f)
            acc = x if acc is None else acc + x
        return self.conv_logits(acc)


class RoIHead(nn.Module):
    """mmdet's ``roi_head``: the box and mask heads."""

    def __init__(self, in_channels: int, num_things: int):
        super().__init__()
        self.bbox_head = BBoxHead(in_channels, num_things)
        self.mask_head = MaskHead(in_channels, num_things)


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, N, 4)
    labels: torch.Tensor  # (B, N) 1-based (0 invalid)
    scores: torch.Tensor  # (B, N)
    dists: torch.Tensor  # (B, N, C+1)
    valid: torch.Tensor  # (B, N)


class PanopticSegments(NamedTuple):
    """Per-segment outputs of the heuristic panoptic fusion (things and
    stuff), what the two-stage relation head takes in sgdet."""

    boxes: torch.Tensor  # (B, M, 4) input-pixel xyxy
    labels: torch.Tensor  # (B, M) 1-based (1..T things, T+1..T+S stuff)
    dists: torch.Tensor  # (B, M, C+1)
    valid: torch.Tensor  # (B, M)
    masks: torch.Tensor  # (B, M, h4, w4) bool at the mask stride


def _take(x, idx):
    """x (B, N, ...) at idx (B, K) along dim 1."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


class PanopticFPN(nn.Module):
    def __init__(self, backbone: nn.Module, num_things: int = 80, num_stuff: int = 53,
                 num_proposals: int = 256, max_dets: int = 64, score_thr: float = 0.3,
                 nms_iou: float = 0.5, strides=(4, 8, 16, 32, 64)):
        super().__init__()
        self.backbone = backbone
        self.num_things, self.num_stuff = num_things, num_stuff
        self.num_proposals, self.max_dets = num_proposals, max_dets
        self.score_thr, self.nms_iou = score_thr, nms_iou
        self.strides = tuple(strides)
        self.neck = FPN(backbone.out_channels, 256, num_outs=5)
        self.rpn_head = RPNHead(256)
        self.roi_head = RoIHead(256, num_things)
        self.semantic_head = SemanticHead(256, num_stuff)

    def proposals(self, fpn, image_shape):
        """Per-level top-1000 of the RPN, decoded (not clipped), one NMS
        (thr 0.7) over all levels, the top ``num_proposals`` kept boxes:
        (props (B, P, 4), valid (B, P))."""
        all_scores, all_boxes = [], []
        for (cls, reg), stride in zip(self.rpn_head(fpn), self.strides):
            B, _, h, w = cls.shape
            anchors = make_anchors(h, w, stride, device=cls.device)
            scores = cls.permute(0, 2, 3, 1).reshape(B, -1).float()
            deltas = reg.permute(0, 2, 3, 1).reshape(B, -1, 4).float()
            k = min(1000, scores.shape[1])
            top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
            top_s, top_i = top_s[:, :k], top_i[:, :k]
            all_scores.append(top_s)
            all_boxes.append(delta2bbox(anchors[top_i], _take(deltas, top_i)))
        scores = torch.cat(all_scores, 1)
        boxes = torch.cat(all_boxes, 1)
        keep = nms(boxes, torch.sigmoid(scores), 0.7)
        ranked = score_order(scores, keep)[:, : self.num_proposals]
        return _take(boxes, ranked), _take(keep, ranked)

    def detect(self, fpn_hwc, props, prop_valid, image_shape) -> Detections:
        """The box head on the proposals, decoded and clipped to each image,
        class-aware NMS, the top ``max_dets``."""
        B, P = props.shape[:2]
        roi = multilevel_roi_align(fpn_hwc[:4], self.strides[:4], props, 7)
        cls, reg = self.roi_head.bbox_head(roi.reshape(B * P, *roi.shape[2:]))
        probs = torch.softmax(cls.float(), -1).reshape(B, P, -1)
        fg = probs[..., :-1]
        score = fg.amax(-1)
        label = fg.argmax(-1)  # the first maximum, as jnp.argmax
        deltas = reg.float().reshape(B, P, self.num_things, 4)
        deltas = torch.gather(deltas, 2, label[..., None, None].expand(B, P, 1, 4))[:, :, 0]
        det_boxes = delta2bbox(props, deltas, stds=(0.1, 0.1, 0.2, 0.2), max_hw=image_shape)
        ok = prop_valid & (score > self.score_thr)
        keep = batched_nms(det_boxes, score, label, self.nms_iou, ok)
        ranked = score_order(score, keep)[:, : self.max_dets]
        kmask = _take(keep, ranked)
        return Detections(
            boxes=_take(det_boxes, ranked),
            labels=torch.where(kmask, _take(label, ranked) + 1, 0).int(),
            scores=torch.where(kmask, _take(score, ranked), 0.0),
            dists=_take(probs, ranked),
            valid=kmask,
        )

    def paste_masks(self, fpn_hwc, dets: Detections, hw4):
        """The mask head on the detections, each 28x28 logit map pasted onto
        the stride-4 canvas by bilinear sampling (-1e4 outside its box):
        (B, N, h4, w4)."""
        B, N = dets.boxes.shape[:2]
        h4, w4 = hw4
        roi = multilevel_roi_align(fpn_hwc[:4], self.strides[:4], dets.boxes, 14)
        logits = self.roi_head.mask_head(roi.reshape(B * N, *roi.shape[2:]))  # (BN, T, 28, 28)
        lab = (dets.labels.reshape(-1).long() - 1).clamp(0, self.num_things - 1)
        m = logits[torch.arange(B * N, device=lab.device), lab].float()  # (BN, 28, 28)
        dev = m.device
        ys = (torch.arange(h4, dtype=torch.float32, device=dev) + 0.5) * 4
        xs = (torch.arange(w4, dtype=torch.float32, device=dev) + 0.5) * 4
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        x1, y1, x2, y2 = dets.boxes.reshape(-1, 4).float().unbind(-1)
        bw = (x2 - x1).clamp_min(1.0)[:, None, None]
        bh = (y2 - y1).clamp_min(1.0)[:, None, None]
        pts = torch.stack([(xx - x1[:, None, None]) / bw, (yy - y1[:, None, None]) / bh], -1)
        out = point_sample(m[..., None], pts)[..., 0]
        inside = ((pts[..., 0] >= 0) & (pts[..., 0] < 1) & (pts[..., 1] >= 0)
                  & (pts[..., 1] < 1))
        return torch.where(inside, out, -1e4).reshape(B, N, h4, w4)

    def forward(self, images, image_shape, with_masks: bool = False):
        """images (B, H, W, 3), image_shape (B, 2) -> (Detections, semantic
        logits (B, H/4, W/4, S+1)[, det mask logits (B, N, H/4, W/4) when
        ``with_masks``])."""
        images = images.float()
        fpn = self.neck(self.backbone(images.permute(0, 3, 1, 2).contiguous()))
        fpn_hwc = [f.permute(0, 2, 3, 1) for f in fpn]
        props, prop_valid = self.proposals(fpn, image_shape)
        dets = self.detect(fpn_hwc, props, prop_valid, image_shape)
        sem = self.semantic_head(fpn).permute(0, 2, 3, 1)
        if not with_masks:
            return dets, sem
        hw4 = (images.shape[1] // 4, images.shape[2] // 4)
        return dets, sem, self.paste_masks(fpn_hwc, dets, hw4)


def heuristic_fusion_segments(dets: Detections, det_masks, sem, num_things: int, num_stuff: int,
                              mask_stride: int = 4, overlap_thr: float = 0.5,
                              stuff_area_limit: int = 4096) -> PanopticSegments:
    """mmdet HeuristicFusionHead -> per-segment boxes and labels, fixed
    shape: detections paste score-descending onto a canvas (skipped when
    more than ``overlap_thr`` of the mask is already claimed), then stuff
    classes claim the unpainted argmax regions above the area limit. Slots:
    the N detections, then ``num_stuff`` stuff classes. The paste is a
    loop of N steps, each over the whole batch."""
    B, N, h4, w4 = det_masks.shape
    S = num_stuff
    dev = det_masks.device
    bidx = torch.arange(B, device=dev)
    binm = (torch.sigmoid(det_masks.float()) > 0.5) & dets.valid[:, :, None, None]
    order = score_order(dets.scores, dets.valid)
    claimed = torch.zeros((B, h4, w4), dtype=torch.bool, device=dev)
    thing_masks = torch.zeros((B, N, h4, w4), dtype=torch.bool, device=dev)
    thing_kept = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for k in range(N):
        i = order[:, k]
        m = binm[bidx, i]
        area = m.sum((1, 2))
        fresh = m & ~claimed
        fresh_area = fresh.sum((1, 2))
        keep = (area > 0) & ((area - fresh_area).float() <= overlap_thr * area.float())
        claimed = torch.where(keep[:, None, None], claimed | fresh, claimed)
        thing_masks[bidx, i] = fresh & keep[:, None, None]
        thing_kept[bidx, i] = keep

    seg_cls = sem.float().argmax(-1)  # (B, h4, w4); channel 0 = things
    sids = torch.arange(1, S + 1, device=dev)
    stuff_masks = (seg_cls[:, None] == sids[None, :, None, None]) & ~claimed[:, None]
    stuff_kept = stuff_masks.sum((-2, -1)) >= stuff_area_limit / (mask_stride * mask_stride)

    masks = torch.cat([thing_masks, stuff_masks], 1)
    valid = torch.cat([thing_kept & dets.valid, stuff_kept], 1)
    ys_any, xs_any = masks.any(3), masks.any(2)
    yi = torch.arange(h4, device=dev)
    xi = torch.arange(w4, device=dev)
    y0 = torch.where(ys_any, yi, h4).amin(-1)
    y1 = torch.where(ys_any, yi + 1, 0).amax(-1)
    x0 = torch.where(xs_any, xi, w4).amin(-1)
    x1 = torch.where(xs_any, xi + 1, 0).amax(-1)
    boxes = torch.stack([x0, y0, x1, y1], -1).float() * mask_stride
    C1 = dets.dists.shape[-1]
    stuff_labels = (num_things + sids)[None].expand(B, S)
    labels = torch.cat([dets.labels, stuff_labels.to(dets.labels.dtype)], 1)
    # stuff segments get unit confidence: a one-hot distribution (by
    # comparison: F.one_hot checks its input on the host)
    stuff_dists = ((stuff_labels - 1).clamp(0, C1 - 1)[..., None]
                   == torch.arange(C1, device=dev)).to(dets.dists.dtype)
    dists = torch.cat([dets.dists, stuff_dists], 1)
    labels = torch.where(valid, labels, 0)
    return PanopticSegments(boxes=boxes, labels=labels, dists=dists, valid=valid, masks=masks)
