"""Matching costs and assigners of the Pair-Net targets, batched over images.

Counterpart of ``pairnet_tpu/models/matchers.py``, with the batch dimension
written out where the JAX package vmaps:

* ``classification_cost`` / ``bce_mask_cost`` / ``dice_cost``, the costs of
  mmdet's MaskHungarianAssigner (weights cls 2.0, mask 5.0, dice 5.0);
* ``mask_hungarian_assign``: queries to GT segments;
* ``id_match``: Pair-Net's triplet assignment on (subject class, object
  class) costs (weights 1.0 / 1.0, predicate 0.0);
* ``focal_cost`` and ``box_hungarian_assign``: the Deformable-DETR
  HungarianAssigner (focal 2.0, L1 5.0 on normalized cxcywh, gIoU 2.0 on
  image-scaled xyxy) of the box-detector head;
* ``sample_points_for_matching``.

Every assigner makes one call of
:func:`pairnet_torch.ops.hungarian.batched_hungarian` on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pairnet_torch.ops.hungarian import batched_hungarian
from pairnet_torch.ops.sampling import sample_mask_points


def classification_cost(logits, gt_labels):
    """mmdet ClassificationCost: ``-softmax(logits)[..., gt_labels]``.
    logits (B, N, C), gt_labels (B, G) -> (B, N, G)."""
    probs = torch.softmax(logits.float(), dim=-1)
    idx = gt_labels.clamp(0, logits.shape[-1] - 1).long()
    return -torch.gather(probs, 2, idx[:, None, :].expand(-1, probs.shape[1], -1))


def bce_mask_cost(pred_pts, gt_pts):
    """mmdet CrossEntropyLossCost(use_sigmoid=True) on sampled points:
    pred_pts (B, N, P) logits, gt_pts (B, G, P) {0, 1} -> (B, N, G), the
    mean over P."""
    x = pred_pts.float()
    g = gt_pts.float()
    pos = -F.logsigmoid(x)  # BCE against target 1
    neg = -F.logsigmoid(-x)  # BCE against target 0
    return (pos @ g.transpose(1, 2) + neg @ (1.0 - g).transpose(1, 2)) / x.shape[-1]


def dice_cost(pred_pts, gt_pts, eps=1.0):
    """mmdet DiceCost(pred_act=True, naive, eps=1.0) -> (B, N, G)."""
    p = torch.sigmoid(pred_pts.float())
    g = gt_pts.float()
    num = 2.0 * (p @ g.transpose(1, 2))
    den = p.sum(-1)[:, :, None] + g.sum(-1)[:, None, :]
    return 1.0 - (num + eps) / (den + eps)


class MaskAssignResult(NamedTuple):
    query2gt: torch.Tensor  # (B, Q) gt index per query or -1
    gt2query: torch.Tensor  # (B, G) query index per gt or -1


def mask_hungarian_assign(cls_logits, mask_pts, gt_labels, gt_mask_pts, gt_valid,
                          cls_weight=2.0, mask_weight=5.0, dice_weight=5.0):
    """Query <-> GT-segment Hungarian on the cls + mask-BCE + dice point
    costs. cls_logits (B, Q, C+1), mask_pts (B, Q, P), gt_labels (B, G),
    gt_mask_pts (B, G, P), gt_valid (B, G) bool."""
    cost = (
        cls_weight * classification_cost(cls_logits, gt_labels)
        + mask_weight * bce_mask_cost(mask_pts, gt_mask_pts)
        + dice_weight * dice_cost(mask_pts, gt_mask_pts)
    )
    row2col, col2row = batched_hungarian(cost, col_mask=gt_valid)
    return MaskAssignResult(query2gt=row2col, gt2query=col2row)


def focal_cost(logits, gt_labels, alpha=0.25, gamma=2.0, eps=1e-12):
    """mmdet FocalLossCost (binary_input=False): the focal positive minus
    negative cost of each class, at the GT labels. logits (B, N, C), gt_labels
    (B, G) -> (B, N, G)."""
    p = torch.sigmoid(logits.float())
    pos = -alpha * ((1.0 - p) ** gamma) * torch.log(p + eps)
    neg = -(1.0 - alpha) * (p ** gamma) * torch.log(1.0 - p + eps)
    idx = gt_labels.long()[:, None, :].expand(-1, p.shape[1], -1)
    return torch.gather(pos - neg, 2, idx)


class BoxAssignResult(NamedTuple):
    query2gt: torch.Tensor  # (B, Q) matched gt per query or -1
    gt2query: torch.Tensor  # (B, G) matched query per valid gt or -1


def box_hungarian_assign(cls_logits, boxes, gt_labels, gt_boxes, gt_valid, img_hw,
                         cls_weight=2.0, l1_weight=5.0, giou_weight=2.0):
    """mmdet HungarianAssigner with FocalLossCost, BBoxL1Cost (cxcywh) and
    IoUCost (giou). cls_logits (B, Q, C) sigmoid logits, boxes (B, Q, 4) and
    gt_boxes (B, G, 4) normalized cxcywh, gt_labels (B, G), gt_valid (B, G)
    bool, img_hw (B, 2) the resized image's (h, w) that scales the gIoU."""
    from pairnet_torch.ops.boxes import cxcywh_to_xyxy, generalized_box_iou

    cost = cls_weight * focal_cost(cls_logits, gt_labels)
    cost = cost + l1_weight * (boxes.float()[:, :, None] - gt_boxes[:, None]).abs().sum(-1)
    scale = img_hw.flip(-1).repeat(1, 2).float()[:, None, :]
    giou = generalized_box_iou(cxcywh_to_xyxy(boxes.float()) * scale,
                               cxcywh_to_xyxy(gt_boxes) * scale)
    cost = cost + giou_weight * (-giou)
    row2col, col2row = batched_hungarian(cost, col_mask=gt_valid)
    return BoxAssignResult(query2gt=row2col, gt2query=col2row)


class IdMatchResult(NamedTuple):
    relq2gt: torch.Tensor  # (B, K) gt relation per relation query or -1
    gt2relq: torch.Tensor  # (B, Rm) relation query per gt relation or -1


def id_match(sub_score, obj_score, rel_score, gt_sub_cls, gt_obj_cls, gt_rel_labels,
             rel_valid, sub_weight=1.0, obj_weight=1.0, rel_weight=0.0):
    """Pair-Net triplet assignment (IdMatcher). Scores (B, K, C+1) /
    (B, K, R), GT (B, Rm), rel_valid (B, Rm) bool."""
    cost = sub_weight * classification_cost(sub_score, gt_sub_cls) + (
        obj_weight * classification_cost(obj_score, gt_obj_cls)
    )
    if rel_weight != 0.0:
        cost = cost + rel_weight * classification_cost(rel_score, gt_rel_labels)
    row2col, col2row = batched_hungarian(cost, col_mask=rel_valid)
    return IdMatchResult(relq2gt=row2col, gt2relq=col2row)


def sample_points_for_matching(mask_logits, gt_masks, points):
    """Point-sample predictions (B, Q, h, w) and GT (B, G, hg, wg) at the
    shared normalized points (B, P, 2) -> ((B, Q, P), (B, G, P))."""
    return sample_mask_points(mask_logits, points), sample_mask_points(gt_masks.float(), points)
