"""DETR4Seg: DETR panoptic segmentation with no relations.

Counterpart of ``pairnet_tpu/models/heads/detr4seg_head.py``. The reference
has no checkpoint converter for it: the DETR transformer and mask branch
are PSGTr's modules (mmdet names), the head's own modules mirror the flax
paths. Per-layer class (C + 1 softmax) and box (sigmoid cxcywh) heads over
the DETR transformer, the DETR mask branch on the final layer.

Training (``detr4seg_loss``): Hungarian on class 1 / L1 5 / gIoU 2 costs,
every layer in one batched call; per layer CE (background weight 0.1), L1
and gIoU; on the final layer point-sampled mask BCE and dice. Inference:
the DETR panoptic fusion of ``diagnostic_postprocess``.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.heads.psgtr_head import (
    DetrMLP,
    DETRTransformer,
    MaskHeadSmallConv,
    MHAttentionMap,
    detr_tokens,
    image_scale,
    l1_cost,
    mask_branch,
    matched_giou,
    take_rows,
    tile,
    world_count,
)
from pairnet_torch.models.losses import _global, naive_dice_loss, sigmoid_bce
from pairnet_torch.models.matchers import classification_cost
from pairnet_torch.ops.boxes import cxcywh_to_xyxy, generalized_box_iou, xyxy_to_cxcywh
from pairnet_torch.ops.hungarian import batched_hungarian
from pairnet_torch.ops.sampling import sample_mask_points


class Detr4SegHead(nn.Module):
    def __init__(self, in_channels, num_classes=133, num_query=100, embed_dims=256, num_heads=8,
                 num_encoder_layers=6, num_decoder_layers=6):
        super().__init__()
        C = embed_dims
        self.input_proj = nn.Conv2d(in_channels[-1], C, 1)
        self.query_embed = nn.Embedding(num_query, C)
        self.transformer = DETRTransformer(C, num_heads, num_encoder_layers, num_decoder_layers)
        self.class_embed = nn.Linear(C, num_classes + 1)
        self.box_embed = DetrMLP(C, C, 4, 3)
        self.bbox_attention = MHAttentionMap(C, C, num_heads)
        self.mask_head = MaskHeadSmallConv(
            C + num_heads, [in_channels[2], in_channels[1], in_channels[0]], C)

    def forward(self, feats):
        proj = self.input_proj(feats[-1])
        tokens, pos = detr_tokens(proj)
        (outs,), memory = self.transformer(tokens, pos, self.query_embed.weight)
        cls_layers = [self.class_embed(o) for o in outs]
        box_layers = [torch.sigmoid(self.box_embed(o)) for o in outs]
        mask = mask_branch(proj, memory, outs[-1], self.bbox_attention, self.mask_head, feats)
        return {"cls": cls_layers[-1], "box": box_layers[-1], "mask": mask,
                "layers": {"cls": cls_layers, "box": box_layers}}


def _norm_boxes(boxes, image_shape):
    """xyxy pixel boxes (B, G, 4) over the image's max(size, 1), as cxcywh
    clipped to [0, 1] (JAX divides before converting, PSGTr after)."""
    return xyxy_to_cxcywh(boxes.float() / image_scale(image_shape).clamp_min(1.0)).clamp(0, 1)


def detr4seg_loss(outputs, batch, points, num_classes=133, bg_cls_weight=0.1, box_l1_weight=5.0,
                  giou_weight=2.0, focal_weight=1.0, dice_weight=1.0, aux_layers=True,
                  reduce=None):
    """Per-layer detection losses and the final layer's mask losses on the
    points (B, P, 2): the loss dict with ``loss_total``."""
    del num_classes  # the class count is the logits' width
    cls_layers = outputs["layers"]["cls"] if aux_layers else [outputs["cls"]]
    box_layers = outputs["layers"]["box"] if aux_layers else [outputs["box"]]
    B = outputs["cls"].shape[0]
    gt_labels = batch["gt_labels"].long()
    G = gt_labels.shape[1]
    gt_n = _norm_boxes(batch["gt_boxes"], batch["image_shape"])
    scale = image_scale(batch["image_shape"])
    nl = len(cls_layers)
    with torch.no_grad():  # every layer's assignment in one call
        cls_p = torch.cat([c.detach() for c in cls_layers])
        box_p = torch.cat([b.detach() for b in box_layers])
        cost = classification_cost(cls_p, tile(gt_labels, nl))
        cost = cost + box_l1_weight * l1_cost(box_p, tile(gt_n, nl))
        giou = generalized_box_iou(cxcywh_to_xyxy(box_p) * tile(scale, nl),
                                   cxcywh_to_xyxy(tile(gt_n, nl)) * tile(scale, nl))
        cost = cost + giou_weight * (-giou)
        q2g_all = batched_hungarian(cost, col_mask=tile(batch["gt_valid"].bool(), nl))[0]

    losses = {}
    for li, (cls_pred, box_pred) in enumerate(zip(cls_layers, box_layers)):
        q2g = q2g_all[li * B:(li + 1) * B]
        pos = q2g >= 0
        safe = q2g.clamp(0, G - 1)
        w = pos.float()
        n_pos = _global(w.sum(), reduce)
        npos = n_pos.clamp_min(1.0)
        Cn = cls_pred.shape[-1]
        cls_t = torch.where(pos, torch.gather(gt_labels, 1, safe), Cn - 1)
        cw = torch.ones(Cn, device=cls_pred.device)
        cw[-1] = bg_cls_weight
        logp = torch.log_softmax(cls_pred.float(), dim=-1)
        nll = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
        n_neg = world_count(w.numel(), reduce) - n_pos
        box_t = take_rows(gt_n, safe)
        tag = "" if li == nl - 1 else f"d{li}."
        losses[f"{tag}loss_cls"] = torch.sum(nll * cw[cls_t]) / (
            npos + bg_cls_weight * n_neg).clamp_min(1.0)
        losses[f"{tag}loss_bbox"] = box_l1_weight * torch.sum(
            (box_pred - box_t).abs().sum(-1) * w) / npos
        gi = matched_giou(box_pred, box_t, scale)
        losses[f"{tag}loss_iou"] = giou_weight * torch.sum((1.0 - gi) * w) / npos

    # the final layer's mask losses on the sampled points
    pred_pts = sample_mask_points(outputs["mask"], points)
    gt_pts = sample_mask_points(batch["gt_masks"].float(), points)
    gt_for_q = (take_rows(gt_pts, safe) > 0.5).float()
    wq = w.reshape(-1)
    P = pred_pts.shape[-1]
    losses["loss_focal"] = focal_weight * torch.sum(
        sigmoid_bce(pred_pts, gt_for_q).mean(-1).reshape(-1) * wq) / npos
    losses["loss_dice"] = dice_weight * naive_dice_loss(
        pred_pts.reshape(-1, P), gt_for_q.reshape(-1, P), wq, reduce=reduce)
    losses["loss_total"] = sum(losses.values())
    return losses


def detr4seg_postprocess(outputs, image_index=None, num_things: int = 80):
    """DETR panoptic fusion over the query set (no relations)."""
    from pairnet_torch.models.heads.diagnostic import diagnostic_postprocess

    return diagnostic_postprocess(outputs, image_index=image_index, num_things=num_things,
                                  num_relations=1, score_thr=0.85)
