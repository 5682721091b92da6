"""The original PSGFormer head: a dual-decoder DETR with prototype matching.

Counterpart of ``pairnet_tpu/models/heads/psgformer_head.py`` with the
reference checkpoint's module names (``transformer.decoder1`` /
``decoder2``, 2-layer ``Sequential`` updates and relation classifier). One
DETR encoder over C5 feeds two 6-layer decoders, object queries and
relation queries:

* object branch: DETR panoptic (class CE / box L1 / gIoU per layer, the
  DETR mask branch with dice on the last layer), Hungarian on class 4 /
  L1 3 / gIoU 2 costs;
* relation branch: predicate CE over all relation queries; subjects and
  objects recovered by temperature-scaled cosine prototype matching and
  trained with a multilabel CE over the matched object queries under an
  IdMatcher assignment on (subject id, object id, predicate) costs.

Every layer's object assignment is one batched Hungarian call, the
relation assignment a second.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.heads.baseline_head import (
    baseline_postprocess,
    id_assign,
    id_targets,
    masked_multilabel_ce,
    prototype_scores,
)
from pairnet_torch.models.heads.psgtr_head import (
    DetrMLP,
    DETRTransformer,
    MaskHeadSmallConv,
    MHAttentionMap,
    detr_tokens,
    dice_full,
    image_scale,
    l1_cost,
    mask_branch,
    matched_giou,
    normalize_boxes,
    take_rows,
    tile,
    world_count,
)
from pairnet_torch.models.layers import MLP
from pairnet_torch.models.losses import _global
from pairnet_torch.models.matchers import classification_cost
from pairnet_torch.ops.boxes import cxcywh_to_xyxy, generalized_box_iou
from pairnet_torch.ops.hungarian import batched_hungarian


class PSGFormerHead(nn.Module):
    def __init__(self, in_channels, num_classes=133, num_relations=56, num_obj_query=100,
                 num_rel_query=100, embed_dims=256, num_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, temp=0.1):
        super().__init__()
        C = embed_dims
        self.temp = temp
        self.input_proj = nn.Conv2d(in_channels[-1], C, 1)
        self.obj_query_embed = nn.Embedding(num_obj_query, C)
        self.rel_query_embed = nn.Embedding(num_rel_query, C)
        self.transformer = DETRTransformer(C, num_heads, num_encoder_layers, num_decoder_layers,
                                           decoders=("decoder1", "decoder2"))
        self.class_embed = nn.Linear(C, num_classes + 1)
        self.box_embed = DetrMLP(C, C, 4, 3)
        self.sub_query_update = MLP(C, C, C, 2)
        self.obj_query_update = MLP(C, C, C, 2)
        self.rel_cls_embed = MLP(C, C, num_relations + 1, 2)
        self.bbox_attention = MHAttentionMap(C, C, num_heads)
        self.mask_head = MaskHeadSmallConv(
            C + num_heads, [in_channels[2], in_channels[1], in_channels[0]], C)

    def forward(self, feats):
        proj = self.input_proj(feats[-1])
        tokens, pos = detr_tokens(proj)
        (obj_outs, rel_outs), memory = self.transformer(
            tokens, pos, self.obj_query_embed.weight, self.rel_query_embed.weight)
        obj_last, rel_last = obj_outs[-1], rel_outs[-1]
        cls_layers = [self.class_embed(o) for o in obj_outs]
        box_layers = [torch.sigmoid(self.box_embed(o)) for o in obj_outs]
        cls_pred, box_pred = cls_layers[-1], box_layers[-1]
        seg_masks = mask_branch(proj, memory, obj_last, self.bbox_attention, self.mask_head,
                                feats)
        subject_scores, object_scores = prototype_scores(
            rel_last, self.sub_query_update(obj_last), self.obj_query_update(obj_last),
            self.temp)
        sub_ids = subject_scores.argmax(-1)
        obj_ids = object_scores.argmax(-1)
        return {
            "cls": cls_pred,
            "box": box_pred,
            "cls_layers": cls_layers,
            "box_layers": box_layers,
            "mask": seg_masks,
            "rel": self.rel_cls_embed(rel_last),
            "subject_scores": subject_scores,
            "object_scores": object_scores,
            "sub": take_rows(cls_pred, sub_ids),
            "obj": take_rows(cls_pred, obj_ids),
            "sub_box": take_rows(box_pred, sub_ids),
            "obj_box": take_rows(box_pred, obj_ids),
            "sub_seg": take_rows(seg_masks, sub_ids),
            "obj_seg": take_rows(seg_masks, obj_ids),
            "sub_pos": sub_ids,
            "obj_pos": obj_ids,
            "queries": obj_last,
        }


def psgformer_loss(outputs, batch, num_classes=133, cls_weight=4.0, box_l1_weight=3.0,
                   giou_weight=2.0, rel_weight=2.0, id_loss_weight=2.0, dice_weight=1.0,
                   aux_layers=True, reduce=None):
    """PSGFormer losses: the DETR object branch per layer and the
    prototype-matching relation branch on the last. The loss dict with
    ``loss_total``."""
    B, Q, _ = outputs["cls"].shape
    gt_labels = batch["gt_labels"].long()
    G = gt_labels.shape[1]
    n_layers = len(outputs["cls_layers"])
    layer_ids = list(range(n_layers)) if aux_layers else [n_layers - 1]
    gt_n = normalize_boxes(batch["gt_boxes"], batch["image_shape"])
    scale = image_scale(batch["image_shape"])
    gt_valid = batch["gt_valid"].bool()

    with torch.no_grad():  # every layer's object assignment in one call
        nl = len(layer_ids)
        cls_p = torch.cat([outputs["cls_layers"][li].detach() for li in layer_ids])
        box_p = torch.cat([outputs["box_layers"][li].detach() for li in layer_ids])
        cost = (cls_weight * classification_cost(cls_p, tile(gt_labels, nl))
                + box_l1_weight * l1_cost(box_p, tile(gt_n, nl))
                + giou_weight * -generalized_box_iou(cxcywh_to_xyxy(box_p) * tile(scale, nl),
                                                     tile(batch["gt_boxes"].float(), nl)))
        q2g_all, g2q_all = batched_hungarian(cost, col_mask=tile(gt_valid, nl))

    losses = {}
    for n, li in enumerate(layer_ids):
        q2g = q2g_all[n * B:(n + 1) * B]
        cls_l, box_l = outputs["cls_layers"][li], outputs["box_layers"][li]
        pos = q2g >= 0
        safe = q2g.clamp(0, G - 1)
        w = pos.float()
        npos = _global(w.sum(), reduce).clamp_min(1.0)
        lbl_t = torch.where(pos, torch.gather(gt_labels, 1, safe), num_classes)
        logp = torch.log_softmax(cls_l.float(), dim=-1)
        nll = -torch.gather(logp, -1, lbl_t[..., None])[..., 0]
        box_t = take_rows(gt_n, safe)
        l1 = (box_l - box_t).abs().sum(-1)
        g = matched_giou(box_l, box_t, scale)
        tag = "" if li == n_layers - 1 else f"d{li}."
        losses[f"{tag}loss_cls"] = cls_weight * nll.sum() / world_count(nll.numel(), reduce)
        losses[f"{tag}loss_bbox"] = box_l1_weight * torch.sum(l1 * w) / npos
        losses[f"{tag}loss_iou"] = giou_weight * torch.sum((1.0 - g) * w) / npos
    # the last layer: mask dice on matched queries, then the relation branch
    gt_m = take_rows(batch["gt_masks"], safe)
    losses["loss_dice"] = dice_weight * torch.sum(dice_full(outputs["mask"], gt_m) * w) / npos
    gt_rels = batch["gt_rels"].long()
    Rm = gt_rels.shape[1]
    with torch.no_grad():
        ok, gt_sub_q, gt_obj_q = id_targets(g2q_all[-B:], gt_rels, batch["rel_valid"])
        relq2gt = id_assign(outputs["subject_scores"].detach(),
                            outputs["object_scores"].detach(), outputs["rel"].detach(),
                            gt_sub_q, gt_obj_q, gt_rels[..., 2], ok)
    rpos = relq2gt >= 0
    rsafe = relq2gt.clamp(0, Rm - 1)
    r_lbl = torch.where(rpos, torch.gather(gt_rels[..., 2], 1, rsafe), 0)
    logp_r = torch.log_softmax(outputs["rel"].float(), dim=-1)
    nll_r = -torch.gather(logp_r, -1, r_lbl[..., None])[..., 0]
    losses["r_loss_cls"] = rel_weight * nll_r.sum() / world_count(nll_r.numel(), reduce)
    sub_tq = torch.where(rpos, torch.gather(gt_sub_q, 1, rsafe), -1)
    obj_tq = torch.where(rpos, torch.gather(gt_obj_q, 1, rsafe), -1)
    n_img = world_count(B, reduce)
    lsub = masked_multilabel_ce(outputs["subject_scores"], sub_tq, rpos, pos)
    lobj = masked_multilabel_ce(outputs["object_scores"], obj_tq, rpos, pos)
    losses["loss_subject_match"] = id_loss_weight * lsub.sum() / n_img
    losses["loss_object_match"] = id_loss_weight * lobj.sum() / n_img
    losses["loss_total"] = sum(losses.values())
    return losses


def psgformer_postprocess(outputs, image_index=None, num_things: int = 80):
    """The baseline head's top-k (query x predicate) protocol."""
    return baseline_postprocess(outputs, image_index, num_things)
