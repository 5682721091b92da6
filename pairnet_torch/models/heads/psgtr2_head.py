"""PSGTr2: PSGTr on the Mask2Former pixel decoder.

Counterpart of ``pairnet_tpu/models/heads/psgtr2_head.py``. The reference
has no checkpoint converter for it; the segmenter keeps Pair-Net's mmdet
names (its decoder takes the default resize-then-contract route, as in
JAX) and the rest mirrors the flax paths. Every query of the masked-
attention decoder predicts a triplet: subject / object / predicate classes
and subject / object masks from two mask-embed MLPs against the shared
stride-4 mask features. The object queries' own cls / mask feed the
panoptic fusion.

Training (``psgtr2_loss``): MaskHTriMatcher, Hungarian over summed class +
point-sampled mask BCE + dice costs of subject and object plus the
predicate's (s_cls 2, o_cls 1, masks 5 / 5, predicate 2), one batched call;
then class CE, point BCE and dice on matched queries.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.decoders.mask2former_decoder import Mask2FormerSegmenter
from pairnet_torch.models.heads.baseline_head import baseline_postprocess
from pairnet_torch.models.heads.psgtr_head import take_rows, weighted_ce, world_count
from pairnet_torch.models.layers import MLP
from pairnet_torch.models.losses import _global, naive_dice_loss, sigmoid_bce
from pairnet_torch.models.matchers import bce_mask_cost, classification_cost, dice_cost
from pairnet_torch.ops.hungarian import batched_hungarian
from pairnet_torch.ops.sampling import sample_mask_points


class PSGTr2Head(Mask2FormerSegmenter):
    def __init__(self, in_channels, num_classes=133, num_relations=56, num_query=100,
                 embed_dims=256, num_heads=8, num_decoder_layers=9, num_feat_levels=3,
                 pixel_decoder_layers=6):
        super().__init__(in_channels, num_classes, num_query, embed_dims, num_heads,
                         num_decoder_layers, num_feat_levels, pixel_decoder_layers)
        C = embed_dims
        self.sub_cls_embed = nn.Linear(C, num_classes + 1)
        self.obj_cls_embed = nn.Linear(C, num_classes + 1)
        self.rel_cls_embed = nn.Linear(C, num_relations + 1)
        self.sub_mask_embed = MLP(C, C, C, 3)
        self.obj_mask_embed = MLP(C, C, C, 3)

    def forward(self, feats):
        dec, _, _ = self.segment(feats)
        q, mf = dec["queries"], dec["mask_features"]

        def seg(embed):
            return torch.einsum("bqc,bchw->bqhw", embed(q).float(), mf.float())

        return {
            "sub": self.sub_cls_embed(q),
            "obj": self.obj_cls_embed(q),
            "rel": self.rel_cls_embed(q),
            "sub_seg": seg(self.sub_mask_embed),
            "obj_seg": seg(self.obj_mask_embed),
            "cls": dec["cls"],
            "mask": dec["mask"],
            "queries": q,
        }


def mask_htri_cost(s_cls, o_cls, r_cls, s_pts, o_pts, gt_s_pts, gt_o_pts, gt_s_lbl, gt_o_lbl,
                   gt_r_lbl):
    """MaskHTriMatcher's summed costs (B, Q, R)."""
    return (
        2.0 * classification_cost(s_cls, gt_s_lbl)
        + 5.0 * bce_mask_cost(s_pts, gt_s_pts)
        + 5.0 * dice_cost(s_pts, gt_s_pts)
        + 1.0 * classification_cost(o_cls, gt_o_lbl)
        + 5.0 * bce_mask_cost(o_pts, gt_o_pts)
        + 5.0 * dice_cost(o_pts, gt_o_pts)
        + 2.0 * classification_cost(r_cls, gt_r_lbl)
    )


def mask_htri_match(s_cls, o_cls, r_cls, s_pts, o_pts, gt_s_pts, gt_o_pts, gt_s_lbl, gt_o_lbl,
                    gt_r_lbl, rel_valid):
    """MaskHTriMatcher over a batch: relq2gt (B, Q)."""
    cost = mask_htri_cost(s_cls, o_cls, r_cls, s_pts, o_pts, gt_s_pts, gt_o_pts, gt_s_lbl,
                          gt_o_lbl, gt_r_lbl)
    return batched_hungarian(cost, col_mask=rel_valid.bool())[0]


def psgtr2_loss(outputs, batch, points, num_classes=133, bg_cls_weight=0.02, rel_weight=2.0,
                mask_weight=5.0, dice_weight=5.0, reduce=None):
    """Triplet losses with point-sampled mask supervision (the last layer):
    the loss dict with ``loss_total``. ``points`` (B, P, 2)."""
    G = batch["gt_labels"].shape[1]
    gt_rels = batch["gt_rels"].long()
    Rm = gt_rels.shape[1]
    gt_labels = batch["gt_labels"].long()
    sub_gt = gt_rels[..., 0].clamp(0, G - 1)
    obj_gt = gt_rels[..., 1].clamp(0, G - 1)
    gt_s_lbl, gt_o_lbl = torch.gather(gt_labels, 1, sub_gt), torch.gather(gt_labels, 1, obj_gt)
    gt_r = gt_rels[..., 2]
    s_pts = sample_mask_points(outputs["sub_seg"], points)
    o_pts = sample_mask_points(outputs["obj_seg"], points)
    gt_pts = sample_mask_points(batch["gt_masks"].float(), points)
    gt_s_pts, gt_o_pts = take_rows(gt_pts, sub_gt), take_rows(gt_pts, obj_gt)
    with torch.no_grad():
        relq2gt = mask_htri_match(
            outputs["sub"].detach(), outputs["obj"].detach(), outputs["rel"].detach(),
            s_pts.detach(), o_pts.detach(), gt_s_pts, gt_o_pts, gt_s_lbl, gt_o_lbl, gt_r,
            batch["rel_valid"])
    pos = relq2gt >= 0
    safe = relq2gt.clamp(0, Rm - 1)
    w = pos.float()
    npos = _global(w.sum(), reduce).clamp_min(1.0)
    ones = torch.ones_like(w)
    s_t = torch.where(pos, torch.gather(gt_s_lbl, 1, safe), num_classes)
    o_t = torch.where(pos, torch.gather(gt_o_lbl, 1, safe), num_classes)
    r_t = torch.where(pos, torch.gather(gt_r, 1, safe), 0)
    n_all = float(max(world_count(w.numel(), reduce), 1))
    losses = {
        "s_loss_cls": weighted_ce(outputs["sub"], s_t, ones, npos, num_classes, bg_cls_weight),
        "o_loss_cls": weighted_ce(outputs["obj"], o_t, ones, npos, num_classes, bg_cls_weight),
        "r_loss_cls": rel_weight * weighted_ce(outputs["rel"], r_t, ones, n_all, 0,
                                               bg_cls_weight),
    }
    s_tgt, o_tgt = take_rows(gt_s_pts, safe), take_rows(gt_o_pts, safe)
    wq = w.reshape(-1)
    P = s_pts.shape[-1]
    for side, pts, tgt in (("s", s_pts, s_tgt), ("o", o_pts, o_tgt)):
        losses[f"{side}_loss_mask"] = mask_weight * (
            torch.sum(sigmoid_bce(pts, tgt).mean(-1).reshape(-1) * wq) / npos)
    for side, pts, tgt in (("s", s_pts, s_tgt), ("o", o_pts, o_tgt)):
        losses[f"{side}_loss_dice"] = dice_weight * naive_dice_loss(
            pts.reshape(-1, P), tgt.reshape(-1, P), wq, reduce=reduce)
    losses["loss_total"] = sum(losses.values())
    return losses


def psgtr2_postprocess(outputs, image_index=None, num_things: int = 80):
    """Top-k (query x predicate) inference, as the baseline head's."""
    return baseline_postprocess(outputs, image_index, num_things)
