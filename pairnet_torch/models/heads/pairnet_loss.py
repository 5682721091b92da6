"""Pair-Net training targets and losses (batched, on the device, fixed shapes).

Counterpart of ``pairnet_tpu/models/heads/pairnet_loss.py``. Loss dict
(weights of the reference config):

* ``loss_r_cls``: Seesaw CE over matched relation queries (2.0);
* ``loss_sub_cls`` / ``loss_obj_cls``: CE on matched slots (4.0). Their
  inputs are the head's detached gathers, so they train nothing;
* ``loss_match``: BCE-with-logits on the importance matrix, pos_weight =
  numel / positives over the whole batch (5.0);
* with ``with_seg_losses``: class CE with background weight 0.1 (2.0),
  point-sampled mask BCE (5.0) and naive dice (5.0) on matched queries.

Targets are built under ``torch.no_grad()`` from detached outputs. The
sampling points come from the caller (the train step's generator), so a
test can hand both packages the same points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pairnet_torch.models.losses import (
    bce_with_logits_pos_weight,
    naive_dice_loss,
    seesaw_ce,
    sigmoid_bce,
    softmax_ce,
)
from pairnet_torch.models.matchers import (
    id_match,
    mask_hungarian_assign,
    sample_points_for_matching,
)
from pairnet_torch.ops.sampling import sample_mask_points
from pairnet_torch.parallel.mesh import world_info


class PairNetTargets(NamedTuple):
    r_labels: torch.Tensor  # (B, K) 0-based predicate or -1
    r_weights: torch.Tensor  # (B, K) {0, 1}
    sub_ids: torch.Tensor  # (B, K) gt subject class or -1
    obj_ids: torch.Tensor  # (B, K)
    gt_importance: torch.Tensor  # (B, Q, Q) {0, 1}
    query2gt: torch.Tensor  # (B, Q) matched gt per query or -1
    mask_pts: torch.Tensor  # (B, Q, P) predicted mask logits at the points
    gt_pts: torch.Tensor  # (B, G, P) gt masks {0, 1} at the points


@torch.no_grad()
def pairnet_targets(outputs, batch, points) -> PairNetTargets:
    """Targets of a batch. ``points``: (B, P, 2) uniform samples in [0, 1]."""
    cls_pred = outputs["cls"].detach()
    B, Q = cls_pred.shape[:2]
    gt_labels = batch["gt_labels"].long()
    gt_rels = batch["gt_rels"].long()
    G, Rm = gt_labels.shape[1], gt_rels.shape[1]

    mask_pts, gt_pts = sample_points_for_matching(outputs["mask"].detach(),
                                                  batch["gt_masks"], points)
    assign = mask_hungarian_assign(cls_pred, mask_pts, gt_labels, gt_pts, batch["gt_valid"])
    gt2query = assign.gt2query  # (B, G)

    sub_gt = gt_rels[..., 0].clamp(0, G - 1)
    obj_gt = gt_rels[..., 1].clamp(0, G - 1)
    sub_q = torch.gather(gt2query, 1, sub_gt)
    obj_q = torch.gather(gt2query, 1, obj_gt)
    rel_ok = batch["rel_valid"].bool() & (sub_q >= 0) & (obj_q >= 0)
    # binary importance at the matched (subject, object) query pairs;
    # invalid relations land in a dropped extra row and column
    gt_importance = torch.zeros((B, Q + 1, Q + 1), device=cls_pred.device)
    rows = torch.arange(B, device=cls_pred.device)[:, None].expand(B, Rm)
    gt_importance[rows, torch.where(rel_ok, sub_q, Q), torch.where(rel_ok, obj_q, Q)] = 1.0
    gt_importance = gt_importance[:, :Q, :Q]

    gt_sub_cls = torch.gather(gt_labels, 1, sub_gt)
    gt_obj_cls = torch.gather(gt_labels, 1, obj_gt)
    gt_rel_label = gt_rels[..., 2] - 1  # 1-based -> 0-based predicate

    idres = id_match(outputs["sub"].detach(), outputs["obj"].detach(),
                     outputs["rel"].detach(), gt_sub_cls, gt_obj_cls, gt_rel_label, rel_ok)
    matched = idres.relq2gt  # (B, K)
    safe = matched.clamp(0, Rm - 1)
    pos = matched >= 0
    neg1 = torch.full_like(matched, -1)
    return PairNetTargets(
        r_labels=torch.where(pos, torch.gather(gt_rel_label, 1, safe), neg1),
        r_weights=pos.float(),
        sub_ids=torch.where(pos, torch.gather(gt_sub_cls, 1, safe), neg1),
        obj_ids=torch.where(pos, torch.gather(gt_obj_cls, 1, safe), neg1),
        gt_importance=gt_importance,
        query2gt=assign.query2gt,
        mask_pts=mask_pts,
        gt_pts=gt_pts,
    )


def pairnet_loss(outputs, batch, points, cum_samples, rel_loss_weight=2.0,
                 subobj_loss_weight=4.0, match_loss_weight=5.0, with_seg_losses=False,
                 cls_loss_weight=2.0, mask_loss_weight=5.0, dice_loss_weight=5.0,
                 bg_class_weight=0.1, targets: PairNetTargets | None = None, reduce=None):
    """The Pair-Net loss: (loss dict with ``loss_total``, new cum_samples).

    ``points`` (B, P, 2) are the point samples of the mask costs;
    ``cum_samples`` is the Seesaw running class-count state. ``targets``
    replaces the target building (a replay of another run's targets).
    ``reduce`` sums a tensor over the data-parallel ranks: every normalizer
    is then the global batch's (see ``models/losses.py``)."""
    B, K, R = outputs["rel"].shape
    Cp1 = outputs["cls"].shape[-1]
    t = pairnet_targets(outputs, batch, points) if targets is None else targets

    w = t.r_weights.reshape(-1)
    loss_sub = softmax_ce(outputs["sub"].reshape(-1, Cp1), t.sub_ids.reshape(-1), w,
                          reduce=reduce)
    loss_obj = softmax_ce(outputs["obj"].reshape(-1, Cp1), t.obj_ids.reshape(-1), w,
                          reduce=reduce)
    loss_r, new_cum = seesaw_ce(outputs["rel"].reshape(-1, R), t.r_labels.reshape(-1), w,
                                cum_samples, reduce=reduce)
    npos = (t.gt_importance > 0).sum().float()
    # the global batch's elements: every rank holds B rows (rank_rows and the
    # loader refuse a batch that does not divide)
    numel = t.gt_importance.numel() * (1 if reduce is None else world_info()[1])
    pos_weight = numel / (npos if reduce is None else reduce(npos)).clamp_min(1.0)
    loss_match = bce_with_logits_pos_weight(outputs["importance"], t.gt_importance, pos_weight,
                                            numel=numel)

    losses = {
        "loss_r_cls": rel_loss_weight * loss_r,
        "loss_sub_cls": subobj_loss_weight * loss_sub,
        "loss_obj_cls": subobj_loss_weight * loss_obj,
        "loss_match": match_loss_weight * loss_match,
    }

    if with_seg_losses:
        # query -> class target: matched queries take the gt label, the rest background
        q2g = t.query2gt  # (B, Q)
        G = batch["gt_labels"].shape[1]
        safe = q2g.clamp(0, G - 1)
        matched = q2g >= 0
        cls_t = torch.where(matched, torch.gather(batch["gt_labels"].long(), 1, safe), Cp1 - 1)
        class_weight = torch.ones(Cp1, device=cls_t.device)
        class_weight[-1] = bg_class_weight
        loss_cls = softmax_ce(outputs["cls"].reshape(-1, Cp1), cls_t.reshape(-1),
                              torch.ones(cls_t.numel(), device=cls_t.device),
                              class_weight=class_weight, reduce=reduce)
        # mask losses on the shared points, matched queries only; the
        # targets' mask_pts are detached, so sample again with gradient
        pred_pts = sample_mask_points(outputs["mask"], points)
        gt_for_query = torch.gather(
            t.gt_pts, 1, safe[..., None].expand(-1, -1, t.gt_pts.shape[-1])
        )  # (B, Q, P)
        wq = matched.float().reshape(-1)
        n_matched = wq.sum() if reduce is None else reduce(wq.sum())
        loss_mask = torch.sum(
            sigmoid_bce(pred_pts, gt_for_query).mean(-1).reshape(-1) * wq
        ) / torch.clamp_min(n_matched, 1.0)
        loss_dice = naive_dice_loss(pred_pts.reshape(-1, pred_pts.shape[-1]),
                                    gt_for_query.reshape(-1, gt_for_query.shape[-1]), wq,
                                    reduce=reduce)
        losses["loss_cls"] = cls_loss_weight * loss_cls
        losses["loss_mask"] = mask_loss_weight * loss_mask
        losses["loss_dice"] = dice_loss_weight * loss_dice

    losses["loss_total"] = sum(losses.values())
    return losses, new_cum
