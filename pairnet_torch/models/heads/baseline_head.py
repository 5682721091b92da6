"""The Mask2Former baselines: PSGFormer+ ("CrossHeadBaseline", with or
without Seesaw: CrossHead4) and MyPSGFormer.

Counterpart of ``pairnet_tpu/models/heads/baseline_head.py`` with the
reference checkpoint's module names (as ``PairNetHead``: the query tables,
``cls_embed`` and ``mask_embed`` on the head, ``relation_decoder.layers``).
The Mask2Former segmenter runs with ``return_intermediate`` (its reference
route, in serving too); relation queries attend over the encoder memories
round-robin over the scales; subjects and objects are recovered by
prototype matching: cosine scores between the normalized relation queries
and normalized sub/obj projections of the object queries, over ``temp``
(1.0 for PSGFormer+, 0.1 for MyPSGFormer).

Training (``baseline_loss``): per decoder layer a mask Hungarian (cls 2,
point BCE 5, dice 5) and the class / mask / dice losses; at the last layer
the OldIdMatcher triplet assignment on (subject id, object id, predicate)
costs, the relation CE (or Seesaw) and the sub/obj id losses. Every
layer's mask assignment is one batched Hungarian call, the triplet
assignment a second.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.decoders.mask2former_decoder import DecoderLayer, Mask2FormerSegmenter
from pairnet_torch.models.heads.psgtr_head import take_rows, tile, world_count
from pairnet_torch.models.layers import MLP
from pairnet_torch.models.losses import (
    _global,
    naive_dice_loss,
    seesaw_ce,
    sigmoid_bce,
    softmax_ce,
)
from pairnet_torch.models.matchers import classification_cost, mask_hungarian_assign
from pairnet_torch.ops.hungarian import batched_hungarian
from pairnet_torch.ops.sampling import sample_mask_points


def l2_normalize(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def prototype_scores(rel_query, sub_embed, obj_embed, temp):
    """Cosine scores (B, K, Q) of the relation queries against the
    subject and object prototypes, over ``temp``."""
    rel_n = l2_normalize(rel_query)
    subject_scores = torch.einsum("bkc,bqc->bkq", rel_n, l2_normalize(sub_embed)) / temp
    object_scores = torch.einsum("bkc,bqc->bkq", rel_n, l2_normalize(obj_embed)) / temp
    return subject_scores, object_scores


class BaselineHead(Mask2FormerSegmenter):
    def __init__(self, in_channels, num_classes=133, num_relations=56, num_obj_query=100,
                 num_rel_query=100, embed_dims=256, num_heads=8, num_decoder_layers=9,
                 num_relation_layers=6, num_feat_levels=3, pixel_decoder_layers=6, temp=1.0):
        super().__init__(in_channels, num_classes, num_obj_query, embed_dims, num_heads,
                         num_decoder_layers, num_feat_levels, pixel_decoder_layers,
                         return_intermediate=True)
        C, K = embed_dims, num_rel_query
        self.temp = temp
        self.num_feat_levels = num_feat_levels
        self.rel_query_feat = nn.Embedding(K, C)
        self.rel_query_embed = nn.Embedding(K, C)
        self.sub_query_update = MLP(C, C, C, 3)
        self.obj_query_update = MLP(C, C, C, 3)
        self.rel_cls_embed = nn.Linear(C, num_relations + 1)  # a background column
        self.relation_decoder = nn.Module()  # reference naming: relation_decoder.layers.<i>
        self.relation_decoder.layers = nn.ModuleList(
            [DecoderLayer(C, num_heads, 2048) for _ in range(num_relation_layers)]
        )

    def forward(self, feats):
        dec, ms_feats, pos = self.segment(feats)
        queries = dec["queries"]
        B, _, C = queries.shape
        level_embed = self.level_embed.weight
        memories = [f.flatten(2).transpose(1, 2) + level_embed[lvl]
                    for lvl, f in enumerate(ms_feats)]
        mem_pos = [p.reshape(1, -1, C) for p in pos]
        rel_query = self.rel_query_feat.weight[None].expand(B, -1, -1)
        rel_pos = self.rel_query_embed.weight[None]
        for i, layer in enumerate(self.relation_decoder.layers):
            lvl = i % self.num_feat_levels
            rel_query = layer(rel_query, rel_pos, memories[lvl], mem_pos[lvl], None)

        subject_scores, object_scores = prototype_scores(
            rel_query, self.sub_query_update(queries), self.obj_query_update(queries), self.temp)
        sub_ids = subject_scores.argmax(-1)  # (B, K)
        obj_ids = object_scores.argmax(-1)
        cls_last, mask_last = dec["cls"], dec["mask"]
        return {
            "cls": cls_last,
            "mask": mask_last,
            "cls_layers": [c for c, _ in dec["intermediates"]],
            "mask_layers": [m for _, m in dec["intermediates"]],
            "rel": self.rel_cls_embed(rel_query),
            "subject_scores": subject_scores,
            "object_scores": object_scores,
            "sub": take_rows(cls_last, sub_ids),
            "obj": take_rows(cls_last, obj_ids),
            "sub_seg": take_rows(mask_last, sub_ids),
            "obj_seg": take_rows(mask_last, obj_ids),
            "sub_pos": sub_ids,
            "obj_pos": obj_ids,
            "queries": queries,
        }


class MyPSGFormerHead(BaselineHead):
    """PSGFormer on the Mask2Former pixel decoder: the PSGFormer+
    architecture with temperature-scaled (0.1) prototype matching."""

    def __init__(self, in_channels, temp=0.1, **kw):
        super().__init__(in_channels, temp=temp, **kw)


# --------------------------------------------------------------------- training


def masked_multilabel_ce(scores, target_q, row_mask, col_mask):
    """MultilabelCrossEntropy over a column subset, per image: scores (B,
    K, Q); softmax over the columns where ``col_mask`` (B, Q); the target
    is the one column ``target_q`` (B, K); the mean over the rows where
    ``row_mask`` (B, K). Returns (B,)."""
    masked = torch.where(col_mask[:, None, :], scores, torch.full_like(scores, -1e9))
    logp = torch.log_softmax(masked.float(), dim=-1)
    t = target_q.clamp(0, scores.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    w = row_mask.float()
    return torch.sum(nll * w, dim=-1) / w.sum(-1).clamp_min(1.0)


def id_targets(gt2query, gt_rels, rel_valid):
    """OldIdMatcher's GT side from a mask assignment: (rel_ok (B, Rm), the
    subject and object query of every GT relation (0 where not ok))."""
    G = gt2query.shape[1]
    sub_q = torch.gather(gt2query, 1, gt_rels[..., 0].clamp(0, G - 1))
    obj_q = torch.gather(gt2query, 1, gt_rels[..., 1].clamp(0, G - 1))
    ok = rel_valid.bool() & (sub_q >= 0) & (obj_q >= 0)
    return ok, torch.where(ok, sub_q, 0), torch.where(ok, obj_q, 0)


def id_assign(subject_scores, object_scores, rel_scores, gt_sub_q, gt_obj_q, gt_rel, ok):
    """OldIdMatcher (costs 1 / 1 / 1 on subject id, object id, predicate):
    relq2gt (B, K)."""
    cost = (classification_cost(subject_scores, gt_sub_q)
            + classification_cost(object_scores, gt_obj_q)
            + classification_cost(rel_scores, gt_rel))
    return batched_hungarian(cost, col_mask=ok)[0]


def layer_mask_assign(cls_layers, mask_layers, batch, points):
    """The mask Hungarian of every layer in one call: (query2gt, gt2query,
    gt_pts), the first two (L, B, Q) / (L, B, G) and the GT masks at the
    points (B, G, P)."""
    L = len(cls_layers)
    gt_pts = sample_mask_points(batch["gt_masks"].float(), points)
    with torch.no_grad():
        cls = torch.cat([c.detach() for c in cls_layers])
        pts = torch.cat([sample_mask_points(m.detach(), points) for m in mask_layers])
        assign = mask_hungarian_assign(cls, pts, tile(batch["gt_labels"].long(), L),
                                       tile(gt_pts, L), tile(batch["gt_valid"].bool(), L))
    B = cls_layers[0].shape[0]
    return (assign.query2gt.reshape(L, B, -1), assign.gt2query.reshape(L, B, -1), gt_pts)


def baseline_loss(outputs, batch, points, cum_samples=None, cls_loss_weight=2.0,
                  mask_loss_weight=5.0, dice_loss_weight=5.0, rel_loss_weight=2.0,
                  id_loss_weight=2.0, bg_class_weight=0.1, rel_bg_weight=0.02,
                  use_seesaw=False, reduce=None):
    """The PSGFormer+ losses: (loss dict with ``loss_total``, new
    cum_samples). ``points`` (B, P, 2) are the mask samples of every layer.
    With ``use_seesaw`` (CrossHead4) the relation loss is Seesaw CE over
    R + 1 classes carrying ``cum_samples``; otherwise ``cum_samples`` comes
    back unchanged. The decoder's intermediates already hold the final
    layer and JAX appends it once more: the loss runs over L + 1 layers, the
    last two equal, as JAX's does."""
    B, K, R1 = outputs["rel"].shape
    Cp1 = outputs["cls"].shape[-1]
    G = batch["gt_labels"].shape[1]
    cls_layers = outputs["cls_layers"] + [outputs["cls"]]
    mask_layers = outputs["mask_layers"] + [outputs["mask"]]
    n_layers = len(cls_layers)
    q2g_all, g2q_all, gt_pts = layer_mask_assign(cls_layers, mask_layers, batch, points)
    class_weight = torch.ones(Cp1, device=points.device)
    class_weight[-1] = bg_class_weight
    gt_labels = batch["gt_labels"].long()

    losses = {}
    for li in range(n_layers):
        q2g = q2g_all[li]
        q_matched = q2g >= 0
        safe = q2g.clamp(0, G - 1)
        cls_t = torch.where(q_matched, torch.gather(gt_labels, 1, safe), Cp1 - 1)
        loss_cls = softmax_ce(cls_layers[li].reshape(-1, Cp1), cls_t.reshape(-1),
                              torch.ones(cls_t.numel(), device=cls_t.device),
                              class_weight=class_weight, reduce=reduce)
        pred_pts = sample_mask_points(mask_layers[li], points)
        gt_for_q = take_rows(gt_pts, safe)
        wq = q_matched.float().reshape(-1)
        n_matched = _global(wq.sum(), reduce)
        loss_mask = torch.sum(
            sigmoid_bce(pred_pts, gt_for_q).mean(-1).reshape(-1) * wq
        ) / n_matched.clamp_min(1.0)
        P = pred_pts.shape[-1]
        loss_dice = naive_dice_loss(pred_pts.reshape(-1, P), gt_for_q.reshape(-1, P), wq,
                                    reduce=reduce)
        tag = "" if li == n_layers - 1 else f"d{li}."
        losses[f"{tag}loss_cls"] = cls_loss_weight * loss_cls
        losses[f"{tag}loss_mask"] = mask_loss_weight * loss_mask
        losses[f"{tag}loss_dice"] = dice_loss_weight * loss_dice

    # the last layer's triplet assignment and relation losses
    gt_rels = batch["gt_rels"].long()
    Rm = gt_rels.shape[1]
    with torch.no_grad():
        ok, gt_sub_q, gt_obj_q = id_targets(g2q_all[-1], gt_rels, batch["rel_valid"])
        relq2gt = id_assign(outputs["subject_scores"].detach(),
                            outputs["object_scores"].detach(), outputs["rel"].detach(),
                            gt_sub_q, gt_obj_q, gt_rels[..., 2], ok)
    r_pos = relq2gt >= 0
    rsafe = relq2gt.clamp(0, Rm - 1)
    r_labels = torch.where(r_pos, torch.gather(gt_rels[..., 2], 1, rsafe), 0).reshape(-1)
    rel = outputs["rel"].reshape(-1, R1)
    if use_seesaw:
        loss_r, cum_samples = seesaw_ce(rel, r_labels, torch.ones(B * K, device=rel.device),
                                        cum_samples, reduce=reduce)
    else:
        rel_class_weight = torch.ones(R1, device=rel.device)
        rel_class_weight[0] = rel_bg_weight
        loss_r = softmax_ce(rel, r_labels, torch.ones(B * K, device=rel.device),
                            class_weight=rel_class_weight, reduce=reduce)
    losses["r_loss_cls"] = rel_loss_weight * loss_r
    sub_tq = torch.where(r_pos, torch.gather(gt_sub_q, 1, rsafe), -1)
    obj_tq = torch.where(r_pos, torch.gather(gt_obj_q, 1, rsafe), -1)
    q_matched = q2g_all[-1] >= 0
    n_img = world_count(B, reduce)
    lsub = masked_multilabel_ce(outputs["subject_scores"], sub_tq, r_pos, q_matched)
    lobj = masked_multilabel_ce(outputs["object_scores"], obj_tq, r_pos, q_matched)
    losses["loss_subject_match"] = id_loss_weight * lsub.sum() / n_img
    losses["loss_object_match"] = id_loss_weight * lobj.sum() / n_img
    losses["loss_total"] = sum(losses.values())
    return losses, cum_samples


# ------------------------------------------------------------------ inference


def baseline_postprocess(outputs, image_index=None, num_things: int = 80):
    """Top-k over (relation query x predicate) probabilities; masks at
    sigmoid > 0.5; the panoptic map from the object queries'
    ``panoptic_fusion``."""
    from pairnet_torch.models.heads.pairnet_inference import TripletPrediction, panoptic_fusion

    b = image_index
    get = (lambda x: x[b]) if b is not None else (lambda x: x)
    r_cls = get(outputs["rel"])
    K, R1 = r_cls.shape
    R = R1 - 1
    dev = r_cls.device
    r_lgs = torch.softmax(r_cls.float(), dim=-1)
    flat = r_lgs[:, 1:].reshape(-1)
    idx = torch.topk(flat, K).indices
    r_labels = idx % R + 1
    tri = torch.div(idx, R, rounding_mode="floor")

    def labels(x):
        return torch.softmax(x.float(), dim=-1)[:, :-1].argmax(-1) + 1

    s_seg = get(outputs["sub_seg"])[tri]
    o_seg = get(outputs["obj_seg"])[tri]
    fusion = panoptic_fusion(get(outputs["cls"]), get(outputs["mask"]), num_things)
    ar = torch.arange(K, device=dev)
    return TripletPrediction(
        labels=torch.cat([labels(get(outputs["sub"])[tri]), labels(get(outputs["obj"])[tri])]),
        rel_pairs=torch.stack([ar, ar + K], dim=-1),
        masks=torch.cat([torch.sigmoid(s_seg) > 0.5, torch.sigmoid(o_seg) > 0.5]),
        pan_seg=fusion.pan_seg,
        r_dists=r_lgs[tri],
        r_labels=r_labels,
        r_scores=flat[idx],
    )
