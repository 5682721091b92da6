"""Two-stage relation heads: MOTIFS, IMP, GPS-Net over a shared frontend.

Counterpart of ``pairnet_tpu/models/heads/twostage/heads.py``:

* the frontend: RoI features of the (GT or detected) boxes and union
  features of the pairs, batched over the images;
* :class:`MotifHead`: LSTMContext -> post_emb -> head/tail -> pair concat ->
  post_cat -> union gating -> rel_compress (+ FrequencyBias);
* :class:`IMPHead`: GRU message passing giving object and relation scores;
* :class:`GPSHead`: DMP context + the fused relation inference;
* :func:`twostage_loss`: CE on the refined object scores + CE on the
  relation labels; :func:`twostage_postprocess`: triplet score = rel prob
  x sub score x obj score, ranked on the host by numpy's own
  ``argsort(-score)``, as JAX ranks.

Batch contract (tensors): ``det_boxes`` (B, N, 4), ``det_labels`` (B, N)
1-based with 0 background, ``det_valid`` (B, N), ``pairs`` (B, P, 2),
``pair_valid`` (B, P), ``pair_labels`` (B, P), ``image_shape`` (B, 2),
``det_dists`` (B, N, C) in sgdet.

The MOTIFS, GPS-Net and VCTree heads outside predcls embed ``det_dists``, a
detector's class distributions over the boxes (upstream runs the detector's
box classifier on the GT boxes in sgcls). GT-box batches carry none, and
JAX's heads fail there (a ``None @ table``); the port's raise a
``ValueError``: the one-hot of ``det_labels`` in their place would hand the
head the ground truth it is scored on. IMP reads no ``det_dists``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.heads.twostage.contexts import (
    DMPContext,
    IMPContext,
    LSTMContext,
)
from pairnet_torch.models.heads.twostage.core import (
    FrequencyBias,
    VisualSpatialExtractor,
    take,
    union_boxes,
)
from pairnet_torch.models.losses import softmax_ce

TWO_STAGE_HEADS = ("MotifHead", "IMPHead", "GPSHead", "VCTreeHead")


class TwoStageRelationHead(nn.Module):
    """Shared frontend and mode handling; subclasses implement ``predict``."""

    def __init__(self, num_classes: int = 134, num_predicates: int = 57, mode: str = "predcls",
                 hidden_dim: int = 512, roi_dim: int = 1024, context_pooling_dim: int = 4096,
                 embed_dim: int = 200, use_bias: bool = False, use_vision: bool = True,
                 in_channels: int = 256):
        super().__init__()
        self.num_classes, self.num_predicates, self.mode = num_classes, num_predicates, mode
        self.hidden_dim, self.roi_dim = hidden_dim, roi_dim
        self.context_pooling_dim, self.embed_dim = context_pooling_dim, embed_dim
        self.use_bias, self.use_vision = use_bias, use_vision
        self.bbox_roi_extractor = VisualSpatialExtractor(roi_dim, in_channels)
        self.relation_roi_extractor = VisualSpatialExtractor(roi_dim, in_channels,
                                                             with_spatial=True)
        if use_bias:
            self.freq_bias = FrequencyBias(num_classes - 1, num_predicates)

    def frontend(self, fpn_feats, batch):
        """RoI (B, N, roi_dim) and union (B, P, roi_dim) features; fpn_feats
        (B, H_l, W_l, C) per level."""
        boxes, pairs = batch["det_boxes"].float(), batch["pairs"]
        roi = self.bbox_roi_extractor(fpn_feats, boxes)
        union = self.relation_roi_extractor(
            fpn_feats, union_boxes(boxes, pairs), img_hw=batch["image_shape"],
            sub_rois=take(boxes, pairs[..., 0]), obj_rois=take(boxes, pairs[..., 1]))
        return roi, union

    def det_dists(self, batch):
        """The batch's ``det_dists``; raises where it has none."""
        if batch.get("det_dists") is None:
            raise ValueError(
                f"{type(self).__name__} in {self.mode} embeds batch['det_dists'] (a detector's "
                "class distributions over the boxes), and this batch has none: GT-box batches "
                "carry none, and neither package computes them on the GT boxes")
        return batch["det_dists"]

    def pair_bias(self, obj_preds, pairs):
        pair_pred = torch.stack([take(obj_preds, pairs[..., 0]), take(obj_preds, pairs[..., 1])],
                                -1)
        return self.freq_bias(pair_pred)

    def forward(self, fpn_feats, batch):
        roi_feats, union_feats = self.frontend(fpn_feats, batch)
        return self.predict(roi_feats, union_feats, batch)


class _PostDecode(TwoStageRelationHead):
    """MOTIFS-style post decode of per-object edge contexts (MOTIFS, VCTree)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.post_emb = nn.Linear(self.hidden_dim, self.hidden_dim * 2)
        self.post_cat = nn.Linear(self.hidden_dim * 2, self.context_pooling_dim)
        self.rel_compress = nn.Linear(self.context_pooling_dim, self.num_predicates)
        if self.context_pooling_dim != self.roi_dim:
            self.up_dim = nn.Linear(self.roi_dim, self.context_pooling_dim)

    def post_decode(self, edge_ctx, obj_preds, union_feats, batch):
        B, N, _ = edge_ctx.shape
        edge_rep = self.post_emb(edge_ctx).reshape(B, N, 2, self.hidden_dim)
        pairs = batch["pairs"]
        prod = torch.cat([take(edge_rep[:, :, 0], pairs[..., 0]),
                          take(edge_rep[:, :, 1], pairs[..., 1])], -1)
        prod = self.post_cat(prod)
        if self.use_vision:
            u = self.up_dim(union_feats) if hasattr(self, "up_dim") else union_feats
            prod = prod * u
        rel_scores = self.rel_compress(prod)
        if self.use_bias:
            rel_scores = rel_scores + self.pair_bias(obj_preds, pairs).to(rel_scores.dtype)
        return rel_scores


class MotifHead(_PostDecode):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.context_layer = LSTMContext(self.num_classes, mode=self.mode,
                                         embed_dim=self.embed_dim, hidden_dim=self.hidden_dim,
                                         roi_dim=self.roi_dim)

    def predict(self, roi_feats, union_feats, batch):
        obj_dists, obj_preds, edge_ctx = self.context_layer(
            roi_feats, batch["det_boxes"].float(), batch["det_valid"], batch["image_shape"],
            labels=batch.get("det_labels"),
            dists=None if self.mode == "predcls" else self.det_dists(batch))
        return {"refine_scores": obj_dists, "obj_preds": obj_preds,
                "rel_scores": self.post_decode(edge_ctx, obj_preds, union_feats, batch)}


class IMPHead(TwoStageRelationHead):
    def __init__(self, num_iter: int = 2, **kw):
        super().__init__(**kw)
        self.context_layer = IMPContext(self.num_classes, self.num_predicates, self.roi_dim,
                                        hidden_dim=self.hidden_dim, num_iter=num_iter,
                                        mode=self.mode)

    def predict(self, roi_feats, union_feats, batch):
        obj_dists, rel_scores = self.context_layer(
            roi_feats, union_feats, batch["pairs"], batch["det_valid"], batch["pair_valid"],
            labels=batch.get("det_labels"))
        if self.mode == "predcls":
            obj_preds = batch["det_labels"]
        else:
            obj_preds = obj_dists[..., 1:].argmax(-1).int() + 1
        if self.use_bias:
            rel_scores = rel_scores + self.pair_bias(obj_preds, batch["pairs"]).to(
                rel_scores.dtype)
        return {"refine_scores": obj_dists, "obj_preds": obj_preds, "rel_scores": rel_scores}


class GPSHead(TwoStageRelationHead):
    def __init__(self, **kw):
        super().__init__(**kw)
        D, R = self.roi_dim, self.num_predicates
        self.context_layer = DMPContext(self.num_classes, D, embed_dim=self.embed_dim,
                                        obj_dim=D, mode=self.mode)
        # fused relation inference: t1/t2 project the sub/obj contexts, t3 the
        # union; t4 = relu(t1 + t2) - (t1 - t2)^2; rel = out_rel(relu(t4 + t3) - (t4 - t3)^2)
        self.w_proj1 = nn.Linear(D, D)
        self.w_proj2 = nn.Linear(D, D)
        self.w_proj3 = nn.Linear(D, D)
        self.out_rel = nn.Linear(D, R)
        if self.use_bias:
            self.wp = nn.Linear(D, R)

    def predict(self, roi_feats, union_feats, batch):
        obj_dists, ctx = self.context_layer(
            roi_feats, union_feats, batch["pairs"], batch["det_boxes"].float(),
            batch["det_valid"], batch["pair_valid"], batch["image_shape"],
            labels=batch.get("det_labels"),
            dists=None if self.mode == "predcls" else self.det_dists(batch))
        if self.mode == "predcls":
            obj_preds = batch["det_labels"]
        else:
            obj_preds = obj_dists[..., 1:].argmax(-1).int() + 1
        pairs = batch["pairs"]
        t1 = self.w_proj1(take(ctx, pairs[..., 0]))
        t2 = self.w_proj2(take(ctx, pairs[..., 1]))
        t3 = self.w_proj3(union_feats)
        t4 = F.relu(t1 + t2) - (t1 - t2) * (t1 - t2)
        rel_scores = self.out_rel(F.relu(t4 + t3) - (t4 - t3) * (t4 - t3))
        if self.use_bias:
            # additive bias: sigmoid(wp(union)) x the log-softmaxed frequency row
            log_freq = torch.log_softmax(self.pair_bias(obj_preds, pairs).to(rel_scores.dtype),
                                         -1)
            rel_scores = rel_scores + torch.sigmoid(self.wp(union_feats)) * log_freq
        return {"refine_scores": obj_dists, "obj_preds": obj_preds, "rel_scores": rel_scores}


def twostage_loss(outputs, batch, obj_loss_weight: float = 1.0, rel_loss_weight: float = 1.0,
                  reduce=None):
    """CE on the refined object scores (valid objects) + CE on the relation
    labels (valid pairs). ``reduce`` sums the normalizers over the
    data-parallel ranks (None: world size 1)."""
    C = outputs["refine_scores"].shape[-1]
    R = outputs["rel_scores"].shape[-1]
    loss_obj = softmax_ce(outputs["refine_scores"].reshape(-1, C).float(),
                          batch["det_labels"].reshape(-1).long(),
                          batch["det_valid"].float().reshape(-1), reduce=reduce)
    loss_rel = softmax_ce(outputs["rel_scores"].reshape(-1, R).float(),
                          batch["pair_labels"].reshape(-1).long(),
                          batch["pair_valid"].float().reshape(-1), reduce=reduce)
    losses = {"loss_refine_obj": obj_loss_weight * loss_obj,
              "loss_rel": rel_loss_weight * loss_rel}
    losses["loss_total"] = losses["loss_refine_obj"] + losses["loss_rel"]
    return losses


def twostage_postprocess(outputs, batch, image_index: int) -> dict:
    """PostProcessor semantics for image ``image_index``: per pair the
    triplet score max-rel-prob (background zeroed) x sub x obj object
    scores, the valid pairs ranked descending on the host. Returns numpy
    ``rel_pair_idxes``, ``rel_dists``, ``labels``, ``obj_scores``."""
    b = image_index
    rel = torch.softmax(torch.as_tensor(outputs["rel_scores"][b]).float(), -1)
    rel[:, 0] = 0.0
    refine = torch.softmax(torch.as_tensor(outputs["refine_scores"][b]).float(), -1)
    pairs = np.asarray(torch.as_tensor(batch["pairs"][b]).cpu())
    pv = np.asarray(torch.as_tensor(batch["pair_valid"][b]).cpu())
    obj_scores = refine[:, 1:].amax(-1).cpu().numpy()
    obj_labels = np.asarray(torch.as_tensor(outputs["obj_preds"][b]).cpu())
    rel_np = rel.cpu().numpy()
    trip = rel_np.max(-1) * obj_scores[pairs[:, 0]] * obj_scores[pairs[:, 1]]
    trip = np.where(pv, trip, -1.0)
    order = np.argsort(-trip)
    order = order[pv[order]]
    return {"rel_pair_idxes": pairs[order], "rel_dists": rel_np[order], "labels": obj_labels,
            "obj_scores": obj_scores}
