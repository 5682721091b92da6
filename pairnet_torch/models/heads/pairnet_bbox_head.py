"""Pair-Net on Deformable-DETR boxes (``CrossHeadBBox``): the box-detector
head of the Visual Genome, Open Images V6 and COCO configs.

Counterpart of ``pairnet_tpu/models/heads/pairnet_bbox_head.py``, with the
reference checkpoint's module names (``convert_crosshead_bbox``): mmdet's
``ChannelMapper`` at the model's ``neck``; the ``DeformableDetrTransformer``
at ``bbox_head.transformer`` (``level_embeds``, ``encoder.layers``,
``decoder.layers``, ``enc_output(_norm)``, ``pos_trans_fc``/``_norm``); the
cloned ``cls_branches``/``reg_branches``, whose last entry scores the
encoder proposals; the PPN MLPs, the matrix learner, and the Relation
Fusion decoder with RMSNorm and a chunked SwiGLU FFN at
``relation_decoder.layers``.

Copied from the reference as it is, quirks included:

* ``as_two_stage`` is stored and never read: the encoder proposals and
  their top-k always initialise the decoder queries;
* the proposals and their top-k are ranked by the FIRST class logit;
* the final queries are re-ranked by a softmax over the QUERY axis, and the
  PPN reads them detached;
* the detection losses are not part of the Pair-Net loss; only
  ``detection_only`` training (:func:`deformable_detr_detection_loss`)
  trains them.

The three discrete steps (proposal top-k, query re-rank, pair top-k) keep
the lower index first among equal values, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.heads.matrix_learner import create_mapper
from pairnet_torch.models.heads.psgtr_head import image_scale, take_rows, tile, world_count
from pairnet_torch.models.layers import (
    FFN,
    LN_EPS,
    MLP,
    AttnSlot,
    MSDeformAttention,
    RMSNorm,
    encoder_reference_points,
    sine_positional_encoding,
)
from pairnet_torch.models.losses import _global, bce_with_logits_pos_weight, seesaw_ce, softmax_ce
from pairnet_torch.models.matchers import box_hungarian_assign, id_match
from pairnet_torch.models.necks.pixel_decoder import DeformableEncoderLayer
from pairnet_torch.ops.boxes import box_area, cxcywh_to_xyxy

MAPPER_GN_EPS = 1e-5  # ChannelMapper's GroupNorms (JAX pairnet_bbox_head.py:55, :65)
NUM_POS_FEATS = 128  # the proposal sine embedding's features per box coordinate


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x) - torch.log1p(-x)


def topk_first(x, k):
    """Indices of the ``k`` largest entries along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm of NCHW maps computed in flax's order: f32 statistics
    (the variance as E[x^2] - E[x]^2, floored at 0), then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, cast to x's
    type. torch's fused kernel computes ``x * s - mean * s + bias``, which
    loses ~1e-4 where a group's variance is ~0 (a one-channel group on a
    1x1 level)."""

    def forward(self, x):
        B, Cn = x.shape[:2]
        G = self.num_groups
        g = x.float().reshape(B, G, -1)
        mean = g.mean(-1, keepdim=True)
        var = (g.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps)[..., None] * self.weight.float().reshape(1, G, -1, 1)
        y = (g - mean).reshape(B, G, Cn // G, -1) * mul
        y = y + self.bias.float().reshape(1, G, -1, 1)
        return y.reshape(x.shape).to(x.dtype)


class ConvGN(nn.Module):
    """mmcv ConvModule(conv, GroupNorm(32, eps 1e-5)) of the ChannelMapper."""

    def __init__(self, cin, cout, kernel_size, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2)
        self.gn = GroupNorm(32, cout, eps=MAPPER_GN_EPS)

    def forward(self, x):
        return self.gn(self.conv(x))


class ChannelMapper(nn.Module):
    """mmdet ChannelMapper: a 1x1 conv + GN per input level, then stride-2
    3x3 extra levels up to ``num_outs``; the first extra conv reads the raw
    last backbone level, the next ones the previous extra level. Takes the
    backbone's levels and uses the last ``len(in_channels)`` of them."""

    def __init__(self, in_channels, out_channels=256, num_outs=4):
        super().__init__()
        self.convs = nn.ModuleList([ConvGN(c, out_channels, 1) for c in in_channels])
        self.extra_convs = nn.ModuleList([
            ConvGN(in_channels[-1] if j == 0 else out_channels, out_channels, 3, stride=2)
            for j in range(num_outs - len(in_channels))
        ])

    def forward(self, feats):
        feats = feats[len(feats) - len(self.convs):]
        outs = [conv(f) for conv, f in zip(self.convs, feats)]
        for j, extra in enumerate(self.extra_convs):
            outs.append(extra(feats[-1] if j == 0 else outs[-1]))
        return tuple(outs)


class DeformableDecoderLayer(nn.Module):
    """self_attn -> norm -> deformable cross_attn on box references -> norm
    -> ffn -> norm (mmcv ``DetrTransformerDecoderLayer`` naming)."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4, num_points=4,
                 feedforward_channels=1024):
        super().__init__()
        self.attentions = nn.ModuleList([
            AttnSlot(embed_dims, num_heads),
            MSDeformAttention(embed_dims, num_heads, num_levels, num_points),
        ])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])

    def forward(self, q, qpos, memory, ref_points, spatial_shapes):
        x = q + self.attentions[0](q + qpos, q + qpos, q)
        x = self.norms[0](x)
        x = self.attentions[1](x, memory, ref_points, spatial_shapes, query_pos=qpos)
        x = self.norms[1](x)
        return self.norms[2](x + self.ffns[0](x))


class ChunkSwiGLU(nn.Module):
    """mmcv FFN with a SwiGLU activation: one projection to
    ``feedforward_channels`` split into (x, gate) halves, ``silu(gate) * x``,
    then the output projection (at ``layers.0.0`` and ``layers.1``)."""

    def __init__(self, embed_dims=256, feedforward_channels=2048):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels)),
            nn.Linear(feedforward_channels // 2, embed_dims),
        )

    def forward(self, x):
        a, gate = self.layers[0](x).chunk(2, dim=-1)
        return self.layers[1](F.silu(gate) * a)


class RelationFusionLayerRMS(nn.Module):
    """Pre-norm relation decoder layer with RMSNorm and a chunked-SwiGLU FFN,
    no trailing norm: norm -> cross_attn -> norm -> self_attn -> norm -> ffn.
    Values stay raw (mmcv's attention ignores a value position)."""

    def __init__(self, embed_dims=256, num_heads=8, ffn_hidden=2048):
        super().__init__()
        self.attentions = nn.ModuleList([AttnSlot(embed_dims, num_heads) for _ in range(2)])
        self.norms = nn.ModuleList([RMSNorm(embed_dims) for _ in range(3)])
        self.ffns = nn.ModuleList([ChunkSwiGLU(embed_dims, ffn_hidden)])

    def forward(self, q, qpos, memory, key_pos):
        n1 = self.norms[0](q)
        x = q + self.attentions[0](n1 + qpos, memory + key_pos, memory)
        n2 = self.norms[1](x)
        x = x + self.attentions[1](n2 + qpos, n2 + qpos, n2)
        return x + self.ffns[0](self.norms[2](x))


class DeformableDetrTransformer(nn.Module):
    """The parameter container of mmdet's two-stage DeformableDetrTransformer."""

    def __init__(self, embed_dims, num_heads, num_levels, num_encoder_layers,
                 num_decoder_layers, ffn_channels):
        super().__init__()
        C = embed_dims
        self.level_embeds = nn.Parameter(torch.empty(num_levels, C))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            DeformableEncoderLayer(C, num_heads, num_levels, 4, ffn_channels)
            for _ in range(num_encoder_layers)
        ])
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList([
            DeformableDecoderLayer(C, num_heads, num_levels, 4, ffn_channels)
            for _ in range(num_decoder_layers)
        ])
        self.enc_output = nn.Linear(C, C)
        self.enc_output_norm = nn.LayerNorm(C, eps=LN_EPS)
        self.pos_trans_fc = nn.Linear(4 * NUM_POS_FEATS, 2 * C)
        self.pos_trans_norm = nn.LayerNorm(2 * C, eps=LN_EPS)


def encoder_proposals(spatial_shapes, device=None):
    """mmdet ``gen_encoder_output_proposals`` on unpadded levels: per-level
    grid centres (x, y) with w = h = 0.05 * 2^level, (1, S, 4) in (0, 1)."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        wh = torch.full((h, w, 2), 0.05 * (2.0 ** lvl), device=device)
        props.append(torch.cat([xx[..., None], yy[..., None], wh], -1).reshape(h * w, 4))
    return torch.cat(props, 0)[None]


def proposal_pos_embed(boxes):
    """mmdet ``get_proposal_pos_embed``: a 128-feature sine embedding of
    each of the 4 box coordinates, (B, Q, 4) -> (B, Q, 512) f32."""
    B, Q = boxes.shape[:2]
    dim_t = torch.arange(NUM_POS_FEATS, dtype=torch.float32, device=boxes.device)
    dim_t = 10000.0 ** (2.0 * torch.div(dim_t, 2, rounding_mode="floor") / NUM_POS_FEATS)
    pe = boxes[..., None] * (2.0 * math.pi) / dim_t
    pe = torch.stack([pe[..., 0::2].sin(), pe[..., 1::2].cos()], dim=-1)
    return pe.reshape(B, Q, 4 * NUM_POS_FEATS)


class CrossHeadBBox(nn.Module):
    def __init__(self, num_classes=150, num_relations=50, num_obj_query=100, num_rel_query=100,
                 mapper="conv_tiny", embed_dims=256, num_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, num_relation_layers=6, num_levels=4,
                 with_box_refine=True, as_two_stage=True, ffn_channels=1024,
                 relation_ffn_channels=2048):
        super().__init__()
        C, K = embed_dims, num_rel_query
        self.num_obj_query, self.num_rel_query = num_obj_query, K
        self.num_levels = num_levels
        self.with_box_refine = with_box_refine
        self.as_two_stage = as_two_stage  # read nowhere, as in the reference
        self.transformer = DeformableDetrTransformer(
            C, num_heads, num_levels, num_encoder_layers, num_decoder_layers, ffn_channels)
        # index num_decoder_layers: the encoder-proposal head
        self.cls_branches = nn.ModuleList(
            [nn.Linear(C, num_classes) for _ in range(num_decoder_layers + 1)])
        self.reg_branches = nn.ModuleList(
            [MLP(C, C, 4, 3) for _ in range(num_decoder_layers + 1)])
        self.sub_query_update = MLP(C, C, C, 3)
        self.obj_query_update = MLP(C, C, C, 3)
        self.update_importance = create_mapper(mapper, num_obj_query)
        self.rel_query_feat = nn.Embedding(K, C)
        self.rel_query_pos_embed = nn.Embedding(K, C)
        self.rel_key_pos_embed = nn.Embedding(2 * K, C)
        self.rel_value_pos_embed = nn.Embedding(2 * K, C)  # read nowhere, as in the reference
        self.rel_cls_embed = nn.Linear(C, num_relations)
        self.relation_decoder = nn.Module()
        self.relation_decoder.layers = nn.ModuleList([
            RelationFusionLayerRMS(C, num_heads, relation_ffn_channels)
            for _ in range(num_relation_layers)
        ])

    def encode(self, levels):
        """Neck levels (B, C, h, w) -> (memory (B, S, C), spatial shapes)."""
        tr = self.transformer
        B, C = levels[0].shape[:2]
        shapes = [(f.shape[2], f.shape[3]) for f in levels]
        mem = torch.cat([f.flatten(2).transpose(1, 2) + tr.level_embeds[i]
                         for i, f in enumerate(levels)], dim=1)
        # f32 positions, as JAX adds them uncast (an f32 query in bf16 serving)
        pos = torch.cat([sine_positional_encoding(h, w, C // 2, device=mem.device)
                         .reshape(1, h * w, C) for h, w in shapes], dim=1).expand(B, -1, -1)
        ref = encoder_reference_points(shapes, device=mem.device)[None]
        for layer in tr.encoder.layers:
            mem = layer(mem, pos, ref, shapes)
        return mem, shapes

    def forward(self, levels):
        """levels: the neck's (B, C, h, w) maps. Returns the prediction dict."""
        tr = self.transformer
        mem, shapes = self.encode(levels)
        B = mem.shape[0]
        Q, K, n_dec = self.num_obj_query, self.num_rel_query, len(tr.decoder.layers)

        # encoder proposals -> top-k query init, ranked by the first class logit
        proposals_unact = inverse_sigmoid(encoder_proposals(shapes, mem.device))
        out_mem = tr.enc_output_norm(tr.enc_output(mem))
        enc_logits = self.cls_branches[n_dec](out_mem)
        enc_unact = self.reg_branches[n_dec](out_mem) + proposals_unact
        enc_boxes = torch.sigmoid(enc_unact)
        topk = topk_first(enc_logits[..., 0].detach(), Q)
        ref_boxes = torch.sigmoid(take_rows(enc_unact, topk).detach())
        pos_feat = tr.pos_trans_norm(tr.pos_trans_fc(proposal_pos_embed(ref_boxes).to(mem.dtype)))
        qpos, q = pos_feat.chunk(2, dim=-1)

        cls_layers, box_layers = [], []
        for i, layer in enumerate(tr.decoder.layers):
            ref_pts = ref_boxes[:, :, None, :].expand(B, Q, self.num_levels, 4)
            q = layer(q, qpos, mem, ref_pts, shapes)
            cls_layers.append(self.cls_branches[i](q))
            new_boxes = torch.sigmoid(self.reg_branches[i](q) + inverse_sigmoid(ref_boxes))
            box_layers.append(new_boxes)
            if self.with_box_refine:
                ref_boxes = new_boxes.detach()

        # re-rank the final queries: softmax over the query axis, max over classes
        q_scores = torch.softmax(cls_layers[-1].float(), dim=1).amax(-1)
        order = topk_first(q_scores.detach(), Q)
        cls_layers[-1] = take_rows(cls_layers[-1], order)
        box_layers[-1] = take_rows(box_layers[-1], order)
        queries = take_rows(q, order).detach()

        # --- Pair Proposal Network ---
        sub_e = self.sub_query_update(queries)
        obj_e = self.obj_query_update(queries)
        sub_e = sub_e / sub_e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        obj_e = obj_e / obj_e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        importance = self.update_importance(
            torch.matmul(sub_e.float(), obj_e.float().transpose(1, 2)))
        topk_idx = topk_first(importance.detach().reshape(B, Q * Q), K)
        sub_pos = torch.div(topk_idx, Q, rounding_mode="floor")
        obj_pos = topk_idx % Q
        pair_feat = torch.cat([take_rows(queries, sub_pos), take_rows(queries, obj_pos)], dim=1)

        # --- Relation Fusion ---
        rel_q = self.rel_query_feat.weight[None].expand(B, -1, -1)
        for layer in self.relation_decoder.layers:
            rel_q = layer(rel_q, self.rel_query_pos_embed.weight[None], pair_feat,
                          self.rel_key_pos_embed.weight[None])
        rel_preds = self.rel_cls_embed(rel_q)

        # the gathered class logits are NOT detached: the sub/obj CE trains
        # the decoder and its class branches
        return {
            "cls": cls_layers[-1],
            "box": box_layers[-1],
            "cls_layers": cls_layers,
            "box_layers": box_layers,
            "enc_cls": enc_logits,
            "enc_box": enc_boxes,
            "rel": rel_preds,
            "importance": importance,
            "sub": take_rows(cls_layers[-1], sub_pos),
            "obj": take_rows(cls_layers[-1], obj_pos),
            "sub_box": take_rows(box_layers[-1], sub_pos),
            "obj_box": take_rows(box_layers[-1], obj_pos),
            "sub_pos": sub_pos,
            "obj_pos": obj_pos,
            "queries": queries,
        }


def crosshead_bbox_with_neck(in_channels, **cfg):
    """A ``CrossHeadBBox`` from its config and the ChannelMapper neck over
    the last three of the backbone's levels (channels ``in_channels``):
    (head, neck)."""
    head = CrossHeadBBox(**cfg)
    neck = ChannelMapper(in_channels[1:], head.transformer.level_embeds.shape[1],
                         head.num_levels)
    return head, neck


# ---------------------------------------------------------------------------
# Training losses: the scene-graph losses of the Pair-Net (Seesaw 2.0, sub/obj
# CE 4.0, importance BCE 5.0 with a dynamic pos_weight) on the box
# Hungarian's query <-> GT correspondence, and the detection-only loss.
# ---------------------------------------------------------------------------


def gt_cxcywh(gt_boxes, image_shape):
    """xyxy pixel boxes (B, G, 4) -> cxcywh normalized by the image's
    (w, h, w, h) floored at 1, clipped to [0, 1] (JAX's order: normalize,
    then convert)."""
    n = gt_boxes.float() / image_scale(image_shape).clamp_min(1.0)
    return torch.stack([(n[..., 0] + n[..., 2]) / 2, (n[..., 1] + n[..., 3]) / 2,
                        n[..., 2] - n[..., 0], n[..., 3] - n[..., 1]], dim=-1).clamp(0.0, 1.0)


class BBoxTargets(NamedTuple):
    r_labels: torch.Tensor  # (B, K) 0-based predicate or -1
    r_weights: torch.Tensor  # (B, K) {0, 1}
    sub_ids: torch.Tensor  # (B, K) gt subject class or -1
    obj_ids: torch.Tensor  # (B, K)
    gt_importance: torch.Tensor  # (B, Q, Q) {0, 1}


@torch.no_grad()
def bbox_targets(outputs, batch) -> BBoxTargets:
    """The Pair-Net targets of a batch: the box Hungarian (focal 2, L1 5,
    gIoU 2) on the final queries, then the IdMatcher on the relation
    queries' gathered class logits. Two batched Hungarian calls."""
    cls_pred = outputs["cls"].detach()
    B, Q = cls_pred.shape[:2]
    gt_labels = batch["gt_labels"].long()
    gt_rels = batch["gt_rels"].long()
    G, Rm = gt_labels.shape[1], gt_rels.shape[1]
    img_hw = batch["image_shape"]
    assign = box_hungarian_assign(cls_pred, outputs["box"].detach(), gt_labels,
                                  gt_cxcywh(batch["gt_boxes"], img_hw), batch["gt_valid"].bool(),
                                  img_hw)
    gt2query = assign.gt2query  # (B, G)

    sub_gt = gt_rels[..., 0].clamp(0, G - 1)
    obj_gt = gt_rels[..., 1].clamp(0, G - 1)
    sub_q = torch.gather(gt2query, 1, sub_gt)
    obj_q = torch.gather(gt2query, 1, obj_gt)
    rel_ok = batch["rel_valid"].bool() & (sub_q >= 0) & (obj_q >= 0)
    gt_importance = torch.zeros((B, Q + 1, Q + 1), device=cls_pred.device)
    rows = torch.arange(B, device=cls_pred.device)[:, None].expand(B, Rm)
    gt_importance[rows, torch.where(rel_ok, sub_q, Q), torch.where(rel_ok, obj_q, Q)] = 1.0
    gt_importance = gt_importance[:, :Q, :Q]

    gt_sub_cls = torch.gather(gt_labels, 1, sub_gt)
    gt_obj_cls = torch.gather(gt_labels, 1, obj_gt)
    gt_rel_label = gt_rels[..., 2] - 1
    matched = id_match(outputs["sub"].detach(), outputs["obj"].detach(),
                       outputs["rel"].detach(), gt_sub_cls, gt_obj_cls, gt_rel_label,
                       rel_ok).relq2gt  # (B, K)
    safe = matched.clamp(0, Rm - 1)
    pos = matched >= 0
    return BBoxTargets(
        r_labels=torch.where(pos, torch.gather(gt_rel_label, 1, safe), -1),
        r_weights=pos.float(),
        sub_ids=torch.where(pos, torch.gather(gt_sub_cls, 1, safe), -1),
        obj_ids=torch.where(pos, torch.gather(gt_obj_cls, 1, safe), -1),
        gt_importance=gt_importance,
    )


def pairnet_bbox_loss(outputs, batch, cum_samples, rel_loss_weight=2.0, subobj_loss_weight=4.0,
                      match_loss_weight=5.0, reduce=None):
    """The scene-graph losses of the box Pair-Net: (losses with
    ``loss_total``, new cum_samples). ``batch`` holds the padded GT with
    ``gt_boxes`` (B, G, 4) xyxy in resized-image pixels and ``image_shape``.
    ``reduce`` sums over the data-parallel ranks (every normalizer global)."""
    B, K, R = outputs["rel"].shape
    C = outputs["cls"].shape[-1]
    t = bbox_targets(outputs, batch)
    w = t.r_weights.reshape(-1)
    loss_sub = softmax_ce(outputs["sub"].reshape(-1, C), t.sub_ids.reshape(-1), w,
                          reduce=reduce)
    loss_obj = softmax_ce(outputs["obj"].reshape(-1, C), t.obj_ids.reshape(-1), w,
                          reduce=reduce)
    loss_r, new_cum = seesaw_ce(outputs["rel"].reshape(-1, R), t.r_labels.reshape(-1), w,
                                cum_samples, reduce=reduce)
    npos = (t.gt_importance > 0).sum().float()
    numel = world_count(t.gt_importance.numel(), reduce)
    pos_weight = numel / _global(npos, reduce).clamp_min(1.0)
    loss_match = bce_with_logits_pos_weight(outputs["importance"], t.gt_importance, pos_weight,
                                            numel=numel)
    losses = {
        "loss_r_cls": rel_loss_weight * loss_r,
        "loss_sub_cls": subobj_loss_weight * loss_sub,
        "loss_obj_cls": subobj_loss_weight * loss_obj,
        "loss_match": match_loss_weight * loss_match,
    }
    losses["loss_total"] = sum(losses.values())
    return losses, new_cum


def paired_giou(a, b, eps=1e-7):
    """gIoU of each xyxy box of ``a`` with the box of ``b`` at its index,
    (..., N, 4) -> (..., N): the diagonal of the pairwise gIoU, entry by
    entry in the same operations, with no (N, N) matrix."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    iou = inter / union.clamp_min(eps)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0)
    hull = (wh[..., 0] * wh[..., 1]).clamp_min(eps)
    return iou - (hull - union) / hull


def deformable_detr_detection_loss(outputs, batch, cls_weight=2.0, l1_weight=5.0,
                                   giou_weight=2.0, focal_alpha=0.25, focal_gamma=2.0,
                                   reduce=None):
    """The detection-only loss (``od_*`` configs, mmdet DeformableDETRHead):
    per decoder layer and for the encoder proposals, sigmoid focal class
    loss + L1 + gIoU on Hungarian-matched queries, each image normalized
    by its own matches and the images averaged. The decoder layers'
    problems go to one batched Hungarian call and the encoder's (S
    proposals against the GT) to another. Tags: the last layer untagged,
    ``d<i>.`` the others, ``enc.`` the proposals."""
    gt_labels = batch["gt_labels"].long()
    gt_valid = batch["gt_valid"].bool()
    img_hw = batch["image_shape"]
    B, G = gt_labels.shape
    gt_cc = gt_cxcywh(batch["gt_boxes"], img_hw)
    scale = image_scale(img_hw)  # (B, 1, 4)
    layers = list(zip(outputs["cls_layers"], outputs["box_layers"]))
    n_dec = len(layers)
    layers.append((outputs["enc_cls"], outputs["enc_box"]))

    with torch.no_grad():
        dec_q2g = box_hungarian_assign(
            torch.cat([c.detach() for c, _ in layers[:n_dec]]),
            torch.cat([b.detach() for _, b in layers[:n_dec]]),
            tile(gt_labels, n_dec), tile(gt_cc, n_dec), tile(gt_valid, n_dec), tile(img_hw, n_dec),
            cls_weight, l1_weight, giou_weight).query2gt
        enc_q2g = box_hungarian_assign(
            outputs["enc_cls"].detach(), outputs["enc_box"].detach(), gt_labels, gt_cc, gt_valid,
            img_hw, cls_weight, l1_weight, giou_weight).query2gt
    n_img = world_count(B, reduce)

    losses = {}
    for li, (cls_l, box_l) in enumerate(layers):
        q2g = dec_q2g[li * B:(li + 1) * B] if li < n_dec else enc_q2g  # (B, Q)
        Cn = cls_l.shape[-1]
        pos = q2g >= 0
        safe = q2g.clamp(0, G - 1)
        tgt = F.one_hot(torch.gather(gt_labels, 1, safe), Cn).float() * pos[..., None]
        p = torch.sigmoid(cls_l.float())
        ce = -(tgt * torch.log(p.clamp_min(1e-8)) + (1 - tgt) * torch.log((1 - p).clamp_min(1e-8)))
        pt = tgt * p + (1 - tgt) * (1 - p)
        alpha_t = tgt * focal_alpha + (1 - tgt) * (1 - focal_alpha)
        focal = (alpha_t * (1 - pt) ** focal_gamma * ce).sum((1, 2))
        n_pos = pos.sum(-1).float()
        npos = n_pos.clamp_min(1.0)
        tgt_box = take_rows(gt_cc, safe)
        l1 = ((box_l - tgt_box).abs().sum(-1) * pos).sum(-1)
        gi = (paired_giou(cxcywh_to_xyxy(box_l) * scale, cxcywh_to_xyxy(tgt_box) * scale)
              * pos).sum(-1)
        tag = "" if li == n_dec - 1 else (f"d{li}." if li < n_dec else "enc.")
        losses[f"{tag}loss_cls"] = (cls_weight * focal / npos).sum() / n_img
        losses[f"{tag}loss_bbox"] = (l1_weight * l1 / npos).sum() / n_img
        losses[f"{tag}loss_iou"] = (giou_weight * (n_pos - gi) / npos).sum() / n_img
    losses["loss_total"] = sum(losses.values())
    return losses


class BoxTripletPrediction(NamedTuple):
    """One image's box-mode triplets."""

    labels: torch.Tensor  # (2K,) 1-based, subjects then objects
    rel_pairs: torch.Tensor  # (K, 2) indices [i, i + K]
    boxes: torch.Tensor  # (2K, 4) normalized xyxy in [0, 1]
    r_dists: torch.Tensor  # (K, R+1) with a zero background column
    r_labels: torch.Tensor  # (K,) 1-based argmax predicate
    r_scores: torch.Tensor  # (K,)


def pairnet_bbox_postprocess(outputs, image_index=None, num_things: int = 0):
    """Box-mode inference of one image: a softmax over the gathered sub/obj
    class logits (+1 for 1-based labels), cxcywh -> xyxy clipped to [0, 1],
    the predicate distribution with a zero background column; the triplets
    rank in relation-query order (the top-k importance order)."""
    del num_things
    b = image_index
    get = (lambda x: x[b]) if b is not None else (lambda x: x)
    r_cls = get(outputs["rel"])
    K = r_cls.shape[0]
    dev = r_cls.device
    r_dists = torch.softmax(r_cls.float(), -1)
    r_dists = torch.cat([torch.zeros((K, 1), device=dev), r_dists], -1)

    def cls_lbl(logits):
        p = torch.softmax(logits.float(), -1)
        return p.argmax(-1).int() + 1

    s_box = cxcywh_to_xyxy(get(outputs["sub_box"]).float()).clamp(0.0, 1.0)
    o_box = cxcywh_to_xyxy(get(outputs["obj_box"]).float()).clamp(0.0, 1.0)
    ar = torch.arange(K, dtype=torch.int32, device=dev)
    return BoxTripletPrediction(
        labels=torch.cat([cls_lbl(get(outputs["sub"])), cls_lbl(get(outputs["obj"]))]),
        rel_pairs=torch.stack([ar, ar + K], -1),
        boxes=torch.cat([s_box, o_box], 0),
        r_dists=r_dists,
        r_labels=r_dists[:, 1:].argmax(-1).int() + 1,
        r_scores=r_dists[:, 1:].amax(-1),
    )
