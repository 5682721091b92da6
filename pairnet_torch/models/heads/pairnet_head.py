"""Pair-Net head: Mask2Former segmenter + Pair Proposal Network + Relation Fusion.

Counterpart of ``pairnet_tpu/models/heads/pairnet_head.py::PairNetHead``,
with the reference checkpoint's module names (``CrossHead2``): the query
tables, ``cls_embed`` and ``mask_embed`` sit on the head, the decoder
layers under ``transformer_decoder``, the relation layers under
``relation_decoder``.

* PPN: 3-layer sub/obj MLPs on the final queries, L2-normalized outer
  product -> (Q, Q) affinity, refined by the ``mapper`` matrix learner
  (``matrix_learner.MAPPERS``), top-k over the flattened Q*Q matrix
  (sub = idx // Q, obj = idx % Q).
* Relation Fusion: relation queries cross-attend over the concatenated
  subject/object query features with a learned key positional table.
  ``rel_query_embed3`` is allocated as in the reference and never read.
* ``direct=True`` (the reference's ``CrossHeadDirect`` ablation): no
  Relation Fusion; ``pair_embed``, an MLP 2C -> C -> C, embeds each
  concatenated (subject, object) feature and ``rel_cls_embed`` reads it.
  The head then owns no relation layers, as flax creates none it never
  calls; the query tables stay, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.decoders.mask2former_decoder import DecoderLayer, Mask2FormerSegmenter
from pairnet_torch.models.heads.matrix_learner import create_mapper
from pairnet_torch.models.layers import MLP
from pairnet_torch.utils import tracing


class PairNetHead(Mask2FormerSegmenter):
    def __init__(self, in_channels, num_classes=133, num_relations=56, num_obj_query=100,
                 num_rel_query=100, embed_dims=256, num_heads=8, num_decoder_layers=9,
                 num_relation_layers=6, num_feat_levels=3, pixel_decoder_layers=6,
                 pixel_decoder_ffn=1024, decoder_ffn=2048, relation_ffn=2048,
                 relation_ffn_drop=0.1, mapper="conv_tiny", direct=False):
        super().__init__(in_channels, num_classes, num_obj_query, embed_dims, num_heads,
                         num_decoder_layers, num_feat_levels, pixel_decoder_layers,
                         pixel_decoder_ffn, decoder_ffn)
        C, K = embed_dims, num_rel_query
        self.num_rel_query = K
        self.direct = direct
        self.rel_query_feat = nn.Embedding(K, C)
        self.rel_query_embed = nn.Embedding(K, C)
        self.rel_query_embed2 = nn.Embedding(2 * K, C)
        self.rel_query_embed3 = nn.Embedding(2 * K, C)  # dead in the reference
        self.sub_query_update = MLP(C, C, C, 3)
        self.obj_query_update = MLP(C, C, C, 3)
        self.rel_cls_embed = nn.Linear(C, num_relations)
        self.update_importance = create_mapper(mapper, num_obj_query)
        if direct:
            self.pair_embed = MLP(2 * C, C, C, 3)
        else:
            self.relation_decoder = nn.Module()  # reference naming: relation_decoder.layers.<i>
            self.relation_decoder.layers = nn.ModuleList([
                DecoderLayer(C, num_heads, relation_ffn, relation_ffn_drop)
                for _ in range(num_relation_layers)
            ])

    def pair_topk(self, importance):
        """Top-k of the flattened (Q, Q) importance: (sub_pos, obj_pos) (B, K)."""
        B, Q, _ = importance.shape
        topk_idx = importance.reshape(B, Q * Q).topk(self.num_rel_query, dim=-1).indices
        return torch.div(topk_idx, Q, rounding_mode="floor"), topk_idx % Q

    def forward(self, feats):
        """feats: backbone (C2, C3, C4, C5) NCHW. Returns the prediction dict."""
        dec, _, _ = self.segment(feats)
        with tracing.span("pair_head"):
            return self.pair(dec)

    def pair(self, dec):
        """PPN and Relation Fusion on the decoder's output: the prediction dict."""
        cls_pred, mask_pred, queries = dec["cls"], dec["mask"], dec["queries"]
        B = queries.shape[0]

        # --- Pair Proposal Network ---
        sub_embed = self.sub_query_update(queries)
        obj_embed = self.obj_query_update(queries)
        sub_embed = sub_embed / sub_embed.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        obj_embed = obj_embed / obj_embed.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        importance = torch.matmul(sub_embed.float(), obj_embed.float().transpose(1, 2))
        importance = self.update_importance(importance)  # (B, Q, Q)

        sub_pos, obj_pos = self.pair_topk(importance)
        rows = torch.arange(B, device=queries.device)[:, None]
        sub_query_feat = queries[rows, sub_pos]
        obj_query_feat = queries[rows, obj_pos]
        if self.direct:
            pair_cat = torch.cat([sub_query_feat, obj_query_feat], dim=-1)
            rel_preds = self.rel_cls_embed(self.pair_embed(pair_cat))
        else:
            # --- Relation Fusion ---
            pair_feat = torch.cat([sub_query_feat, obj_query_feat], dim=1)
            rel_query = self.rel_query_feat.weight[None].expand(B, -1, -1)
            rel_query_pos = self.rel_query_embed.weight[None]
            key_pos = self.rel_query_embed2.weight[None]
            for layer in self.relation_decoder.layers:
                rel_query = layer(rel_query, rel_query_pos, pair_feat, key_pos, None)
            rel_preds = self.rel_cls_embed(rel_query)

        # the gathered class and mask predictions are detached, as in JAX
        # (pairnet_head.py:166-170): loss_sub_cls/loss_obj_cls train nothing
        cls_sg, mask_sg = cls_pred.detach(), mask_pred.detach()
        return {
            "cls": cls_pred,
            "mask": mask_pred,
            "rel": rel_preds,
            "importance": importance,
            "sub": cls_sg[rows, sub_pos],
            "obj": cls_sg[rows, obj_pos],
            "sub_seg": mask_sg[rows, sub_pos],
            "obj_seg": mask_sg[rows, obj_pos],
            "sub_pos": sub_pos,
            "obj_pos": obj_pos,
            "queries": queries,
        }
