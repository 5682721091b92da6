"""Masked-attention transformer decoder (Mask2Former), batch-first.

Counterpart of ``pairnet_tpu/models/decoders/mask2former_decoder.py``. Names follow mmdet:
the layers and ``post_norm`` live here, while the query tables and the
cls/mask heads belong to the head that owns this decoder and are passed in.

* layer order cross_attn -> norm -> self_attn -> norm -> ffn -> norm,
* cross-attention mask = sigmoid(mask logits at the attention resolution)
  < 0.5, shared by the heads; rows masked everywhere attend everywhere,
* the prediction head (post_norm, cls and mask embeds, mask einsum) runs
  in f32 with the weights upcast, also when the trunk is bf16.

Two routes to the attention masks, as in JAX. The default resizes the mask
features once per level and contracts there (resize is linear, so it
commutes with the contraction; Pair-Net and PSGTr2). With
``return_intermediate`` (the Mask2Former baselines, which train per-layer
losses and build their decoder so in serving too) the reference route runs
the prediction head at full resolution before the first layer and after
every layer, resizes those logits to the next level and keeps each layer's
(cls, mask). The two differ by f32 reassociation, which can flip a mask bit,
so each head takes the route JAX takes for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from pairnet_torch.models.layers import (
    FFN,
    LN_EPS,
    MLP,
    AttnSlot,
    linear_f32,
    sine_positional_encoding,
)
from pairnet_torch.models.necks.pixel_decoder import MSDeformAttnPixelDecoder, bilinear_resize
from pairnet_torch.utils import tracing


class DecoderLayer(nn.Module):
    """cross_attn -> norm -> self_attn -> norm -> ffn -> norm (post-norm).

    ``memory_pos`` is added to the keys only (mmcv semantics). Shared by the
    query decoder and the Relation Fusion decoder.
    """

    def __init__(self, embed_dims=256, num_heads=8, feedforward_channels=2048, ffn_drop=0.0):
        super().__init__()
        self.attentions = nn.ModuleList(
            [AttnSlot(embed_dims, num_heads), AttnSlot(embed_dims, num_heads)]
        )
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels, ffn_drop)])

    def forward(self, query, query_pos, memory, memory_pos, attn_mask):
        mem_k = memory if memory_pos is None else memory + memory_pos
        x = query + self.attentions[0](query + query_pos, mem_k, memory, attn_mask=attn_mask)
        x = self.norms[0](x)
        x = x + self.attentions[1](x + query_pos, x + query_pos, x)
        x = self.norms[1](x)
        x = x + self.ffns[0](x)
        return self.norms[2](x)


def _layer_norm_f32(x, norm: nn.LayerNorm):
    return nn.functional.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps
    )


def _mlp_f32(x, mlp: nn.Sequential):
    for m in mlp:
        x = linear_f32(x, m) if isinstance(m, nn.Linear) else m(x)
    return x


class Mask2FormerDecoder(nn.Module):
    def __init__(self, embed_dims=256, num_heads=8, num_layers=9, feedforward_channels=2048,
                 return_intermediate=False):
        super().__init__()
        self.return_intermediate = return_intermediate
        self.layers = nn.ModuleList(
            [DecoderLayer(embed_dims, num_heads, feedforward_channels) for _ in range(num_layers)]
        )
        self.post_norm = nn.LayerNorm(embed_dims, eps=LN_EPS)

    def _mask_embed(self, query, mask_embed):
        return _mlp_f32(_layer_norm_f32(query, self.post_norm), mask_embed)

    def attn_mask_small(self, query, mf_small, mask_embed):
        """Attention mask from features already resized to the attention
        resolution: resize is linear, so it commutes with the contraction."""
        am = torch.einsum("bqc,bsc->bqs", self._mask_embed(query, mask_embed), mf_small)
        return torch.sigmoid(am) < 0.5

    def forward_head(self, query, mf, attn_hw, cls_embed, mask_embed):
        """The reference route's prediction head: (cls, full-resolution mask
        logits, the attention mask at ``attn_hw``: the logits bilinearly
        resized there, sigmoid < 0.5)."""
        out = _layer_norm_f32(query, self.post_norm)
        cls_pred = linear_f32(out, cls_embed)
        mask_pred = torch.einsum("bqc,bchw->bqhw", _mlp_f32(out, mask_embed), mf)
        am = bilinear_resize(mask_pred, attn_hw).flatten(2)
        return cls_pred, mask_pred, (torch.sigmoid(am) < 0.5).detach()

    def forward(self, multi_scale_feats, mask_features, pos_encodings, query_feat,
                query_embed, level_embed, cls_embed, mask_embed):
        """multi_scale_feats: low -> high resolution (B, C, h, w); pos_encodings
        (h, w, C) each; mask_features (B, C, h4, w4). The last five arguments
        are the owning head's tables and layers. The work between the layers
        is in methods (the start with layer 0's mask, each later layer's
        mask, the head), where a graphed serving forward cuts it
        (``utils/serve_graph.py``)."""
        ctx, query, attn_mask, _ = self._start(
            multi_scale_feats, mask_features, pos_encodings, query_feat, query_embed,
            level_embed, cls_embed, mask_embed)
        n = len(ctx.shapes)
        history, intermediates = [], []
        for i, layer in enumerate(self.layers):
            if i:
                attn_mask, head = self._mask(ctx, query, i, cls_embed, mask_embed)
                if head is not None:  # the reference route's head after layer i - 1
                    intermediates.append(head)
            query = layer(query, ctx.query_pos, ctx.memories[i % n], ctx.memory_pos[i % n],
                          attn_mask[:, None])
            history.append(query)
        cls_pred, mask_pred, query_history = self._head(ctx, query, history, cls_embed,
                                                        mask_embed)
        if self.return_intermediate:
            intermediates.append((cls_pred, mask_pred))
        return {"cls": cls_pred, "mask": mask_pred, "queries": query,
                "query_history": query_history, "intermediates": intermediates}

    def _start(self, multi_scale_feats, mask_features, pos_encodings, query_feat, query_embed,
               level_embed, cls_embed, mask_embed):
        """(what every layer reads, the first query, layer 0's mask and head
        as :meth:`_mask` gives them)."""
        B, C = mask_features.shape[:2]
        memories, memory_pos, shapes = [], [], []
        for lvl, f in enumerate(multi_scale_feats):
            h, w = f.shape[-2:]
            memories.append(f.flatten(2).transpose(1, 2) + level_embed[lvl])
            memory_pos.append(pos_encodings[lvl].reshape(1, h * w, C))
            shapes.append((h, w))
        query = query_feat[None].expand(B, -1, -1)
        mf = mask_features.float()
        mf_small = None if self.return_intermediate else [
            bilinear_resize(mf, hw).flatten(2).transpose(1, 2) for hw in shapes]
        ctx = _Context(memories, memory_pos, query_embed[None], mf, mf_small, shapes)
        return (ctx, query, *self._mask(ctx, query, 0, cls_embed, mask_embed))

    def _mask(self, ctx, query, i, cls_embed, mask_embed):
        """Layer ``i``'s attention mask from ``query``, its rows masked
        everywhere cleared (they attend everywhere), and on the reference
        route the prediction head's (cls, mask) on ``query``, else None."""
        lvl = i % len(ctx.shapes)
        if self.return_intermediate:
            cls_pred, mask_pred, attn_mask = self.forward_head(query, ctx.mf, ctx.shapes[lvl],
                                                               cls_embed, mask_embed)
            head = (cls_pred, mask_pred)
        else:
            attn_mask = self.attn_mask_small(query, ctx.mf_small[lvl], mask_embed)
            head = None
        all_masked = attn_mask.all(dim=-1, keepdim=True)
        return attn_mask & ~all_masked, head

    def _head(self, ctx, query, history, cls_embed, mask_embed):
        """(cls, full-resolution mask logits, the layers' queries stacked)
        after the last layer."""
        if self.return_intermediate:
            cls_pred, mask_pred, _ = self.forward_head(
                query, ctx.mf, ctx.shapes[len(self.layers) % len(ctx.shapes)], cls_embed,
                mask_embed)
        else:
            out = _layer_norm_f32(query, self.post_norm)
            cls_pred = linear_f32(out, cls_embed)
            mask_pred = torch.einsum("bqc,bchw->bqhw", _mlp_f32(out, mask_embed), ctx.mf)
        return cls_pred, mask_pred, torch.stack(history)


class _Context(NamedTuple):
    """What every decoder layer reads: the memories and their positional
    encodings a level, the query positions, the mask features in f32 (and,
    on the default route, resized to each level, tokens last), the levels'
    (h, w)."""

    memories: list
    memory_pos: list
    query_pos: torch.Tensor
    mf: torch.Tensor
    mf_small: list | None
    shapes: list


class Mask2FormerSegmenter(nn.Module):
    """The Mask2Former segmenter of Pair-Net, the baselines and PSGTr2: the
    pixel decoder and the query decoder, with the query tables,
    ``cls_embed`` and ``mask_embed`` on the head (mmdet naming)."""

    def __init__(self, in_channels, num_classes=133, num_obj_query=100, embed_dims=256,
                 num_heads=8, num_decoder_layers=9, num_feat_levels=3, pixel_decoder_layers=6,
                 pixel_decoder_ffn=1024, decoder_ffn=2048, return_intermediate=False):
        super().__init__()
        C = embed_dims
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels, feat_channels=C, out_channels=C, num_encoder_levels=num_feat_levels,
            num_encoder_layers=pixel_decoder_layers, num_heads=num_heads,
            feedforward_channels=pixel_decoder_ffn,
        )
        self.transformer_decoder = Mask2FormerDecoder(
            C, num_heads, num_decoder_layers, decoder_ffn, return_intermediate
        )
        self.query_feat = nn.Embedding(num_obj_query, C)
        self.query_embed = nn.Embedding(num_obj_query, C)
        self.level_embed = nn.Embedding(num_feat_levels, C)
        self.cls_embed = nn.Linear(C, num_classes + 1)
        self.mask_embed = MLP(C, C, C, 3)

    def segment(self, feats):
        """(decoder output dict with the ``mask_features``, the multi-scale
        features, their positional encodings)."""
        with tracing.span("pixel_decoder"):
            mask_features, ms_feats = self.pixel_decoder(feats)
        with tracing.span("decoder"):
            pos = self.positions(ms_feats)
            dec = self.transformer_decoder(
                ms_feats, mask_features, pos, self.query_feat.weight, self.query_embed.weight,
                self.level_embed.weight, self.cls_embed, self.mask_embed,
            )
        dec["mask_features"] = mask_features
        return dec, ms_feats, pos

    def positions(self, ms_feats):
        """The sine positional encoding of each (B, C, h, w) map, (h, w, C)."""
        return [sine_positional_encoding(f.shape[2], f.shape[3], f.shape[1] // 2, dtype=f.dtype,
                                         device=f.device) for f in ms_feats]
