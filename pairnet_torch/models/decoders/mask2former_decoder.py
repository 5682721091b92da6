"""Masked-attention transformer decoder (Mask2Former), batch-first.

Counterpart of ``pairnet_tpu/models/decoders/mask2former_decoder.py`` on its
serving route (resize-then-contract attention masks). Names follow mmdet:
the layers and ``post_norm`` live here, while the query tables and the
cls/mask heads belong to the head that owns this decoder and are passed in.

* layer order cross_attn -> norm -> self_attn -> norm -> ffn -> norm,
* cross-attention mask = sigmoid(mask logits at the attention resolution)
  < 0.5, shared by the heads; rows masked everywhere attend everywhere,
* the prediction head (post_norm, cls and mask embeds, mask einsum) runs
  in f32 with the weights upcast, also when the trunk is bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from pairnet_torch.models.layers import FFN, LN_EPS, AttnSlot, linear_f32
from pairnet_torch.models.necks.pixel_decoder import bilinear_resize


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
    def __init__(self, embed_dims=256, num_heads=8, num_layers=9, feedforward_channels=2048):
        super().__init__()
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

    def forward(self, multi_scale_feats, mask_features, pos_encodings, query_feat,
                query_embed, level_embed, cls_embed, mask_embed):
        """multi_scale_feats: low -> high resolution (B, C, h, w); pos_encodings
        (h, w, C) each; mask_features (B, C, h4, w4). The last five arguments
        are the owning head's tables and layers."""
        B, C = mask_features.shape[:2]
        memories, memory_pos, shapes = [], [], []
        for lvl, f in enumerate(multi_scale_feats):
            h, w = f.shape[-2:]
            memories.append(f.flatten(2).transpose(1, 2) + level_embed[lvl])
            memory_pos.append(pos_encodings[lvl].reshape(1, h * w, C))
            shapes.append((h, w))
        query = query_feat[None].expand(B, -1, -1)
        query_pos = query_embed[None]

        mf = mask_features.float()
        mf_small = [bilinear_resize(mf, hw).flatten(2).transpose(1, 2) for hw in shapes]
        attn_mask = self.attn_mask_small(query, mf_small[0], mask_embed)
        history = []
        n = len(shapes)
        for i, layer in enumerate(self.layers):
            all_masked = attn_mask.all(dim=-1, keepdim=True)
            attn_mask = attn_mask & ~all_masked
            query = layer(query, query_pos, memories[i % n], memory_pos[i % n],
                          attn_mask[:, None])
            if i + 1 < len(self.layers):
                attn_mask = self.attn_mask_small(query, mf_small[(i + 1) % n], mask_embed)
            history.append(query)

        out = _layer_norm_f32(query, self.post_norm)
        cls_pred = linear_f32(out, cls_embed)
        mask_pred = torch.einsum("bqc,bchw->bqhw", _mlp_f32(out, mask_embed), mf)
        return {"cls": cls_pred, "mask": mask_pred, "queries": query,
                "query_history": torch.stack(history)}
