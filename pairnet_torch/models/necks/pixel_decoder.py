"""MSDeformAttn pixel decoder (Mask2Former neck).

Counterpart of ``pairnet_tpu/models/necks/pixel_decoder.py``, with mmdet's
module names. Tokens run row-major for every aspect ratio: the JAX
package's transposed planes for landscape inputs only relabel axes for the
TPU's lanes and change no number.

Returns ``(mask_features (B, C, H/4, W/4), multi_scale_features)`` with the
multi-scale features NCHW, low -> high resolution (stride 32, 16, 8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.layers import (
    FFN,
    LN_EPS,
    MSDeformAttention,
    encoder_reference_points,
    sine_positional_encoding,
)


def bilinear_resize(x, size):
    """torch bilinear resize of NCHW maps, align_corners=False, no antialias."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


class ConvGN(nn.Module):
    """mmcv ConvModule(conv, GroupNorm(32)), optional ReLU."""

    def __init__(self, cin, cout, kernel_size, relu=False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, padding=kernel_size // 2, bias=True)
        self.gn = nn.GroupNorm(32, cout, eps=LN_EPS)
        self.relu = relu

    def forward(self, x):
        x = self.gn(self.conv(x))
        return F.relu(x) if self.relu else x


class DeformableEncoderLayer(nn.Module):
    """self_attn -> norm -> ffn -> norm (post-norm, mmcv operation_order).
    ``seq_group``: the process group of a sequence split (see
    ``parallel/spatial.py``)."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=3, num_points=4,
                 feedforward_channels=1024, seq_group=None):
        super().__init__()
        self.attentions = nn.ModuleList(
            [MSDeformAttention(embed_dims, num_heads, num_levels, num_points, seq_group)]
        )
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=LN_EPS) for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])

    def forward(self, x, pos, reference_points, spatial_shapes):
        x = self.attentions[0](x, x, reference_points, spatial_shapes, query_pos=pos)
        x = self.norms[0](x)
        x = x + self.ffns[0](x)
        return self.norms[1](x)


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, in_channels, feat_channels=256, out_channels=256, num_encoder_levels=3,
                 num_encoder_layers=6, num_heads=8, num_points=4, feedforward_channels=1024,
                 num_outs=3):
        super().__init__()
        C, L = feat_channels, num_encoder_levels
        n_in = len(in_channels)
        self.num_levels, self.num_outs = L, num_outs
        # input_convs[l] projects backbone level n_in - 1 - l (C5 first)
        self.input_convs = nn.ModuleList(
            [ConvGN(in_channels[n_in - 1 - lvl], C, 1) for lvl in range(L)]
        )
        self.encoder = nn.Module()  # mmdet naming: encoder.layers.<i>
        self.encoder.layers = nn.ModuleList([
            DeformableEncoderLayer(C, num_heads, L, num_points, feedforward_channels)
            for _ in range(num_encoder_layers)
        ])
        self.level_encoding = nn.Embedding(L, C)
        self.lateral_convs = nn.ModuleList(
            [ConvGN(in_channels[i], C, 1) for i in range(n_in - L)]
        )
        self.output_convs = nn.ModuleList(
            [ConvGN(C, C, 3, relu=True) for _ in range(n_in - L)]
        )
        self.mask_feature = nn.Conv2d(C, out_channels, 3, padding=1)

    def forward(self, feats):
        """feats: (C2, C3, C4, C5) NCHW, high -> low resolution."""
        B = feats[0].shape[0]
        n_in = len(feats)
        tokens, pos_embeds, spatial_shapes = [], [], []
        for lvl in range(self.num_levels):
            x = self.input_convs[lvl](feats[n_in - 1 - lvl])
            C, h, w = x.shape[1:]
            pos = sine_positional_encoding(h, w, C // 2, dtype=x.dtype, device=x.device)
            tokens.append(x.flatten(2).transpose(1, 2))
            # mmdet adds the level embed to the positional encoding, not the tokens
            pos_embeds.append(pos.reshape(1, h * w, C) + self.level_encoding.weight[lvl])
            spatial_shapes.append((h, w))
        x = torch.cat(tokens, dim=1)
        pos = torch.cat(pos_embeds, dim=1)
        ref = encoder_reference_points(spatial_shapes, device=x.device)[None]
        for layer in self.encoder.layers:
            x = layer(x, pos, ref, spatial_shapes)

        outs, start = [], 0
        for h, w in spatial_shapes:
            outs.append(x[:, start : start + h * w].transpose(1, 2).reshape(B, -1, h, w))
            start += h * w

        y = outs[-1]
        for i in range(n_in - 1 - self.num_levels, -1, -1):
            lat = self.lateral_convs[i](feats[i])
            y = lat + bilinear_resize(y, lat.shape[-2:])
            y = self.output_convs[i](y)
        return self.mask_feature(y), tuple(outs[: self.num_outs])
