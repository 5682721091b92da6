"""Shared building blocks (batch-first tokens, NCHW feature maps).

Counterpart of ``pairnet_tpu/models/layers.py``. Module and parameter names
follow the reference checkpoints (torch ``nn.MultiheadAttention``, mmcv FFN
and MultiScaleDeformableAttention), so a published ``state_dict`` loads
with ``load_state_dict``. Norm epsilons follow the JAX package (flax's
1e-6), not torch's default.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.ops.deform_attn import ms_deform_attn
from pairnet_torch.ops.masked_attn import masked_flash_attention
from pairnet_torch.parallel.spatial import gather_tokens

LN_EPS = 1e-6  # flax LayerNorm / GroupNorm default
FLASH_MIN_KEYS = 2048  # the flash route's least memory length (JAX layers.py:107)


def sine_positional_encoding(h, w, num_feats=128, temperature=10000.0, normalize=True,
                             scale=2 * math.pi, offset=0.0, eps=1e-6,
                             dtype=torch.float32, device=None):
    """DETR sine positional encoding of an unpadded (h, w) map -> (h, w, 2*num_feats).

    mmdet SinePositionalEncoding(normalize=True) with a zero padding mask:
    y features first, then x; sin on even and cos on odd feature indices.
    """
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    if normalize:
        y_embed = (y_embed + offset) / (h + eps) * scale
        x_embed = (x_embed + offset) / (w + eps) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1)
    pos = torch.cat([pos_y.reshape(h, w, num_feats), pos_x.reshape(h, w, num_feats)], dim=-1)
    return pos.to(dtype)


class MLP(nn.Sequential):
    """n-layer ReLU MLP; Linear layers at Sequential indices 0, 2, 4, ..."""

    def __init__(self, in_dim, hidden_dim, out_dim, num_layers=3):
        dims = [in_dim] + [hidden_dim] * (num_layers - 1)
        layers = []
        for i in range(num_layers - 1):
            layers += [nn.Linear(dims[i], hidden_dim), nn.ReLU()]
        layers.append(nn.Linear(dims[-1], out_dim))
        super().__init__(*layers)


def linear_f32(x, layer: nn.Linear):
    """``layer`` applied in f32 with its weights upcast (flax promotion of
    an f32 input against bf16 weights)."""
    return F.linear(x.float(), layer.weight.float(), layer.bias.float())


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention semantics, batch-first, packed in_proj.

    ``attn_mask`` is bool with True = masked out, shaped (B, 1 or H, Lq, Lk).
    Written out as matmul, -1e9 fill, f32 softmax and matmul. With ``flash``
    set (``flagship.set_flash_attention``), a head-shared mask and at least
    ``FLASH_MIN_KEYS`` keys take the masked flash-attention kernel instead,
    as JAX's ``PAIRNET_FLASH_ATTN=1`` does; inference only (no backward).
    """

    def __init__(self, embed_dims, num_heads):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.flash = False
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, key, value, attn_mask=None):
        C, H = self.embed_dims, self.num_heads
        D = C // H
        # in the query's type: flax promotes an f32 input against bf16 weights
        # (the attention matrix learner's f32 affinity in bf16 serving)
        w, b = self.in_proj_weight.to(query.dtype), self.in_proj_bias.to(query.dtype)
        q = F.linear(query, w[:C], b[:C])
        k = F.linear(key, w[C : 2 * C], b[C : 2 * C])
        v = F.linear(value, w[2 * C :], b[2 * C :])
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        q = q.reshape(B, Lq, H, D).transpose(1, 2)
        k = k.reshape(B, Lk, H, D).transpose(1, 2)
        v = v.reshape(B, Lk, H, D).transpose(1, 2)
        if (self.flash and attn_mask is not None and attn_mask.shape[1] == 1
                and Lk >= FLASH_MIN_KEYS):
            out = masked_flash_attention(
                q.reshape(B * H, Lq, D), k.reshape(B * H, Lk, D), v.reshape(B * H, Lk, D),
                attn_mask[:, 0], H,
            )
            out = out.reshape(B, H, Lq, D).transpose(1, 2).to(v.dtype).reshape(B, Lq, C)
            return self._out_proj(out)
        # f32 products and output, as JAX's preferred_element_type=f32: a
        # bf16 matmul would round the logits to bf16 before the softmax
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(D))
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, -1e9)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, C)
        return self._out_proj(out)

    def _out_proj(self, out):
        p = self.out_proj
        return F.linear(out, p.weight.to(out.dtype), p.bias.to(out.dtype))


class AttnSlot(nn.Module):
    """mmcv wrapper naming: the attention sits at ``attentions.<i>.attn``."""

    def __init__(self, embed_dims, num_heads):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, num_heads)

    def forward(self, *args, **kwargs):
        return self.attn(*args, **kwargs)


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Dropout -> Linear -> Dropout (residual
    added by the caller). Parameters at ``layers.0.0`` and ``layers.1``."""

    def __init__(self, embed_dims, feedforward_channels, ffn_drop=0.0):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(
                nn.Linear(embed_dims, feedforward_channels), nn.ReLU(), nn.Dropout(ffn_drop)
            ),
            nn.Linear(feedforward_channels, embed_dims),
            nn.Dropout(ffn_drop),
        )

    def forward(self, x):
        return self.layers(x)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine parameters (buffers)."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):  # NCHW
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def deform_offsets_bias(num_heads, num_levels, num_points):
    """mmcv MultiScaleDeformableAttention sampling_offsets bias init."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)
    grid = grid / grid.abs().amax(dim=-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    scale = torch.arange(1, num_points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


class RMSNorm(nn.Module):
    """RMSNorm with a weight and no bias (the reference's ``fc.py``). In
    JAX's order: the mean square in f32, ``x * rsqrt(ms + eps)`` cast to
    x's type, then times the weight."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        ms = x.float().square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(ms + self.eps)).to(x.dtype) * self.weight.to(x.dtype)


class SwiGLU(nn.Module):
    """SwiGLU FFN without biases: ``w2(silu(w1 x) * w3 x)`` (the reference's
    ``fc.py``)."""

    def __init__(self, dim, hidden_dim, out_dim):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden_dim, bias=False)
        self.w3 = nn.Linear(dim, hidden_dim, bias=False)
        self.w2 = nn.Linear(hidden_dim, out_dim, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


def linear_promoted(x, layer: nn.Linear):
    """``layer`` applied in the promoted type of ``x`` and its weights, as a
    flax Dense promotes an f32 input against bf16 weights to f32."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention over point or box references.

    The residual is added here (mmcv adds the identity inside the module).
    ``impl`` picks the MSDA implementation (see ``ops/deform_attn.py``);
    None means the device default. ``bwd`` picks the backward variant,
    "exact" or "bf16_grad" (see ``ops/deform_attn_bwd.py``). With
    ``seq_group`` (a process group) the queries and values are this rank's
    tokens of a sequence split (``parallel/spatial.py``): the projected
    value plane is all-gathered over the group once per call.
    """

    def __init__(self, embed_dims=256, num_heads=8, num_levels=3, num_points=4,
                 seq_group=None):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        self.seq_group = seq_group
        self.impl: str | None = None
        self.bwd = "exact"
        C = embed_dims
        self.sampling_offsets = nn.Linear(C, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(C, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(C, C)
        self.output_proj = nn.Linear(C, C)

    def forward(self, query, value, reference_points, spatial_shapes: Sequence[tuple[int, int]],
                query_pos=None, identity=None):
        """query (B, Q, C); value (B, S, C); reference_points (B or 1, Q, L,
        2) points (x, y) or (B, Q, L, 4) boxes (cx, cy, w, h). A query in
        another type than the weights (an f32 positional encoding added to
        bf16 tokens) computes its offsets and weights in the promoted type."""
        B, Q, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        v = self.value_proj(value).reshape(B, -1, H, C // H)
        if self.seq_group is not None:  # the whole plane, cut to its real tokens
            v = gather_tokens(v, self.seq_group)[:, : sum(h * w for h, w in spatial_shapes)]
        offsets = linear_promoted(query, self.sampling_offsets).reshape(B, Q, H, L, P, 2)
        attn = linear_promoted(query, self.attention_weights).reshape(B, Q, H, L * P)
        attn = torch.softmax(attn, dim=-1).reshape(B, Q, H, L, P)
        ref = reference_points[:, :, None, :, None, :]
        if reference_points.shape[-1] == 4:
            # box references (mmcv): loc = cxcy + offset / P * wh * 0.5, the
            # division in the offsets' type as JAX divides by a Python int
            locs = ref[..., :2].float() + (offsets / P).float() * ref[..., 2:].float() * 0.5
        else:
            shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
            normalizer = level_sizes(shapes, query.device)
            locs = ref.float() + offsets.float() / normalizer[None, None, None, :, None, :]
        out = ms_deform_attn(v, spatial_shapes, locs, attn, impl=self.impl, bwd=self.bwd)
        out = self.output_proj(out.to(identity.dtype))
        return identity + out


# made outside inference mode, so that a training forward after a served
# one can save it for its backward
@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def level_sizes(spatial_shapes: tuple[tuple[int, int], ...], device) -> torch.Tensor:
    """(L, 2) f32 (w, h) of each level, made once per levels and device: a
    host-to-device copy synchronises, and a CUDA graph capture refuses it."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32, device=device)


def encoder_reference_points(spatial_shapes, device=None):
    """Per-pixel normalized centre reference points, (S, L, 2) as (x, y)."""
    L = len(spatial_shapes)
    refs = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([xx, yy], dim=-1).reshape(-1, 2))
    ref = torch.cat(refs, dim=0)
    return ref[:, None, :].expand(-1, L, -1)
