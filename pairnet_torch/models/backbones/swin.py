"""Swin Transformer backbone (shifted-window attention, patch merging).

Counterpart of ``pairnet_tpu/models/backbones/swin.py::SwinTransformer``
with mmdet's module names, so that an mmdet ``state_dict`` (the one
``pairnet_tpu.utils.torch_convert.convert_swin`` reads) loads by name:
``patch_embed.{projection,norm}``, ``stages.<s>.blocks.<b>.{norm1,norm2}``,
``...attn.w_msa.{qkv,proj,relative_position_bias_table}``,
``...ffn.layers.0.0`` / ``ffn.layers.1``, ``stages.<s>.downsample.{norm,
reduction}`` and ``norm<s>``. ``relative_position_index`` is computed, not
loaded, as ``convert_swin`` does.

Swin-B defaults: embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32),
window 12. Takes NCHW images and returns the four NCHW stage maps at
strides 4, 8, 16 and 32; inside it works on NHWC tokens. As in the JAX
module:

* the window scores are written in the compute type (bf16 in bf16
  serving), the relative bias and the shift mask added in it, and only the
  softmax is taken in f32; f32 inputs keep the whole chain in f32;
* each block pads its *normed* map with zeros up to a window multiple; the
  padded tokens are unmasked keys of the unshifted windows, and the shift
  mask (-100) is built over the padded extent;
* GELU is the exact erf in f32 and the tanh approximation in bf16;
* PatchMerging zero-pads odd extents; its 4C features are in mmdet's
  ``nn.Unfold`` order (c, ky, kx), which ``from_jax`` permutes from the
  JAX module's (ky, kx, c);
* LayerNorm epsilon is flax's 1e-6.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.layers import LN_EPS


# the cached tensors are made outside inference mode, so that a training
# forward after a served one can save them for its backward
@functools.lru_cache(maxsize=16)
@torch.inference_mode(False)
def rel_pos_index(window: int, device: torch.device) -> torch.Tensor:
    """(W^2 * W^2,) indices into the (2W-1)^2 relative bias table."""
    ar = torch.arange(window)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).reshape(-1).to(device)


@functools.lru_cache(maxsize=64)
@torch.inference_mode(False)
def shift_mask(Hp: int, Wp: int, w: int, shift: int, device: torch.device) -> torch.Tensor:
    """Additive mask of the shifted windows of a padded (Hp, Wp) map:
    (nW, w^2, w^2), -100 between tokens of different regions."""
    img = torch.zeros((Hp, Wp), dtype=torch.int32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(Hp // w, w, Wp // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    diff = wins[:, :, None] != wins[:, None, :]
    return torch.where(diff, -100.0, 0.0).to(device)


def window_partition(x, w):
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(wins, w, B, H, W):
    x = wins.reshape(B, H // w, W // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class WindowMSA(nn.Module):
    def __init__(self, dim, num_heads, window):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))

    def forward(self, x, mask=None):
        """x (nW*B, w^2, C); mask (nW, w^2, w^2) additive or None."""
        N, C = x.shape[1], x.shape[2]
        H = self.num_heads
        q, k, v = (t.unflatten(-1, (H, C // H)).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        # the scores in the compute type: bf16 in bf16 serving, f32 otherwise
        attn = torch.matmul(q * (C // H) ** -0.5, k.transpose(-1, -2))
        bias = self.relative_position_bias_table[rel_pos_index(self.window, x.device)]
        attn = attn + bias.reshape(N, N, H).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.unflatten(0, (-1, nW)) + mask[None, :, None].to(attn.dtype)).flatten(0, 1)
        attn = torch.softmax(attn, dim=-1, dtype=torch.float32).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(x.shape[0], N, C)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """Pads to window multiples, rolls by ``shift``, attends per window."""

    def __init__(self, dim, num_heads, window, shift):
        super().__init__()
        self.window, self.shift = window, shift
        self.w_msa = WindowMSA(dim, num_heads, window)

    def forward(self, y):  # (B, H, W, C), already normed
        B, H, W, _ = y.shape
        w, shift = self.window, self.shift
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(Hp, Wp, w, shift, y.device)
        y = window_reverse(self.w_msa(window_partition(y, w), mask), w, B, Hp, Wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        return y[:, :H, :W]


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window, shift=0, mlp_ratio=4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ShiftWindowMSA(dim, num_heads, window, shift)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = nn.Module()  # mmcv FFN naming: ffn.layers.0.0, ffn.layers.1
        self.ffn.layers = nn.ModuleList([nn.Sequential(nn.Linear(dim, hidden)),
                                         nn.Linear(hidden, dim)])

    def forward(self, x):  # (B, H, W, C)
        x = x + self.attn(self.norm1(x))
        y = self.ffn.layers[0][0](self.norm2(x))
        y = F.gelu(y, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
        return x + self.ffn.layers[1](y)


class PatchMerging(nn.Module):
    """2x2 neighbourhoods -> 4C features in (c, ky, kx) order -> norm ->
    ``reduction`` to ``out_dim``."""

    def __init__(self, dim, out_dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x):  # (B, H, W, C)
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        H, W = H + H % 2, W + W % 2
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, num_heads, window, out_dim=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window, shift=0 if b % 2 == 0 else window // 2)
            for b in range(depth)
        ])
        self.downsample = None if out_dim is None else PatchMerging(dim, out_dim)


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                 window=12, out_indices=(0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        dims = [embed_dim * 2 ** s for s in range(len(depths))]
        self.out_channels = tuple(dims[s] for s in self.out_indices)
        self.patch_embed = nn.Module()
        self.patch_embed.projection = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.stages = nn.ModuleList([
            SwinStage(dims[s], depth, num_heads[s], window,
                      dims[s + 1] if s + 1 < len(depths) else None)
            for s, depth in enumerate(depths)
        ])
        for s in self.out_indices:
            self.add_module(f"norm{s}", nn.LayerNorm(dims[s], eps=LN_EPS))

    def forward(self, x):
        """x (B, 3, H, W) -> the out_indices' stage maps, NCHW."""
        H, W = x.shape[2:]
        ph, pw = -H % 4, -W % 4  # flax 'SAME': the smaller half before
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        x = self.patch_embed.norm(self.patch_embed.projection(x).permute(0, 2, 3, 1))
        outs = []
        for s, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            if s in self.out_indices:
                outs.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
