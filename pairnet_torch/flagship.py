"""The flagship models of the port: Pair-Net R-50 and Pair-Net Swin-B
(PSGTr + PairNetHead).

Counterpart of ``__graft_entry__.py::_flagship`` with the same widths:
133 classes, 56 predicates, 100 object and 100 relation queries, width 256,
6 pixel-decoder layers, 9 decoder layers, 6 relation layers, on ResNet-50
(``backbone="r50"``) or Swin-B (``backbone="swinb"``: embed 128, depths
(2, 2, 18, 2), heads (4, 8, 16, 32), window 12). ``tiny=True`` gives the
small model the CPU tests use (on a tiny Swin with ``backbone="swinb"``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pairnet_torch.models.backbones.resnet import ResNet
from pairnet_torch.models.backbones.swin import SwinTransformer, WindowMSA
from pairnet_torch.models.frameworks.psgtr import PSGTr
from pairnet_torch.models.heads.pairnet_head import PairNetHead
from pairnet_torch.models.layers import (
    FrozenBatchNorm,
    MSDeformAttention,
    MultiheadAttention,
    RMSNorm,
    deform_offsets_bias,
)
from pairnet_torch.ops.deform_attn_bwd import BWD_VARIANTS

BACKBONES = {
    "r50": lambda tiny: ResNet(depth=50, base_width=8 if tiny else 64),
    "swinb": lambda tiny: (SwinTransformer(embed_dim=16, depths=(1, 1, 2, 1),
                                           num_heads=(1, 2, 4, 8), window=4)
                           if tiny else SwinTransformer()),
}
TRUNC_NORMAL_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; asking for CUDA without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer from a seeded generator: lecun-normal
    kernels and zero biases, N(0, 1) query tables (and the box head's
    ``level_embeds``), Swin's relative-position
    tables from JAX's truncated normal(0.02) (N(0, 1) cut at +-2 sigma,
    scaled to std 0.02), identity norms, and mmcv's deformable-attention
    init (zero offset/weight kernels, offset grid bias)."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=g)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, WindowMSA):
                std = 0.02 / TRUNC_NORMAL_STD
                nn.init.trunc_normal_(m.relative_position_bias_table, 0.0, std, -2 * std,
                                      2 * std, generator=g)
            elif isinstance(m, MultiheadAttention):
                m.in_proj_weight.normal_(0.0, 1.0 / math.sqrt(m.embed_dims), generator=g)
                m.in_proj_bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            if isinstance(getattr(m, "level_embeds", None), nn.Parameter):
                m.level_embeds.normal_(0.0, 1.0, generator=g)
        for m in model.modules():
            if isinstance(m, MSDeformAttention):
                m.sampling_offsets.weight.zero_()
                m.sampling_offsets.bias.copy_(
                    deform_offsets_bias(m.num_heads, m.num_levels, m.num_points)
                )
                m.attention_weights.weight.zero_()
                m.attention_weights.bias.zero_()
    return model


def perturb_deform_kernels(model: nn.Module, seed: int = 1, std: float = 0.05) -> nn.Module:
    """Give the zero-initialised sampling-offset and attention-weight kernels
    seeded noise, so the deformable taps move off their initial grid."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttention):
                for lin in (m.sampling_offsets, m.attention_weights):
                    noise = torch.randn(lin.weight.shape, generator=g, device=device)
                    lin.weight.add_(std * noise.to(lin.weight.dtype))
    return model


def set_deform_impl(model: nn.Module, impl: str | None) -> nn.Module:
    """Route every MSDeformAttention of ``model`` through ``impl``."""
    for m in model.modules():
        if isinstance(m, MSDeformAttention):
            m.impl = impl
    return model


def set_flash_attention(model: nn.Module, on: bool) -> nn.Module:
    """Switch the masked flash-attention route of every MultiheadAttention
    of ``model`` on or off (JAX's ``PAIRNET_FLASH_ATTN=1``)."""
    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            m.flash = bool(on)
    return model


def set_deform_bwd(model: nn.Module, bwd: str) -> nn.Module:
    """Give every MSDeformAttention of ``model`` the MSDA backward ``bwd``
    ("exact" or "bf16_grad")."""
    if bwd not in BWD_VARIANTS:
        raise ValueError(f"unknown MSDA backward {bwd!r}: expected one of {BWD_VARIANTS}")
    for m in model.modules():
        if isinstance(m, MSDeformAttention):
            m.bwd = bwd
    return model


def flagship(tiny: bool = False, device=None, dtype=torch.float32, seed: int = 0,
             relation_ffn_drop: float = 0.1, backbone: str = "r50") -> PSGTr:
    """Pair-Net on ``backbone`` ("r50" or "swinb") with seeded weights, in
    eval mode, on ``device`` (default CUDA). ``dtype=torch.bfloat16`` casts
    every float parameter and buffer, frozen BN statistics included, as the
    JAX bf16 serving does. ``relation_ffn_drop`` is the Relation Fusion
    FFN's dropout in train mode."""
    if backbone not in BACKBONES:
        raise ValueError(f"backbone {backbone!r}: expected one of {sorted(BACKBONES)}")
    device = resolve_device(device)
    with torch.device("meta"):  # allocate nothing until the device is known
        bb = BACKBONES[backbone](tiny)
        if tiny:
            head = PairNetHead(
                bb.out_channels, num_classes=7, num_relations=5, num_obj_query=20,
                num_rel_query=16, embed_dims=32, num_heads=4, num_decoder_layers=3,
                num_relation_layers=2, pixel_decoder_layers=1,
                relation_ffn_drop=relation_ffn_drop,
            )
        else:
            head = PairNetHead(
                bb.out_channels, num_classes=133, num_relations=56, num_obj_query=100,
                num_rel_query=100, embed_dims=256, num_heads=8, num_decoder_layers=9,
                num_relation_layers=6, pixel_decoder_layers=6,
                relation_ffn_drop=relation_ffn_drop,
            )
        model = PSGTr(bb, head)
    model = model.to_empty(device=device)
    init_weights(model, seed)
    return model.to(dtype).eval()
