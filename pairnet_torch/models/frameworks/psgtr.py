"""Single-stage scene-graph detector shell (backbone -> one-stage head).

Counterpart of ``pairnet_tpu/models/frameworks/psgtr.py``: :class:`PSGTr`
and :func:`build_model`. Images come in NHWC, as in the JAX package, and
run NCHW inside.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn


class PSGTr(nn.Module):
    def __init__(self, backbone: nn.Module, bbox_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.bbox_head = bbox_head

    def forward(self, images):
        """images (B, H, W, 3) -> the head's prediction dict."""
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        return self.bbox_head(feats)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A: the model zoo)")


def build_model(cfg: Mapping[str, Any], device=None, seed: int = 0) -> PSGTr:
    """A detector from a model config node, with seeded weights
    (``flagship.init_weights``), in eval mode, on ``device`` (default CUDA).
    Ported: ``PSGTr`` with a ``ResNet`` or ``SwinTransformer`` backbone and
    a ``PairNetHead`` (any of the five matrix learners, ``direct`` or not);
    anything else raises."""
    from pairnet_torch.flagship import init_weights, resolve_device
    from pairnet_torch.models.backbones.resnet import ResNet
    from pairnet_torch.models.backbones.swin import SwinTransformer
    from pairnet_torch.models.heads.pairnet_head import PairNetHead

    backbones = {"ResNet": ResNet, "SwinTransformer": SwinTransformer}
    model_cfg = dict(cfg)
    if model_cfg.get("type") != "PSGTr" or "bbox_head" not in model_cfg:
        raise _not_ported(f"model type {model_cfg.get('type')!r}")
    bb = dict(model_cfg["backbone"])
    bb_type = bb.pop("type")
    if bb_type not in backbones:
        raise _not_ported(f"backbone {bb_type!r}")
    head = dict(model_cfg["bbox_head"])
    if head.pop("type") != "PairNetHead":
        raise _not_ported(f"head {cfg['bbox_head']['type']!r}")
    device = resolve_device(device)
    with torch.device("meta"):  # allocate nothing until the device is known
        backbone = backbones[bb_type](**bb)
        model = PSGTr(backbone, PairNetHead(backbone.out_channels, **head))
    model = model.to_empty(device=device)
    init_weights(model, seed)
    return model.eval()
