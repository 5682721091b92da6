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


def _not_ported(what: str, item: str = "the model zoo"):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A: {item})")


def _heads() -> dict:
    """Head type -> the port's head class (each takes the backbone's
    output channels first)."""
    from pairnet_torch.models.heads.baseline_head import BaselineHead, MyPSGFormerHead
    from pairnet_torch.models.heads.detr4seg_head import Detr4SegHead
    from pairnet_torch.models.heads.pairnet_head import PairNetHead
    from pairnet_torch.models.heads.psgformer_head import PSGFormerHead
    from pairnet_torch.models.heads.psgtr2_head import PSGTr2Head
    from pairnet_torch.models.heads.psgtr_head import PSGTrHead

    return {"PairNetHead": PairNetHead, "PSGTrHead": PSGTrHead, "PSGFormerHead": PSGFormerHead,
            "BaselineHead": BaselineHead, "MyPSGFormerHead": MyPSGFormerHead,
            "PSGTr2Head": PSGTr2Head, "Detr4SegHead": Detr4SegHead}


# not yet ported: the head types of the bbox slice and the two-stage models
NOT_PORTED = {"CrossHeadBBox": "the bbox head (A.7)", "SceneGraphTwoStage": "two-stage (A.7)"}


def build_model(cfg: Mapping[str, Any], device=None, seed: int = 0) -> PSGTr:
    """A detector from a model config node, with seeded weights
    (``flagship.init_weights``), in eval mode, on ``device`` (default CUDA).
    Ported: ``PSGTr`` with a ``ResNet`` or ``SwinTransformer`` backbone and
    one of the one-stage heads of :func:`_heads` (Pair-Net with any of its
    matrix learners or ``direct``, PSGTr, PSGFormer, the Mask2Former
    baselines, PSGTr2, DETR4Seg). The bbox head and the two-stage models
    raise, naming their ROADMAP item."""
    from pairnet_torch.flagship import init_weights, resolve_device
    from pairnet_torch.models.backbones.resnet import ResNet
    from pairnet_torch.models.backbones.swin import SwinTransformer

    backbones = {"ResNet": ResNet, "SwinTransformer": SwinTransformer}
    model_cfg = dict(cfg)
    if model_cfg.get("type") in NOT_PORTED:
        raise _not_ported(f"model type {model_cfg['type']!r}", NOT_PORTED[model_cfg["type"]])
    if model_cfg.get("type") != "PSGTr" or "bbox_head" not in model_cfg:
        raise _not_ported(f"model type {model_cfg.get('type')!r}")
    bb = dict(model_cfg["backbone"])
    bb_type = bb.pop("type")
    if bb_type not in backbones:
        raise _not_ported(f"backbone {bb_type!r}")
    head = dict(model_cfg["bbox_head"])
    head_type = head.pop("type")
    head.pop("in_channels", None)  # taken from the backbone, as flax infers it
    heads = _heads()
    if head_type not in heads:
        raise _not_ported(f"head {head_type!r}", NOT_PORTED.get(head_type, "the model zoo"))
    device = resolve_device(device)
    with torch.device("meta"):  # allocate nothing until the device is known
        backbone = backbones[bb_type](**bb)
        model = PSGTr(backbone, heads[head_type](backbone.out_channels, **head))
    model = model.to_empty(device=device)
    init_weights(model, seed)
    return model.eval()
