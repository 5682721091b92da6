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
    """backbone -> (neck) -> head. The box head's ChannelMapper sits at the
    model's ``neck``, as in the reference's checkpoints; JAX keeps it inside
    its head."""

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module, neck: nn.Module | None = None):
        super().__init__()
        self.backbone = backbone
        if neck is not None:
            self.neck = neck
        self.bbox_head = bbox_head

    def forward(self, images):
        """images (B, H, W, 3) -> the head's prediction dict."""
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        if hasattr(self, "neck"):
            feats = self.neck(feats)
        return self.bbox_head(feats)


def _not_ported(what: str, item: str = "the model zoo"):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A: {item})")


def _heads() -> dict:
    """Head type -> a factory that takes the backbone's output channels and
    the head's config and returns (head, neck or None)."""
    from pairnet_torch.models.heads.baseline_head import BaselineHead, MyPSGFormerHead
    from pairnet_torch.models.heads.detr4seg_head import Detr4SegHead
    from pairnet_torch.models.heads.pairnet_bbox_head import crosshead_bbox_with_neck
    from pairnet_torch.models.heads.pairnet_head import PairNetHead
    from pairnet_torch.models.heads.psgformer_head import PSGFormerHead
    from pairnet_torch.models.heads.psgtr2_head import PSGTr2Head
    from pairnet_torch.models.heads.psgtr_head import PSGTrHead

    def alone(cls):
        return lambda channels, **cfg: (cls(channels, **cfg), None)

    return {"PairNetHead": alone(PairNetHead), "PSGTrHead": alone(PSGTrHead),
            "PSGFormerHead": alone(PSGFormerHead), "BaselineHead": alone(BaselineHead),
            "MyPSGFormerHead": alone(MyPSGFormerHead), "PSGTr2Head": alone(PSGTr2Head),
            "Detr4SegHead": alone(Detr4SegHead), "CrossHeadBBox": crosshead_bbox_with_neck}


def _relation_heads() -> dict:
    """Two-stage relation head type -> class (keyword arguments: its config)."""
    from pairnet_torch.models.heads.twostage.heads import GPSHead, IMPHead, MotifHead
    from pairnet_torch.models.heads.twostage.vctree import VCTreeHead

    return {"MotifHead": MotifHead, "IMPHead": IMPHead, "GPSHead": GPSHead,
            "VCTreeHead": VCTreeHead}


def build_backbone(cfg: Mapping[str, Any]) -> nn.Module:
    """A ``ResNet``, ``ResNeXt`` or ``SwinTransformer`` from its config node."""
    from pairnet_torch.models.backbones.resnet import ResNet, ResNeXt
    from pairnet_torch.models.backbones.swin import SwinTransformer

    backbones = {"ResNet": ResNet, "ResNeXt": ResNeXt, "SwinTransformer": SwinTransformer}
    bb = dict(cfg)
    bb_type = bb.pop("type")
    if bb_type not in backbones:
        raise _not_ported(f"backbone {bb_type!r}")
    return backbones[bb_type](**bb)


def _build(model_cfg: dict) -> nn.Module:
    """The model of a config node, on the current default device."""
    model_type = model_cfg.get("type")
    if model_type == "SceneGraphTwoStage":
        if "relation_head" not in model_cfg:
            raise ValueError("a SceneGraphTwoStage config needs a relation_head")
        head = dict(model_cfg["relation_head"])
        head_type = head.pop("type")
        heads = _relation_heads()
        if head_type not in heads:
            raise _not_ported(f"relation head {head_type!r}")
        neck_channels = model_cfg.get("neck_channels", 256)
        from pairnet_torch.models.frameworks.twostage import SceneGraphTwoStage

        # the sgdet configs' ``detector`` is the CLI's, not the model's
        return SceneGraphTwoStage(build_backbone(model_cfg["backbone"]),
                                  heads[head_type](in_channels=neck_channels, **head),
                                  neck_channels)
    if model_type == "PanopticFPN":
        from pairnet_torch.models.frameworks.panoptic_fpn import PanopticFPN

        det = {k: v for k, v in model_cfg.items() if k not in ("type", "backbone")}
        return PanopticFPN(build_backbone(model_cfg["backbone"]), **det)
    if model_type != "PSGTr" or "bbox_head" not in model_cfg:
        raise _not_ported(f"model type {model_type!r}")
    head = dict(model_cfg["bbox_head"])
    head_type = head.pop("type")
    head.pop("in_channels", None)  # taken from the backbone, as flax infers it
    heads = _heads()
    if head_type not in heads:
        if head_type in _relation_heads():
            raise ValueError(f"{head_type} is a two-stage relation head: its model is "
                             "SceneGraphTwoStage (model.relation_head)")
        raise _not_ported(f"head {head_type!r}")
    backbone = build_backbone(model_cfg["backbone"])
    return PSGTr(backbone, *heads[head_type](backbone.out_channels, **head))


def build_model(cfg: Mapping[str, Any], device=None, seed: int = 0) -> nn.Module:
    """A model from a model config node, with seeded weights
    (``flagship.init_weights``), in eval mode, on ``device`` (default CUDA):
    ``PSGTr`` with a ``ResNet``, ``ResNeXt`` or ``SwinTransformer`` backbone
    and one of the one-stage heads of :func:`_heads` (Pair-Net with any of
    its matrix learners or ``direct``, PSGTr, PSGFormer, the Mask2Former
    baselines, PSGTr2, DETR4Seg) or the box Pair-Net ``CrossHeadBBox`` with
    its ChannelMapper neck over the backbone's last three levels;
    ``SceneGraphTwoStage`` with a relation head of :func:`_relation_heads`
    (MOTIFS, IMP, GPS-Net, VCTree); or the two-stage detector
    ``PanopticFPN``. Another type raises ``NotImplementedError``."""
    from pairnet_torch.flagship import init_weights, resolve_device

    device = resolve_device(device)
    with torch.device("meta"):  # allocate nothing until the device is known
        model = _build(dict(cfg))
    model = model.to_empty(device=device)
    init_weights(model, seed)
    return model.eval()
