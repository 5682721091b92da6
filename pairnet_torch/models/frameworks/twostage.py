"""Two-stage scene-graph framework (the predcls / sgcls / sgdet shell).

Counterpart of ``pairnet_tpu/models/frameworks/twostage.py``: backbone ->
FPN (4 levels) -> a relation head. In predcls and sgcls the detections are
the GT boxes of the batch; in sgdet the frozen detector
(``panoptic_fpn.PanopticFPN``) provides them through the batch. Images come
in NHWC, as in the JAX package and ``PSGTr.forward``.
"""

from __future__ import annotations

from torch import nn

from pairnet_torch.models.necks.fpn import FPN


class SceneGraphTwoStage(nn.Module):
    def __init__(self, backbone: nn.Module, relation_head: nn.Module, neck_channels: int = 256):
        super().__init__()
        self.backbone = backbone
        self.neck = FPN(backbone.out_channels, neck_channels, num_outs=4)
        self.relation_head = relation_head

    def forward(self, batch: dict) -> dict:
        """batch: ``image`` (B, H, W, 3) and the two-stage fields
        (``det_boxes``, ``det_labels`` 1-based, ``det_valid``, ``pairs``,
        ``pair_valid``, ``image_shape``; ``det_dists`` in sgdet)."""
        feats = self.backbone(batch["image"].permute(0, 3, 1, 2).contiguous())
        fpn = [f.permute(0, 2, 3, 1) for f in self.neck(feats)]
        return self.relation_head(fpn, batch)
