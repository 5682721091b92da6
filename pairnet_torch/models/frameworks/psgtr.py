"""Single-stage scene-graph detector shell (backbone -> one-stage head).

Counterpart of ``pairnet_tpu/models/frameworks/psgtr.py::PSGTr``. Images
come in NHWC, as in the JAX package, and run NCHW inside.
"""

from __future__ import annotations

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
