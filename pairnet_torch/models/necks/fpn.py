"""Feature Pyramid Network neck (mmdet FPN semantics), NCHW.

Counterpart of ``pairnet_tpu/models/necks/fpn.py``: 1x1 laterals, a
top-down pathway with nearest upsampling (floor index mapping, mmdet's
default; not bilinear), 3x3 output convs, and extra levels as max-pools of
kernel 1 and stride 2 of the last output. Module names are mmdet's
(``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``).
"""

from __future__ import annotations

import torch
from torch import nn


def nearest_resize(x, size):
    """torch ``F.interpolate(mode="nearest")`` of NCHW maps: floor index mapping."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = size
    ys = torch.arange(h_out, device=x.device) * h_in // h_out
    xs = torch.arange(w_out, device=x.device) * w_in // w_out
    return x[:, :, ys][:, :, :, xs]


class ConvModule(nn.Module):
    """mmcv ConvModule without norm or activation: its ``conv`` only."""

    def __init__(self, cin, cout, kernel_size):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, padding=kernel_size // 2)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3)
                                       for _ in in_channels)

    def forward(self, feats):
        """feats: (C2..C5) NCHW -> (P2..P{num_outs+1}) at strides 4, 8, ...."""
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_resize(laterals[i],
                                                               laterals[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])  # max-pool, kernel 1, stride 2
        return outs
