"""ResNet and ResNeXt backbones (torchvision bottleneck, frozen BN), NCHW
inside.

Counterpart of ``pairnet_tpu/models/backbones/resnet.py::ResNet`` and
``::ResNeXt``, with torchvision's module names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``, ...), which ResNeXt shares:
its grouped 3x3 conv keeps the name ``conv2``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from pairnet_torch.models.layers import FrozenBatchNorm

STAGE_BLOCKS = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottleneck(nn.Module):
    """torchvision bottleneck; the stride sits in the 3x3 conv, which has
    ``groups`` groups over ``width`` inner channels (default ``planes``)."""

    def __init__(self, inplanes, planes, stride=1, downsample=False, groups=1, width=None):
        super().__init__()
        width = width or planes
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=groups,
                               bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm(planes * 4),
            )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Returns (C2, C3, C4, C5) at strides (4, 8, 16, 32), NCHW."""

    def __init__(self, depth=50, base_width=64):
        super().__init__()
        self._stages(depth, base_width, base_width, lambda planes: (1, planes))

    def _stages(self, depth, stem_width, planes, inner):
        """The stem and four stages; ``inner(planes)`` gives a stage's
        (groups, width) of its 3x3 convs."""
        self.conv1 = nn.Conv2d(3, stem_width, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(stem_width)
        inplanes = stem_width
        self.out_channels = []
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth]):
            groups, width = inner(planes)
            blocks = []
            for b in range(n_blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                blocks.append(Bottleneck(inplanes, planes, stride, downsample=(b == 0),
                                         groups=groups, width=width))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            self.out_channels.append(inplanes)
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        # torch MaxPool2d(3, 2, padding=1) pads with -inf, as the JAX stem does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(len(self.out_channels)):
            x = getattr(self, f"layer{stage + 1}")(x)
            outs.append(x)
        return tuple(outs)


class ResNeXt(ResNet):
    """ResNeXt (grouped bottlenecks; ResNeXt-101 32x8d by default): a 64-wide
    stem and planes 64, 128, 256, 512 as ResNet-50's, with inner width
    ``planes * base_width // 64 * groups`` in every block of a stage."""

    def __init__(self, depth=101, groups=32, base_width=8, stem_width=64):
        nn.Module.__init__(self)
        self._stages(depth, stem_width, 64,
                     lambda planes: (groups, planes * base_width // 64 * groups))
