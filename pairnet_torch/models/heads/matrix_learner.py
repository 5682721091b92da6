"""ConvTiny matrix learner of the Pair Proposal Network.

Counterpart of ``pairnet_tpu/models/heads/matrix_learner.py::ConvTiny``
(reference ``cnn_factory.py``): three 7x7 convolutions 1 -> 64 -> 64 -> 1
with ReLU between, on the (B, Q, Q) affinity. Parameters at
``conv_layers.<i>.0``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class ConvTiny(nn.Module):
    def __init__(self, mid_channels=64, kernel_size=7):
        super().__init__()
        chans = (1, mid_channels, mid_channels, 1)
        self.conv_layers = nn.ModuleList(
            [
                nn.Sequential(nn.Conv2d(chans[i], chans[i + 1], kernel_size,
                                        padding=kernel_size // 2))
                for i in range(3)
            ]
        )

    def forward(self, x):  # (B, Q, Q)
        y = x[:, None]
        for i, seq in enumerate(self.conv_layers):
            conv = seq[0]
            # computes in the input's type (flax promotion: an f32 affinity
            # against bf16 weights runs in f32)
            y = F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype),
                         padding=conv.padding)
            if i < 2:
                y = F.relu(y)
        return y[:, 0]
