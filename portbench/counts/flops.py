"""Model FLOPs from the configuration's shapes: ``FlopCounterMode`` over the
plain reference's forward on the ``meta`` device (two operations a
multiply-add of every convolution and matrix product; the deformable
sampling, norms and activations are left out), one image at a time."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import pairnet

BF16_DENSE_FLOPS = 989e12  # one H100 SXM, dense bf16 tensor cores


def forward_flops_per_image(model_cfg: dict, image_hw) -> float:
    params = {n: torch.empty(s, device="meta") for n, s, _ in pairnet.param_specs(model_cfg)}
    images = torch.empty((1, *image_hw, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        pairnet.forward(params, images, model_cfg)
    return float(counter.get_total_flops())
