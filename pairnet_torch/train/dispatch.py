"""Head type -> loss and post-processing dispatch for the CLIs (the port's
counterpart of ``pairnet_tpu/train/dispatch.py``; only Pair-Net's head is
ported, the other heads wait for ROADMAP A.7)."""

from __future__ import annotations

import functools
from typing import Callable


def get_loss_fn(head_type: str, cfg, reduce=None) -> Callable:
    """The head's loss with the config's ``loss`` options:
    ``loss(outputs, batch, points, cum_samples, targets=None) -> (losses,
    new_cum_samples)``; its ``num_points`` attribute is the number of
    points the mask costs and losses sample. ``reduce`` sums a tensor over
    the data-parallel ranks (None: world size 1)."""
    loss_cfg = dict(cfg.get("loss", {}))
    if reduce is not None:
        loss_cfg["reduce"] = reduce
    if head_type == "PairNetHead":
        from pairnet_torch.models.heads.pairnet_loss import pairnet_loss

        num_points = loss_cfg.pop("num_points", 12544)
        fn = functools.partial(pairnet_loss, **loss_cfg)
        fn.num_points = num_points
        return fn
    raise NotImplementedError(f"no loss for head type {head_type!r} in the port yet (only "
                              "PairNetHead; ROADMAP A.7)")


def get_postprocess_fn(head_type: str) -> Callable:
    """Per-image raw outputs -> TripletPrediction."""
    if head_type == "PairNetHead":
        from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess

        return pairnet_postprocess
    raise NotImplementedError(f"no post-processing for head type {head_type!r} in the port "
                              "yet (only PairNetHead; ROADMAP A.7)")
