"""Head type -> post-processing dispatch for the CLIs (the port's counterpart
of ``pairnet_tpu/train/dispatch.py::get_postprocess_fn``; only Pair-Net's
head is ported)."""

from __future__ import annotations

from typing import Callable


def get_postprocess_fn(head_type: str) -> Callable:
    """Per-image raw outputs -> TripletPrediction."""
    if head_type == "PairNetHead":
        from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess

        return pairnet_postprocess
    raise NotImplementedError(f"no post-processing for head type {head_type!r} in the port "
                              "yet (only PairNetHead; ROADMAP queue A)")
