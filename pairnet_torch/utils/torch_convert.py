"""Load a reference PyTorch checkpoint (an mmdet / mmcv ``.pth``) into a port model.

Counterpart of ``pairnet_tpu/utils/torch_convert.py``. The JAX package
converts a reference state dict into flax trees (``convert_*_checkpoint``:
transposed kernels, split q/k/v projections, BatchNorm into ``constants``)
and overlays it with ``merge_pretrained``. The port names every module
after the reference's state-dict keys and keeps torch's layouts, so the
same checkpoint loads by name, with ``merge_pretrained``'s rules: a key no
port tensor takes raises ``KeyError``, a shape mismatch ``ValueError``, and
a tensor the file lacks keeps its init.

Two things differ from a plain ``load_state_dict``:

* A Mask2Former segmenter checkpoint (mmdet's ``Mask2Former``, the
  ``load_from pretrain/m2f_r50_coco.pth`` warm start) names its head
  ``panoptic_head``; onto a model with a ``bbox_head`` its keys move there
  (``convert_mask2former_checkpoint``'s reading: the backbone,
  ``pixel_decoder``, ``transformer_decoder``, the query tables,
  ``cls_embed`` and ``mask_embed``). Pair-Net's PPN and Relation Fusion,
  which that file lacks, keep their init.
* The reference keys that no port tensor holds are skipped by kind, and
  only these kinds (:data:`SKIPPED_KINDS`); they are the keys the JAX
  package's converters leave unread.

The file is read with ``torch.load(..., weights_only=True)``: tensors and
plain containers only, no pickled objects. Only its ``state_dict`` is read
(a bare state dict is taken as one); ``meta`` and ``optimizer`` are ignored.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping

import torch
from torch import nn

from pairnet_torch.models.backbones.swin import WindowMSA
from pairnet_torch.models.frameworks.twostage import SceneGraphTwoStage
from pairnet_torch.models.heads.twostage.core import RunningBatchNorm
from pairnet_torch.models.layers import FrozenBatchNorm

logger = logging.getLogger("pairnet_torch")

SKIPPED_KINDS = {
    "num_batches_tracked": "the update counter of an mmdet BatchNorm, which the port's frozen "
                           "and running-statistics BatchNorms do not keep",
    "relative_position_index": "Swin's window index table, which WindowMSA computes",
    "detector": "the frozen detector's rpn_head / roi_head / semantic_head in a two-stage "
                "relation checkpoint; the port's sgdet reads the detector from "
                "model.detector's own checkpoint",
}
_DETECTOR_HEADS = ("rpn_head", "roi_head", "semantic_head")
M2F_PREFIX, HEAD_PREFIX = "panoptic_head.", "bbox_head."


def reference_state_dict(path_or_state_dict) -> dict:
    """The ``state_dict`` of an mmcv checkpoint file or mapping (a bare
    state dict is returned as it is), as tensors."""
    ckpt = path_or_state_dict
    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, Mapping):
        raise ValueError(f"expected a state dict or an mmcv checkpoint, got {type(ckpt)}")
    sd = ckpt.get("state_dict", ckpt)
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def skipped_kind(model: nn.Module, modules: Mapping[str, nn.Module], key: str) -> str | None:
    """The kind of :data:`SKIPPED_KINDS` that reference ``key`` (in the
    port's names) is of, or None."""
    owner, _, leaf = key.rpartition(".")
    if leaf == "num_batches_tracked" and isinstance(modules.get(owner),
                                                    (FrozenBatchNorm, RunningBatchNorm)):
        return "num_batches_tracked"
    if leaf == "relative_position_index" and isinstance(modules.get(owner), WindowMSA):
        return "relative_position_index"
    if isinstance(model, SceneGraphTwoStage) and key.split(".", 1)[0] in _DETECTOR_HEADS:
        return "detector"
    return None


def port_names(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> tuple[dict, list[str]]:
    """``sd`` under the port's names (a Mask2Former ``panoptic_head`` moved
    onto the model's ``bbox_head``), and the reference keys skipped by kind."""
    if (hasattr(model, "bbox_head") and any(k.startswith(M2F_PREFIX) for k in sd)
            and not any(k.startswith(HEAD_PREFIX) for k in sd)):
        sd = {HEAD_PREFIX + k[len(M2F_PREFIX):] if k.startswith(M2F_PREFIX) else k: v
              for k, v in sd.items()}
    modules = dict(model.named_modules())
    named, skipped = {}, []
    for key, val in sd.items():
        if skipped_kind(model, modules, key):
            skipped.append(key)
        else:
            named[key] = val
    return named, sorted(skipped)


def load_reference_checkpoint(model: nn.Module, path_or_state_dict) -> list[str]:
    """Overlay a reference checkpoint (a ``.pth`` path, an mmcv checkpoint
    dict or a bare state dict) onto ``model`` in place; returns the
    reference keys skipped by kind. Raises before copying anything: an
    unknown key ``KeyError``, a shape mismatch ``ValueError``."""
    named, skipped = port_names(model, reference_state_dict(path_or_state_dict))
    state = model.state_dict(keep_vars=True)
    unknown = sorted(set(named) - set(state))
    if unknown:
        raise KeyError(f"unexpected checkpoint keys: {unknown}")
    for name, val in named.items():
        if state[name].shape != val.shape:
            raise ValueError(f"shape mismatch at {name}: {tuple(state[name].shape)} vs "
                             f"{tuple(val.shape)}")
    with torch.no_grad():
        for name, val in named.items():
            state[name].copy_(val)
    logger.info("checkpoint: %d tensors loaded, %d kept their init, %d keys skipped",
                len(named), len(state) - len(named), len(skipped))
    return skipped
