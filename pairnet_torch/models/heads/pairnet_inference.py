"""Pair-Net inference post-processing on the device.

Counterpart of ``pairnet_tpu/models/heads/pairnet_inference.py``:

* sub/obj labels: argmax of the softmax without the background column,
  +1 (1-based labels),
* r_dists: softmax over predicates with a zero background column prepended,
* DETR-style panoptic fusion: a query is kept if its score > 0.5 and its
  label is not the last foreground class (the reference's quirk, kept for
  parity); per-pixel argmax over the kept queries; kept stuff queries of
  one class merge into the first of them; segments of area <= 4 are
  removed until none is left; pan id = m_id * INSTANCE_OFFSET + label,
* sub/obj masks: sigmoid > 0.5 at the output resolution.

The removal of small segments is a Python loop where the JAX package has a
``while_loop``: each pass costs one host sync (``bool(tiny.any())``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pairnet_torch.utils import tracing

INSTANCE_OFFSET = 1000  # mmdet.datasets.coco_panoptic.INSTANCE_OFFSET
NO_OBJ = 133  # pan_seg id fill when nothing is detected


class PanopticFusionResult(NamedTuple):
    pan_seg: torch.Tensor  # (H, W) int64: m_id * INSTANCE_OFFSET + label
    keep: torch.Tensor  # (Q,) bool
    labels: torch.Tensor  # (Q,) per-query class (0-based)
    scores: torch.Tensor  # (Q,) f32


def panoptic_fusion(cls_logits, mask_logits, num_things=80, score_thr=0.5, min_area=4):
    """cls_logits (Q, C+1); mask_logits (Q, H, W) at the output resolution."""
    with tracing.span("postprocess.fusion"):
        Q, C1 = cls_logits.shape
        C = C1 - 1
        probs = torch.softmax(cls_logits.float(), dim=-1)[:, :-1]
        scores = probs.amax(dim=-1)
        labels = probs.argmax(dim=-1)  # first maximum on ties, as jnp.argmax
        # parity quirk: the reference excludes label == C-1, not the bg column
        keep0 = (labels != C - 1) & (scores > score_thr)

        H, W = mask_logits.shape[-2:]
        flat = mask_logits.reshape(Q, H * W).float()
        qidx = torch.arange(Q, device=cls_logits.device)
        is_stuff = labels >= num_things
        same_class = (labels[:, None] == labels[None, :]) & keep0[None, :]
        first_same = torch.where(same_class, qidx[None, :], Q).amin(dim=1)
        redirect = torch.where(is_stuff & keep0 & (first_same < Q), first_same, qidx)

        def fuse(keep):
            logits = torch.where(keep[:, None], flat, float("-inf"))
            m_id = redirect[logits.argmax(dim=0)]
            m_id = torch.where(keep.any(), m_id, 0)
            areas = torch.bincount(m_id, minlength=Q)
            return m_id, torch.where(keep, areas, 0)

        keep = keep0
        while True:
            m_id, areas = fuse(keep)
            tiny = keep & (areas <= min_area)
            if not bool(tiny.any()):
                break
            keep = keep & ~tiny

        pan = torch.where(
            keep.any(), m_id * INSTANCE_OFFSET + labels[m_id], INSTANCE_OFFSET + NO_OBJ
        )
        return PanopticFusionResult(pan_seg=pan.reshape(H, W), keep=keep, labels=labels,
                                    scores=scores)


class TripletPrediction(NamedTuple):
    labels: torch.Tensor  # (2K,) 1-based sub then obj labels
    rel_pairs: torch.Tensor  # (K, 2) indices [i, i+K]
    masks: torch.Tensor  # (2K, H, W) bool sub then obj masks
    pan_seg: torch.Tensor  # (H, W)
    r_dists: torch.Tensor  # (K, R+1) predicate distribution with bg column
    r_labels: torch.Tensor  # (K,) argmax predicate (1-based)
    r_scores: torch.Tensor  # (K,) max predicate prob


def pairnet_postprocess(outputs: dict, image_index: int | None = None,
                        num_things: int = 80) -> TripletPrediction:
    """Post-process one image's head outputs (index ``image_index`` of each entry)."""
    b = image_index
    get = (lambda x: x[b]) if b is not None else (lambda x: x)
    r_cls = get(outputs["rel"])
    K = r_cls.shape[0]
    dev = r_cls.device
    s_labels = torch.softmax(get(outputs["sub"]).float(), -1)[:, :-1].argmax(-1) + 1
    o_labels = torch.softmax(get(outputs["obj"]).float(), -1)[:, :-1].argmax(-1) + 1
    r_dists = torch.softmax(r_cls.float(), dim=-1)
    r_dists = torch.cat([torch.zeros((K, 1), device=dev), r_dists], dim=-1)
    fusion = panoptic_fusion(get(outputs["cls"]), get(outputs["mask"]), num_things=num_things)
    masks = torch.cat(
        [torch.sigmoid(get(outputs["sub_seg"])) > 0.5, torch.sigmoid(get(outputs["obj_seg"])) > 0.5]
    )
    ar = torch.arange(K, device=dev)
    return TripletPrediction(
        labels=torch.cat([s_labels, o_labels]),
        rel_pairs=torch.stack([ar, ar + K], dim=-1),
        masks=masks,
        pan_seg=fusion.pan_seg,
        r_dists=r_dists,
        r_labels=r_dists[:, 1:].argmax(-1) + 1,
        r_scores=r_dists[:, 1:].amax(-1),
    )
