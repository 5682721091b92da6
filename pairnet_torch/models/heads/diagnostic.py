"""Score an external segmenter through the scene-graph evaluation.

Counterpart of ``pairnet_tpu/models/heads/diagnostic.py``:
``diagnostic_postprocess`` takes per-query class and mask logits of any
segmenter and an optional label-mapping table, fuses them with
:func:`~pairnet_torch.models.heads.pairnet_inference.panoptic_fusion`, and
returns a TripletPrediction whose relation fields are dummies: it scores
for PQ and detection quality, with zero recall.
"""

from __future__ import annotations

import torch

from pairnet_torch.models.heads.pairnet_inference import (
    INSTANCE_OFFSET,
    TripletPrediction,
    panoptic_fusion,
)


def diagnostic_postprocess(outputs: dict, image_index: int | None = None, num_things: int = 80,
                           num_relations: int = 56, label_mapping=None, score_thr: float = 0.85):
    """outputs: ``cls`` (B, Q, C+1) and ``mask`` (B, Q, h, w) logits.
    ``label_mapping`` maps the segmenter's 0-based label to the target
    dataset's (identity when None); the panoptic map is then rebuilt in the
    mapped label space."""
    b = image_index
    get = (lambda x: x[b]) if b is not None else (lambda x: x)
    cls_logits = get(outputs["cls"])
    mask_logits = get(outputs["mask"])
    Q = cls_logits.shape[0]
    dev = cls_logits.device
    fused = panoptic_fusion(cls_logits, mask_logits, num_things=num_things, score_thr=score_thr)
    labels0, pan_seg = fused.labels, fused.pan_seg
    if label_mapping is not None:
        labels0 = torch.as_tensor(label_mapping, device=dev)[labels0]
        m_id = torch.div(pan_seg, INSTANCE_OFFSET, rounding_mode="floor")
        pan_seg = m_id * INSTANCE_OFFSET + labels0[m_id]
    # duplicated sub/obj views of the same detections, 1-based labels;
    # dropped queries get label 0 and an empty mask, so they never match
    labels1 = torch.where(fused.keep, labels0 + 1, 0)
    masks = (torch.sigmoid(mask_logits.float()) > 0.5) & fused.keep[:, None, None]
    ar = torch.arange(Q, device=dev)
    return TripletPrediction(
        labels=torch.cat([labels1, labels1]),
        rel_pairs=torch.stack([ar, ar + Q], dim=-1),
        masks=torch.cat([masks, masks]),
        pan_seg=pan_seg,
        r_dists=torch.zeros((Q, num_relations + 1), device=dev),
        r_labels=torch.zeros((Q,), dtype=torch.long, device=dev),
        r_scores=torch.zeros((Q,), device=dev),
    )
