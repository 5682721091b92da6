"""Panoptic Quality (PQ) evaluation (the port's copy of
``pairnet_tpu/evaluation/panoptic_quality.py``, numpy only).

Counterpart of the reference's PQ metric path (ref: pairnet/datasets/psg.py:
320-335, delegated to mmdet CocoPanopticDataset + panopticapi). Vectorized
numpy: segment intersections come from one confusion pass over the combined
(gt_id * OFFSET + pred_id) map (the panopticapi trick), and matches are the
IoU > 0.5 pairs (provably unique).

Conventions: a panoptic id map encodes ``instance_id * INSTANCE_OFFSET +
label`` (our predictions; see models/heads/pairnet_inference.py) or arbitrary
unique ids with a separate id->label mapping (GT from PSGDataset segments).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

VOID = -1
_OFFSET = 256**3


@dataclass
class PQStat:
    iou: float = 0.0
    tp: int = 0
    fp: int = 0
    fn: int = 0

    def __iadd__(self, other):
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn
        return self

    @property
    def pq(self) -> float:
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        return self.iou / denom if denom else 0.0

    @property
    def sq(self) -> float:
        return self.iou / self.tp if self.tp else 0.0

    @property
    def rq(self) -> float:
        denom = self.tp + 0.5 * self.fp + 0.5 * self.fn
        return self.tp / denom if denom else 0.0


def pq_single_image(
    gt_ids: np.ndarray,  # (H, W) int segment ids; VOID = -1
    gt_id2label: dict[int, int],
    pred_ids: np.ndarray,  # (H, W) int segment ids; VOID = -1
    pred_id2label: dict[int, int],
    num_classes: int,
) -> dict[int, PQStat]:
    """Per-class PQ stats for one image (panopticapi pq_compute_single_core
    semantics, vectorized)."""
    per_class = {c: PQStat() for c in range(num_classes)}

    gt_segs = {
        int(i): int(n)
        for i, n in zip(*np.unique(gt_ids[gt_ids != VOID], return_counts=True))
    }
    pred_segs = {
        int(i): int(n)
        for i, n in zip(*np.unique(pred_ids[pred_ids != VOID], return_counts=True))
    }

    both = (gt_ids != VOID) & (pred_ids != VOID)
    combined = gt_ids[both].astype(np.int64) * _OFFSET + pred_ids[both].astype(np.int64)
    inter_ids, inter_cnt = np.unique(combined, return_counts=True)

    matched_gt: set[int] = set()
    matched_pred: set[int] = set()
    for comb, n_int in zip(inter_ids.tolist(), inter_cnt.tolist()):
        g = comb // _OFFSET
        p = comb % _OFFSET
        if gt_id2label.get(g) != pred_id2label.get(p):
            continue
        union = gt_segs[g] + pred_segs[p] - n_int
        iou = n_int / union
        if iou > 0.5:
            c = gt_id2label[g]
            per_class[c].tp += 1
            per_class[c].iou += iou
            matched_gt.add(g)
            matched_pred.add(p)

    for g, _ in gt_segs.items():
        if g not in matched_gt and g in gt_id2label:
            per_class[gt_id2label[g]].fn += 1
    # unmatched predictions that mostly cover VOID are not penalized
    void_mask = gt_ids == VOID
    for p, area in pred_segs.items():
        if p in matched_pred or p not in pred_id2label:
            continue
        void_overlap = int(np.count_nonzero(void_mask & (pred_ids == p)))
        if void_overlap / area > 0.5:
            continue
        per_class[pred_id2label[p]].fp += 1
    return per_class


def pq_stats(
    images: list[tuple],  # (gt_ids, gt_id2label, pred_ids, pred_id2label)
    num_classes: int,
) -> dict[int, PQStat]:
    """Per-class PQ stats summed over a dataset's images."""
    agg = {c: PQStat() for c in range(num_classes)}
    for gt_ids, gt_map, pred_ids, pred_map in images:
        stats = pq_single_image(gt_ids, gt_map, pred_ids, pred_map, num_classes)
        for c, s in stats.items():
            agg[c] += s
    return agg


def pq_summarize(agg: dict[int, PQStat], num_classes: int, num_things: int = 80) -> dict:
    """PQ / SQ / RQ (All, Things, Stuff) of summed per-class stats."""

    def summarize(classes):
        present = [
            c for c in classes if agg[c].tp + agg[c].fp + agg[c].fn > 0
        ]
        if not present:
            return dict(PQ=0.0, SQ=0.0, RQ=0.0, n=0)
        return dict(
            PQ=float(np.mean([agg[c].pq for c in present])) * 100,
            SQ=float(np.mean([agg[c].sq for c in present])) * 100,
            RQ=float(np.mean([agg[c].rq for c in present])) * 100,
            n=len(present),
        )

    out = {"All": summarize(range(num_classes))}
    out["Things"] = summarize(range(num_things))
    out["Stuff"] = summarize(range(num_things, num_classes))
    return out


def pan_seg_to_ids(pan_seg: np.ndarray, instance_offset: int = 1000):
    """Decode an ``m_id * offset + label`` panoptic map into (ids, id2label)."""
    ids = pan_seg.astype(np.int64)
    uniq = np.unique(ids)
    id2label = {int(u): int(u % instance_offset) for u in uniq}
    return ids, id2label
