"""Scene-graph generation evaluation: R@K, mR@K, pairdet, phrdet (the
port's copy of ``pairnet_tpu/evaluation/sgg_eval.py``, numpy only).

Faithful re-implementation of the reference recall engine
(ref: pairnet/evaluation/sgg_eval.py:23-316 and sgg_metrics.py):

* triplet construction from ranked relation predictions
  (``pred_rels = [pair_inds, 1 + argmax(rel_dists[:, 1:])]``,
  ref: sgg_metrics.py:208-209) — NOTE the prediction ORDER is the ranking
  (Pair-Net emits relation queries in descending top-k importance order),
* graph-constraint matching: class-equality prefilter (``intersect_2d``,
  ref: sgg_eval_util.py:12-26) then mask-IoU (or box-IoU) >= 0.5 for BOTH
  subject and object (ref: sgg_metrics.py:1311-1371),
* R@K = |union of matched GT over top-K preds| / #gt_rels
  (ref: sgg_metrics.py:97),
* thing/stuff 4-group breakdown (labels 1-based; label > 80 = stuff,
  ref: sgg_metrics.py:101-124),
* phrdet (union region match) for sgdet (ref: sgg_metrics.py:241-252),
* mR@K: per-image per-predicate recall, averaged per predicate over images
  then over predicates (ref: sgg_metrics.py:737-916),
* pairdet: predicate label ignored in matching (ref: sgg_metrics.py:1329-31),
* predcls substitutes GT boxes/classes/masks (ref: sgg_eval.py:246-249).

Inputs use 1-based class labels and 1-based predicates with rel_dists
carrying a background column 0, exactly like the reference protocol.

This is the trusted numpy implementation; the batched on-device evaluator
(evaluation/device_eval.py) is validated against it in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce

import numpy as np

TOPK = (20, 50, 100)


@dataclass
class SGGroundTruth:
    labels: np.ndarray  # (N,) 1-based object classes
    rels: np.ndarray  # (R, 3) [sub_idx, obj_idx, predicate_1based]
    masks: np.ndarray | None = None  # (N, H, W) bool
    boxes: np.ndarray | None = None  # (N, 4) xyxy


@dataclass
class SGPrediction:
    labels: np.ndarray  # (M,) 1-based object classes
    rel_pair_idxes: np.ndarray  # (K, 2) indices into labels/masks/boxes
    rel_dists: np.ndarray  # (K, P+1) with bg column 0
    masks: np.ndarray | None = None  # (M, H, W) bool
    boxes: np.ndarray | None = None  # (M, 4)
    obj_scores: np.ndarray | None = None  # (M,)


def intersect_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-equality matrix: (len(a), len(b)) bool (ref: sgg_eval_util.py:12)."""
    if a.shape[1] != b.shape[1]:
        raise ValueError("arrays must have the same #columns")
    return (a[:, None] == b[None]).all(-1)


def _mask_iou_matrix(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """(G, H, W) x (P, H, W) -> (G, P) IoU via flattened matmul."""
    g = gt.reshape(gt.shape[0], -1).astype(np.float32)
    p = pred.reshape(pred.shape[0], -1).astype(np.float32)
    inter = g @ p.T
    union = g.sum(-1)[:, None] + p.sum(-1)[None] - inter
    return inter / np.maximum(union, 1e-9)


def _box_iou_matrix(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    lt = np.maximum(gt[:, None, :2], pred[None, :, :2])
    rb = np.minimum(gt[:, None, 2:], pred[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda b: np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None
    )
    union = area(gt)[:, None] + area(pred)[None] - inter
    return inter / np.maximum(union, 1e-9)


def _triplets(relations, classes, dets):
    """(sub_label, pred, obj_label) triplets + per-part detections."""
    sub, obj, pred = relations[:, 0], relations[:, 1], relations[:, 2]
    triplets = np.column_stack((classes[sub], pred, classes[obj]))
    det = np.stack((dets[sub], dets[obj]), axis=1)  # (R, 2, ...)
    return triplets, det


def _compute_pred_matches(
    gt_triplets,
    pred_triplets,
    gt_dets,
    pred_dets,
    iou_thr: float,
    use_masks: bool,
    phrdet: bool = False,
    ignore_rel: bool = False,
):
    """pred_to_gt: list per prediction of matched GT indices."""
    if ignore_rel:
        gt_triplets = gt_triplets[:, [0, 2]]
        pred_triplets = pred_triplets[:, [0, 2]]
    keeps = intersect_2d(gt_triplets, pred_triplets)
    pred_to_gt: list[list[int]] = [[] for _ in range(len(pred_triplets))]
    for gt_ind in np.where(keeps.any(1))[0]:
        keep_inds = keeps[gt_ind]
        cand = np.where(keep_inds)[0]
        if use_masks:
            g = gt_dets[gt_ind]  # (2, H, W)
            p = pred_dets[cand]  # (C, 2, H, W)
            if phrdet:
                gu = np.logical_or(g[0], g[1])[None]
                pu = np.logical_or(p[:, 0], p[:, 1])
                ok = _mask_iou_matrix(gu, pu)[0] >= iou_thr
            else:
                s_iou = _mask_iou_matrix(g[0][None], p[:, 0])[0]
                o_iou = _mask_iou_matrix(g[1][None], p[:, 1])[0]
                ok = (s_iou >= iou_thr) & (o_iou >= iou_thr)
        else:
            g = gt_dets[gt_ind]  # (2, 4)
            p = pred_dets[cand]  # (C, 2, 4)
            if phrdet:
                gu = np.concatenate([g.min(0)[:2], g.max(0)[2:]])[None]
                pu = np.concatenate([p.min(1)[:, :2], p.max(1)[:, 2:]], 1)
                ok = _box_iou_matrix(gu, pu)[0] >= iou_thr
            else:
                s_iou = _box_iou_matrix(g[0][None], p[:, 0])[0]
                o_iou = _box_iou_matrix(g[1][None], p[:, 1])[0]
                ok = (s_iou >= iou_thr) & (o_iou >= iou_thr)
        for i in cand[ok]:
            pred_to_gt[int(i)].append(int(gt_ind))
    return pred_to_gt


def _recall_at_k(pred_to_gt, num_gt: int):
    out = {}
    for k in TOPK:
        match = reduce(np.union1d, pred_to_gt[:k]) if pred_to_gt else np.array([])
        out[k] = (float(len(match)) / max(num_gt, 1), match)
    return out


@dataclass
class _Accumulator:
    recall: dict = field(default_factory=lambda: {k: [] for k in TOPK})
    phr_recall: dict = field(default_factory=lambda: {k: [] for k in TOPK})
    group_recall: list = field(
        default_factory=lambda: [{k: [] for k in TOPK} for _ in range(4)]
    )
    mean_recall_collect: dict = field(default_factory=dict)  # {k: [lists per pred]}
    num_predicates: int = 0

    def init_mr(self, num_predicates):
        self.num_predicates = num_predicates
        self.mean_recall_collect = {
            k: [[] for _ in range(num_predicates + 1)] for k in TOPK
        }


def sgg_evaluate(
    groundtruths: list[SGGroundTruth],
    predictions: list[SGPrediction],
    mode: str = "sgdet",
    num_predicates: int = 56,
    iou_thr: float = 0.5,
    detection_method: str = "pan_seg",
    num_things: int = 80,
) -> dict:
    """Evaluate a dataset; returns a flat {metric_name: value} dict."""
    assert mode in {"sgdet", "predcls", "sgcls", "pairdet"}
    use_masks = detection_method == "pan_seg"
    acc = _Accumulator()
    acc.init_mr(num_predicates)

    for gt, pred in zip(groundtruths, predictions):
        if len(gt.rels) == 0:
            continue
        pred_labels = pred.labels
        pred_dets = pred.masks if use_masks else pred.boxes
        if mode == "predcls":
            pred_labels = gt.labels
            pred_dets = gt.masks if use_masks else gt.boxes
        if pred.rel_pair_idxes.shape[0] == 0:
            for k in TOPK:
                acc.recall[k].append(0.0)
            continue

        gt_dets = gt.masks if use_masks else gt.boxes
        gt_triplets, gt_det_tr = _triplets(gt.rels, gt.labels, gt_dets)

        pred_rels = np.column_stack(
            (pred.rel_pair_idxes, 1 + pred.rel_dists[:, 1:].argmax(1))
        )
        pred_triplets, pred_det_tr = _triplets(pred_rels, pred_labels, pred_dets)

        pred_to_gt = _compute_pred_matches(
            gt_triplets,
            pred_triplets,
            gt_det_tr,
            pred_det_tr,
            iou_thr,
            use_masks,
            phrdet=False,
            ignore_rel=(mode == "pairdet"),
        )

        rk = _recall_at_k(pred_to_gt, len(gt.rels))
        for k in TOPK:
            acc.recall[k].append(rk[k][0])

        # thing/stuff 4-group breakdown (1-based labels; > num_things = stuff)
        grp_cnt = [0, 0, 0, 0]
        for t in gt_triplets:
            grp_cnt[int(t[0] > num_things) * 2 + int(t[2] > num_things)] += 1
        for k in TOPK:
            hit = [0, 0, 0, 0]
            for gi in rk[k][1]:
                t = gt_triplets[int(gi)]
                hit[int(t[0] > num_things) * 2 + int(t[2] > num_things)] += 1
            for j in range(4):
                if grp_cnt[j] > 0:
                    acc.group_recall[j][k].append(hit[j] / grp_cnt[j])

        # mean recall per predicate
        for k in TOPK:
            cnt = np.zeros(num_predicates + 1)
            hit = np.zeros(num_predicates + 1)
            for r in range(len(gt.rels)):
                cnt[int(gt.rels[r, 2])] += 1
                cnt[0] += 1
            for gi in rk[k][1]:
                hit[int(gt.rels[int(gi), 2])] += 1
                hit[0] += 1
            for n in range(num_predicates + 1):
                if cnt[n] > 0:
                    acc.mean_recall_collect[k][n].append(float(hit[n] / cnt[n]))

        if mode == "sgdet":
            phr_to_gt = _compute_pred_matches(
                gt_triplets,
                pred_triplets,
                gt_det_tr,
                pred_det_tr,
                iou_thr,
                use_masks,
                phrdet=True,
            )
            prk = _recall_at_k(phr_to_gt, len(gt.rels))
            for k in TOPK:
                acc.phr_recall[k].append(prk[k][0])

    out = {}
    for k in TOPK:
        out[f"{mode}_recall_R@{k}"] = float(np.mean(acc.recall[k])) if acc.recall[k] else 0.0
    for k in TOPK:
        mr = 0.0
        for n in range(1, num_predicates + 1):
            vals = acc.mean_recall_collect[k][n]
            mr += float(np.mean(vals)) if vals else 0.0
        out[f"{mode}_mean_recall_mR@{k}"] = mr / num_predicates
    for j, name in enumerate(["tt", "ts", "st", "ss"]):
        for k in TOPK:
            vals = acc.group_recall[j][k]
            out[f"{mode}_group_{name}_R@{k}"] = float(np.mean(vals)) if vals else 0.0
    if mode == "sgdet":
        for k in TOPK:
            out[f"phrdet_recall_R@{k}"] = (
                float(np.mean(acc.phr_recall[k])) if acc.phr_recall[k] else 0.0
            )
    return out


def sg_pair_accuracy(
    groundtruths: list[SGGroundTruth],
    predictions: list[SGPrediction],
    num_things: int = 80,
    iou_thr: float = 0.5,
    detection_method: str = "pan_seg",
) -> dict:
    """SGPairAccuracy (ref: sgg_metrics.py:537-667): recall restricted to
    predictions whose (sub, obj) pair indices appear among the GT pairs.
    Only meaningful for predcls/sgcls (predictions index GT objects)."""
    use_masks = detection_method == "pan_seg"
    hits = {k: [] for k in TOPK}
    counts = {k: [] for k in TOPK}
    for gt, pred in zip(groundtruths, predictions):
        if len(gt.rels) == 0:
            continue
        gt_dets = gt.masks if use_masks else gt.boxes
        gt_triplets, gt_det_tr = _triplets(gt.rels, gt.labels, gt_dets)
        pred_rels = np.column_stack(
            (pred.rel_pair_idxes, 1 + pred.rel_dists[:, 1:].argmax(1))
        )
        # predcls semantics: predictions ground in GT objects
        pred_triplets, pred_det_tr = _triplets(pred_rels, gt.labels, gt_dets)
        pred_to_gt = _compute_pred_matches(
            gt_triplets, pred_triplets, gt_det_tr, pred_det_tr, iou_thr, use_masks
        )
        gt_pair_idx = gt.rels[:, 0] * 10000 + gt.rels[:, 1]
        pred_pair_idx = (
            pred.rel_pair_idxes[:, 0] * 10000 + pred.rel_pair_idxes[:, 1]
        )
        in_gt = np.isin(pred_pair_idx, gt_pair_idx)
        restricted = [p for p, f in zip(pred_to_gt, in_gt) if f]
        for k in TOPK:
            match = (
                reduce(np.union1d, restricted[:k]) if restricted else np.array([])
            )
            hits[k].append(float(len(match)))
            counts[k].append(float(len(gt.rels)))
    out = {}
    for k in TOPK:
        h = np.asarray(hits[k])
        c = np.asarray(counts[k])
        out[f"pair_accuracy_A@{k}"] = (
            float(np.mean(h / np.maximum(c, 1))) if len(h) else 0.0
        )
    return out


def sg_object_iou(
    groundtruths: list[SGGroundTruth],
    predictions: list[SGPrediction],
    iou_thr: float = 0.5,
    detection_method: str = "pan_seg",
) -> dict:
    """SGObjectIOU (ref: sgg_metrics.py:942-1086): for each GT triplet whose
    classes match a prediction, record the best subject/object IoU; report
    the mean and the fraction above the threshold."""
    use_masks = detection_method == "pan_seg"
    sub_ious, obj_ious = [], []
    for gt, pred in zip(groundtruths, predictions):
        if len(gt.rels) == 0 or pred.rel_pair_idxes.shape[0] == 0:
            continue
        gt_dets = gt.masks if use_masks else gt.boxes
        pred_dets = pred.masks if use_masks else pred.boxes
        gt_triplets, gt_det_tr = _triplets(gt.rels, gt.labels, gt_dets)
        pred_rels = np.column_stack(
            (pred.rel_pair_idxes, 1 + pred.rel_dists[:, 1:].argmax(1))
        )
        pred_triplets, pred_det_tr = _triplets(pred_rels, pred.labels, pred_dets)
        keeps = intersect_2d(gt_triplets, pred_triplets)
        iou_fn = _mask_iou_matrix if use_masks else _box_iou_matrix
        for gi in np.where(keeps.any(1))[0]:
            cand = np.where(keeps[gi])[0]
            s = iou_fn(gt_det_tr[gi][0][None], pred_det_tr[cand][:, 0])[0]
            o = iou_fn(gt_det_tr[gi][1][None], pred_det_tr[cand][:, 1])[0]
            sub_ious.append(float(s.max()))
            obj_ious.append(float(o.max()))
    all_ious = sub_ious + obj_ious
    return {
        "object_mean_iou": float(np.mean(all_ious)) if all_ious else 0.0,
        "object_iou_recall": (
            float(np.mean(np.asarray(all_ious) > iou_thr)) if all_ious else 0.0
        ),
    }


def sgg_evaluate_nogc(
    groundtruths: list[SGGroundTruth],
    predictions: list[SGPrediction],
    mode: str = "sgdet",
    num_predicates: int = 50,
    iou_thr: float = 0.5,
    nogc_thres_num: int = 100,
) -> dict:
    """No-graph-constraint recall for bbox-mode datasets (VG/OIV6).

    Ref: sgg_metrics.py:254-343 — each pair contributes its top
    ``nogc_thres_num`` predicates scored by obj_score_prod x rel_prob; the
    flattened triplets are ranked by that score and the top 100 evaluated.
    The reference computes this only for detection_method='bbox'.
    """
    recalls = {k: [] for k in TOPK}
    mr_collect = {k: [[] for _ in range(num_predicates + 1)] for k in TOPK}
    for gt, pred in zip(groundtruths, predictions):
        if len(gt.rels) == 0 or pred.rel_pair_idxes.shape[0] == 0:
            continue
        obj_scores = (
            pred.obj_scores
            if pred.obj_scores is not None
            else np.ones(len(pred.labels))
        )
        pair_scores = obj_scores[pred.rel_pair_idxes].prod(1)  # (K,)
        overall = pair_scores[:, None] * pred.rel_dists[:, 1:]  # (K, P)
        kk = min(nogc_thres_num, overall.shape[1])
        top_p = np.argsort(-overall, axis=1)[:, :kk]
        flat_scores = np.take_along_axis(overall, top_p, axis=1).reshape(-1)
        pair_idx = np.repeat(np.arange(overall.shape[0]), kk)
        order = np.argsort(-flat_scores)[:100]
        rels = np.column_stack(
            (
                pred.rel_pair_idxes[pair_idx[order]],
                top_p.reshape(-1)[order] + 1,
            )
        )
        gt_triplets, gt_det_tr = _triplets(gt.rels, gt.labels, gt.boxes)
        pred_triplets, pred_det_tr = _triplets(rels, pred.labels, pred.boxes)
        pred_to_gt = _compute_pred_matches(
            gt_triplets, pred_triplets, gt_det_tr, pred_det_tr, iou_thr,
            use_masks=False,
        )
        rk = _recall_at_k(pred_to_gt, len(gt.rels))
        for k in TOPK:
            recalls[k].append(rk[k][0])
            cnt = np.zeros(num_predicates + 1)
            hit = np.zeros(num_predicates + 1)
            for r in range(len(gt.rels)):
                cnt[int(gt.rels[r, 2])] += 1
            for gi in rk[k][1]:
                hit[int(gt.rels[int(gi), 2])] += 1
            for n in range(1, num_predicates + 1):
                if cnt[n] > 0:
                    mr_collect[k][n].append(float(hit[n] / cnt[n]))
    out = {}
    for k in TOPK:
        out[f"nogc_{mode}_recall_R@{k}"] = (
            float(np.mean(recalls[k])) if recalls[k] else 0.0
        )
        mr = 0.0
        for n in range(1, num_predicates + 1):
            vals = mr_collect[k][n]
            mr += float(np.mean(vals)) if vals else 0.0
        out[f"nogc_{mode}_mean_recall_mR@{k}"] = mr / num_predicates
    return out
