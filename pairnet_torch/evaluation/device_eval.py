"""On-device scene-graph recall evaluation (sgdet), in PyTorch.

Counterpart of ``pairnet_tpu/evaluation/device_eval.py``:
:func:`device_eval_single` scores one image where its tensors lie (mask IoUs
as f32 products of the flattened 0/1 masks, which are exact below 2^24
pixels; class-equality of the triplets; graph-constraint matching; top-K
recall), and :class:`SgdetAccumulator` aggregates the per-image results on
the host into the numpy oracle's sgdet metric dict, summing its (sum,
count) bucket statistics over the ranks of a sharded run. The oracle is
``evaluation/sgg_eval.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from pairnet_torch.parallel.mesh import all_reduce_arrays


def _topk_any(m, topks, K):
    return torch.stack([m[:, : min(k, K)].any(dim=1) for k in topks])


def device_eval_single(
    gt_labels,  # (G,) 1-based; 0 = padding
    gt_rels,  # (R, 3) [sub, obj, predicate_1based]; predicate 0 = padding
    gt_masks,  # (G, H, W) bool/f32
    pred_labels,  # (M,) 1-based
    pred_pairs,  # (K, 2) indices into pred arrays, RANKED
    pred_rel_dists,  # (K, P+1)
    pred_masks,  # (M, H, W) bool/f32
    iou_thr: float = 0.5,
    topks: tuple = (20, 50, 100),
    phrdet: bool = False,
):
    """Returns (matched@k (len(topks), R) bool, rel_valid (R,)), with the
    phrdet matches@k (the union of sub and obj must reach ``iou_thr``)
    between them when ``phrdet``."""
    G = gt_labels.shape[0]
    K = pred_pairs.shape[0]
    gt_labels, gt_rels = gt_labels.long(), gt_rels.long()
    pred_labels, pred_pairs = pred_labels.long(), pred_pairs.long()

    rel_valid = gt_rels[:, 2] > 0
    sub_gt = gt_rels[:, 0].clamp(0, G - 1)
    obj_gt = gt_rels[:, 1].clamp(0, G - 1)
    gt_trip = torch.stack([gt_labels[sub_gt], gt_rels[:, 2], gt_labels[obj_gt]], -1)  # (R, 3)

    pred_predicate = pred_rel_dists[:, 1:].argmax(-1) + 1
    pred_trip = torch.stack(
        [pred_labels[pred_pairs[:, 0]], pred_predicate, pred_labels[pred_pairs[:, 1]]], -1
    )  # (K, 3)
    cls_match = (gt_trip[:, None, :] == pred_trip[None, :, :]).all(-1)  # (R, K)

    gm = gt_masks.reshape(G, -1).float()
    pm = pred_masks.reshape(pred_masks.shape[0], -1).float()
    inter = gm @ pm.T
    union = gm.sum(-1)[:, None] + pm.sum(-1)[None, :] - inter
    iou = inter / union.clamp_min(1e-9)  # (G, M)

    sub_iou = iou[sub_gt][:, pred_pairs[:, 0]]  # (R, K)
    obj_iou = iou[obj_gt][:, pred_pairs[:, 1]]
    match = cls_match & (sub_iou >= iou_thr) & (obj_iou >= iou_thr) & rel_valid[:, None]
    if not phrdet:
        return _topk_any(match, topks, K), rel_valid

    gu = torch.maximum(gm[sub_gt], gm[obj_gt])  # (R, HW) union masks
    pu = torch.maximum(pm[pred_pairs[:, 0]], pm[pred_pairs[:, 1]])  # (K, HW)
    inter_u = gu @ pu.T
    union_u = gu.sum(-1)[:, None] + pu.sum(-1)[None, :] - inter_u
    iou_u = inter_u / union_u.clamp_min(1e-9)  # (R, K)
    match_phr = cls_match & (iou_u >= iou_thr) & rel_valid[:, None]
    return _topk_any(match, topks, K), _topk_any(match_phr, topks, K), rel_valid


def device_eval_twostage_single(gt_labels, gt_rels, gt_masks, pred_labels, pred_pairs,
                                pred_rel_dists, pred_masks, iou_thr: float = 0.5,
                                topks: tuple = (20, 50, 100)):
    """The device twins of the two-stage scoring extras, for predictions
    grounded in the GT regions (predcls / sgcls: ``pred_masks`` is the GT
    mask set). Returns ``(matched@k, matched_pair@k, rel_valid, best_sub_iou,
    best_obj_iou, has_cand)``: the graph-constraint recall matching; the
    SGPairAccuracy matching (predictions whose (sub, obj) index pair is a GT
    pair, GT-grounded triplets, top-k over that restricted ranking); and
    SGObjectIOU's best subject / object IoU over the class-matching
    candidates of each GT relation."""
    G = gt_labels.shape[0]
    K = pred_pairs.shape[0]
    gt_labels, gt_rels = gt_labels.long(), gt_rels.long()
    pred_labels, pred_pairs = pred_labels.long(), pred_pairs.long()

    rel_valid = gt_rels[:, 2] > 0
    sub_gt = gt_rels[:, 0].clamp(0, G - 1)
    obj_gt = gt_rels[:, 1].clamp(0, G - 1)
    gt_trip = torch.stack([gt_labels[sub_gt], gt_rels[:, 2], gt_labels[obj_gt]], -1)

    pred_predicate = pred_rel_dists[:, 1:].argmax(-1) + 1
    psub = pred_pairs[:, 0].clamp(0, pred_labels.shape[0] - 1)
    pobj = pred_pairs[:, 1].clamp(0, pred_labels.shape[0] - 1)
    pred_trip = torch.stack([pred_labels[psub], pred_predicate, pred_labels[pobj]], -1)
    cls_match = (gt_trip[:, None, :] == pred_trip[None, :, :]).all(-1)

    gm = gt_masks.reshape(G, -1).float()
    pm = pred_masks.reshape(pred_masks.shape[0], -1).float()
    inter = gm @ pm.T
    union = gm.sum(-1)[:, None] + pm.sum(-1)[None, :] - inter
    iou = inter / union.clamp_min(1e-9)  # (G, M)
    sub_iou = iou[sub_gt][:, psub]  # (R, K)
    obj_iou = iou[obj_gt][:, pobj]
    iou_ok = (sub_iou >= iou_thr) & (obj_iou >= iou_thr)
    matched = _topk_any(cls_match & iou_ok & rel_valid[:, None], topks, K)

    # SGPairAccuracy: GT-grounded triplets, ranked among the GT pairs only
    in_gt = ((pred_pairs[:, None, :] == gt_rels[None, :, :2]).all(-1)
             & rel_valid[None, :]).any(1)  # (K,)
    rank = torch.cumsum(in_gt.long(), 0) - 1
    pred_trip_gt = torch.stack([gt_labels[psub], pred_predicate, gt_labels[pobj]], -1)
    pair_match = ((gt_trip[:, None, :] == pred_trip_gt[None, :, :]).all(-1) & iou_ok
                  & rel_valid[:, None] & in_gt[None, :])
    matched_pair = torch.stack([(pair_match & (rank < k)[None, :]).any(1) for k in topks])

    # SGObjectIOU: best IoU over the class-matching candidates
    has_cand = cls_match.any(1) & rel_valid
    best_sub = torch.where(cls_match, sub_iou, -1.0).amax(1)
    best_obj = torch.where(cls_match, obj_iou, -1.0).amax(1)
    return matched, matched_pair, rel_valid, best_sub, best_obj, has_cand


class SgdetAccumulator:
    """Host-side aggregation of per-image match results into the numpy
    oracle's metric dict: R@K, mR@K, thing/stuff 4-group recall and phrdet;
    with ``twostage`` also the pair accuracy and object-IoU keys of the
    two-stage scoring (:meth:`add_twostage`). All inputs are per-image O(R)
    arrays."""

    GROUPS = ("tt", "ts", "st", "ss")

    def __init__(self, num_predicates: int, num_things: int, topks: tuple = (20, 50, 100),
                 twostage: bool = False):
        self.num_predicates = num_predicates
        self.num_things = num_things
        self.topks = topks
        self.twostage = twostage
        self.recalls = {k: [] for k in topks}
        self.phr_recalls = {k: [] for k in topks}
        self.mr_collect = {k: [[] for _ in range(num_predicates + 1)] for k in topks}
        self.group_recall = [{k: [] for k in topks} for _ in range(4)]
        self.pair_acc = {k: [] for k in topks}
        self.oiu = [0.0, 0, 0]  # sum of the best IoUs, their count, the count above iou_thr

    def add_twostage(self, matched_pair, best_sub, best_obj, has_cand, rel_valid,
                     iou_thr: float = 0.5):
        """Accumulate the extras of :func:`device_eval_twostage_single`."""
        rv = np.asarray(torch.as_tensor(rel_valid).cpu())
        if not rv.any():
            return
        n_gt = int(rv.sum())
        matched_pair = np.asarray(torch.as_tensor(matched_pair).cpu())
        for ki, k in enumerate(self.topks):
            self.pair_acc[k].append((matched_pair[ki] & rv).sum() / n_gt)
        hc = np.asarray(torch.as_tensor(has_cand).cpu()) & rv
        ious = np.concatenate([np.asarray(torch.as_tensor(best_sub).cpu())[hc],
                               np.asarray(torch.as_tensor(best_obj).cpu())[hc]])
        self.oiu[0] += float(ious.sum())
        self.oiu[1] += int(ious.size)
        self.oiu[2] += int((ious > iou_thr).sum())

    def add(self, matched, matched_phr, rel_valid, gt_rels, gt_labels):
        """matched/matched_phr (len(topks), R) bool; gt_rels (R, 3) with
        0-padded predicates; gt_labels (G,) 1-based. Tensors or arrays."""
        matched = np.asarray(torch.as_tensor(matched).cpu())
        rv = np.asarray(torch.as_tensor(rel_valid).cpu())
        if not rv.any():
            return  # the oracle skips relation-less images entirely
        n_gt = int(rv.sum())
        gt_rels = np.asarray(gt_rels)
        gt_labels = np.asarray(gt_labels)
        predicates = gt_rels[:, 2]
        nt = self.num_things
        sub_lab = gt_labels[np.clip(gt_rels[:, 0], 0, len(gt_labels) - 1)]
        obj_lab = gt_labels[np.clip(gt_rels[:, 1], 0, len(gt_labels) - 1)]
        grp = (sub_lab > nt).astype(int) * 2 + (obj_lab > nt).astype(int)
        phr = None if matched_phr is None else np.asarray(torch.as_tensor(matched_phr).cpu())
        for ki, k in enumerate(self.topks):
            hits = matched[ki] & rv
            self.recalls[k].append(hits.sum() / n_gt)
            for p in range(1, self.num_predicates + 1):
                sel = rv & (predicates == p)
                if sel.any():
                    self.mr_collect[k][p].append(matched[ki][sel].mean())
            for j in range(4):
                sel = rv & (grp == j)
                cnt = int(sel.sum())
                if cnt > 0:
                    self.group_recall[j][k].append(hits[sel].sum() / cnt)
            if phr is not None:
                self.phr_recalls[k].append((phr[ki] & rv).sum() / n_gt)

    def bucket_stats(self) -> dict:
        """Fixed-shape (sum, count) arrays per metric bucket (JAX's
        ``_bucket_stats``): the exact sufficient statistics of every mean
        reported, so what crosses ranks."""
        T, P = len(self.topks), self.num_predicates
        s = {"rec": np.zeros((T, 2)), "phr": np.zeros((T, 2)), "mr": np.zeros((T, P + 1, 2)),
             "grp": np.zeros((4, T, 2)), "pair": np.zeros((T, 2)), "oiu": np.array(self.oiu, float)}
        for ki, k in enumerate(self.topks):
            s["rec"][ki] = (np.sum(self.recalls[k]), len(self.recalls[k]))
            s["pair"][ki] = (np.sum(self.pair_acc[k]), len(self.pair_acc[k]))
            s["phr"][ki] = (np.sum(self.phr_recalls[k]), len(self.phr_recalls[k]))
            for p in range(1, P + 1):
                v = self.mr_collect[k][p]
                s["mr"][ki, p] = (np.sum(v), len(v))
            for j in range(4):
                v = self.group_recall[j][k]
                s["grp"][j, ki] = (np.sum(v), len(v))
        return s

    def summarize(self, mode: str = "sgdet") -> dict:
        """The metric dict: means of the per-image scalars (0 for an empty
        bucket). In a sharded run (a process group) each rank holds its
        images' buckets and they are summed over the ranks first, which
        merges the means exactly (the counterpart of JAX's
        ``summarize(gather=True)``)."""
        return self.metrics(all_reduce_arrays(self.bucket_stats()), mode)

    def metrics(self, s: dict, mode: str = "sgdet") -> dict:
        """The metric dict of bucket statistics ``s``."""

        def mean(pair):
            return float(pair[0] / pair[1]) if pair[1] else 0.0

        out = {}
        for ki, k in enumerate(self.topks):
            out[f"{mode}_recall_R@{k}"] = mean(s["rec"][ki])
        for ki, k in enumerate(self.topks):
            mr = sum(mean(s["mr"][ki, p]) for p in range(1, self.num_predicates + 1))
            out[f"{mode}_mean_recall_mR@{k}"] = mr / self.num_predicates
        for j, name in enumerate(self.GROUPS):
            for ki, k in enumerate(self.topks):
                out[f"{mode}_group_{name}_R@{k}"] = mean(s["grp"][j, ki])
        if s["phr"][:, 1].any():
            for ki, k in enumerate(self.topks):
                out[f"phrdet_recall_R@{k}"] = mean(s["phr"][ki])
        if self.twostage:
            for ki, k in enumerate(self.topks):
                out[f"pair_accuracy_A@{k}"] = mean(s["pair"][ki])
            n = s["oiu"][1]
            out["object_mean_iou"] = float(s["oiu"][0] / n) if n else 0.0
            out["object_iou_recall"] = float(s["oiu"][2] / n) if n else 0.0
        return out
