"""Inference-to-evaluation glue: run the model over a split and score it.

Counterpart of ``pairnet_tpu/evaluation/runner.py``:

* :func:`evaluate_model_device`: the sgdet path with all of the scoring on
  the model's device: forward -> ``pairnet_postprocess`` (panoptic fusion,
  triplet ranking) -> :func:`canvas_resize` of the masks to the original
  resolution -> :func:`~pairnet_torch.evaluation.device_eval.device_eval_single`;
* :func:`evaluate_model`: the numpy oracle (``sgg_eval.sgg_evaluate``) on
  host predictions, mask upsampling as PIL's mode-F bilinear resize
  (reproduced in numpy);
* :func:`evaluate_model_with_postprocess`: the same oracle through a
  head's own post-processing (``train/dispatch.get_postprocess_fn``), the
  scoring path of every head but Pair-Net's; a box head's triplets
  (``BoxTripletPrediction``) score with ``detection_method="bbox"``;
* :func:`evaluate_pq`: Panoptic Quality of the fused panoptic maps.

``apply_fn(images) -> output dict`` takes the loader's numpy image batch and
returns the head's tensors. Padded batch entries (``batch_valid``) are
skipped.

Sharded scoring (a process group, ``torchrun``): each rank scores image i of
the split when i mod world is its rank (disjoint, complete, uneven shards
allowed), then the sgdet bucket statistics and PQ's per-class sums are
summed over the ranks, which merges every metric exactly; the numpy oracle
gathers the predictions to rank 0 in dataset order, where they are scored
and saved. Every rank returns the same metrics.
"""

from __future__ import annotations

import functools
import math
import pickle

import numpy as np
import torch
import torch.distributed as dist

from pairnet_torch.data.pipeline import Loader, PipelineConfig
from pairnet_torch.data.sg import shard
from pairnet_torch.evaluation.sgg_eval import SGGroundTruth, SGPrediction, sgg_evaluate
from pairnet_torch.parallel.mesh import all_reduce_arrays, is_distributed, world_info


@functools.lru_cache(maxsize=64)
def _pil_bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's bilinear resampling taps of one axis (Pillow ``Resample.c``,
    ``precompute_coeffs``): (out_size, k) source indices and float64
    weights, zero past each output's last tap."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int() truncates, as C's cast
        n = min(int(center + support + 0.5), in_size) - xmin
        ss = 1.0 / filterscale
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(n)]
        total = 0.0
        for v in w:
            total += v
        idx[xx, :n] = np.arange(xmin, xmin + n)
        weights[xx, :n] = [v / total for v in w] if total != 0.0 else w
    return idx, weights


def _resample_axis(m: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One pass of PIL's float resampling along ``axis`` (1 or 2) of (n, h,
    w) float32 maps, on their device: the taps summed in order in float64,
    the result rounded to float32. Each product and each sum is one
    correctly rounded float64 operation (separate kernels, no fused
    multiply-add), so every device gives the same bits."""
    idx, w = _pil_bilinear_taps(m.shape[axis], out_size)
    acc = None
    for t in range(idx.shape[1]):
        if not w[:, t].any():  # adding zeros changes no sum: PIL's trailing empty taps
            continue
        wt = torch.from_numpy(w[:, t]).to(m.device).reshape((-1, 1) if axis == 1 else (1, -1))
        term = m.index_select(axis, torch.from_numpy(idx[:, t]).to(m.device)).double() * wt
        acc = term if acc is None else acc.add_(term)
    return acc.float()


RESIZE_CHUNK = 16  # maps resized at a time: bounds the float64 temporaries


def _resize_logits(mask_logits, out_hw: tuple[int, int]) -> np.ndarray:
    """(N, h, w) float -> (N, H, W) numpy bilinear, bit for bit PIL's mode-F
    ``resize((W, H), BILINEAR)`` (the oracle's semantics), without PIL: a
    horizontal pass, then a vertical one, each rounded to float32.
    ``mask_logits`` is a numpy array (resized on the host) or a tensor
    (resized on its device)."""
    H, W = out_hw
    m = (mask_logits.float() if torch.is_tensor(mask_logits)
         else torch.from_numpy(np.ascontiguousarray(mask_logits, np.float32)))
    out = torch.empty((m.shape[0], H, W), dtype=torch.float32, device=m.device)
    for i in range(0, m.shape[0], RESIZE_CHUNK):
        chunk = m[i:i + RESIZE_CHUNK]
        out[i:i + RESIZE_CHUNK] = _resample_axis(_resample_axis(chunk, 2, W), 1, H)
    return out.cpu().numpy()


def _host(out: dict) -> dict:
    """The head's tensors as numpy arrays (without the query features)."""
    return {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in out.items() if k != "queries"}


def predictions_to_protocol(out: dict, batch: dict, mask_stride: int,
                            num_things: int = 80) -> list[SGPrediction]:
    """Raw batched head outputs (numpy) -> per-image SGPredictions at the
    original resolution."""
    preds = []
    B = out["rel"].shape[0]
    for b in range(B):
        if "batch_valid" in batch and not batch["batch_valid"][b]:
            continue
        rh, rw = (int(x) for x in batch["image_shape"][b])
        oh, ow = (int(x) for x in batch["orig_shape"][b])
        K, R = out["rel"][b].shape

        def softmax(x):
            e = np.exp(x - x.max(-1, keepdims=True))
            return e / e.sum(-1, keepdims=True)

        s_prob = softmax(np.asarray(out["sub"][b], np.float32))[:, :-1]
        o_prob = softmax(np.asarray(out["obj"][b], np.float32))[:, :-1]
        s_labels = s_prob.argmax(-1) + 1
        o_labels = o_prob.argmax(-1) + 1
        r_dists = softmax(np.asarray(out["rel"][b], np.float32))
        r_dists = np.concatenate([np.zeros((K, 1), np.float32), r_dists], -1)

        # crop the valid region of the stride-s logit map, upsample to orig
        ch = max(1, int(np.ceil(rh / mask_stride)))
        cw = max(1, int(np.ceil(rw / mask_stride)))
        s_seg = np.asarray(out["sub_seg"][b], np.float32)[:, :ch, :cw]
        o_seg = np.asarray(out["obj_seg"][b], np.float32)[:, :ch, :cw]
        s_masks = _resize_logits(s_seg, (oh, ow)) > 0.0  # sigmoid(x)>0.5 <=> x>0
        o_masks = _resize_logits(o_seg, (oh, ow)) > 0.0

        preds.append(SGPrediction(
            labels=np.concatenate([s_labels, o_labels]).astype(np.int64),
            rel_pair_idxes=np.stack([np.arange(K), np.arange(K) + K], axis=1),
            rel_dists=r_dists,
            masks=np.concatenate([s_masks, o_masks]),
        ))
    return preds


def save_predictions(preds: list[SGPrediction], path: str) -> None:
    """Pickle per-image predictions (masks bit-packed)."""
    rows = []
    for p in preds:
        row = {
            "labels": p.labels,
            "rel_pair_idxes": p.rel_pair_idxes,
            "rel_dists": p.rel_dists.astype(np.float16),
            "boxes": p.boxes,
        }
        if p.masks is not None:
            row["mask_shape"] = p.masks.shape
            row["masks_packed"] = np.packbits(p.masks.astype(bool), axis=None)
        rows.append(row)
    with open(path, "wb") as f:
        pickle.dump(rows, f)


def load_predictions(path: str) -> list[SGPrediction]:
    with open(path, "rb") as f:
        rows = pickle.load(f)
    preds = []
    for row in rows:
        masks = None
        if "masks_packed" in row:
            shape = row["mask_shape"]
            masks = np.unpackbits(row["masks_packed"], count=int(np.prod(shape))).astype(bool)
            masks = masks.reshape(shape)
        preds.append(SGPrediction(
            labels=row["labels"],
            rel_pair_idxes=row["rel_pair_idxes"],
            rel_dists=row["rel_dists"].astype(np.float32),
            masks=masks,
            boxes=row.get("boxes"),
        ))
    return preds


def load_groundtruths(dataset) -> list[SGGroundTruth]:
    """GT in the eval protocol: 1-based labels, full-resolution masks."""
    gts = []
    for i in range(len(dataset)):
        masks, _, _ = dataset.load_masks(i)
        ann = dataset.get_ann_info(i)
        gts.append(SGGroundTruth(
            labels=np.asarray([m["category"] for m in ann["masks"]], np.int64) + 1,
            rels=np.asarray(ann["rels"], np.int64),
            masks=masks,
            boxes=ann["bboxes"],
        ))
    return gts


def _gather_in_order(items: list) -> list | None:
    """Every rank's items (rank r holds images r, r + world, ...) on rank 0
    in dataset order; None on the other ranks. The items themselves with
    no process group."""
    rank, world = world_info()
    if not is_distributed():
        return items
    parts = [None] * world if rank == 0 else None
    dist.gather_object(items, parts, dst=0)
    if rank != 0:
        return None
    return [parts[i % world][i // world] for i in range(sum(len(p) for p in parts))]


def evaluate_model(apply_fn, dataset, pipe_cfg: PipelineConfig, batch_size: int = 1,
                   mode: str = "sgdet", num_predicates: int = 56, num_things: int = 80,
                   iou_thr: float = 0.5, results_out: str | None = None) -> dict:
    """The numpy oracle: inference over ``dataset``, predictions on the
    host, ``sgg_evaluate``. ``results_out`` pickles the predictions. Sharded:
    rank 0 gathers the predictions, scores and writes them, and hands every
    rank the metrics."""
    if mode == "predcls":
        raise ValueError("predcls is only defined for two-stage heads (not ported yet)")
    rank, world = world_info()
    preds: list[SGPrediction] = []
    for batch in Loader(shard(dataset, rank, world), pipe_cfg, batch_size):
        out = _host(apply_fn(batch["image"]))
        preds.extend(predictions_to_protocol(out, batch, pipe_cfg.mask_stride, num_things))
    preds = _gather_in_order(preds)
    metrics = None
    if rank == 0:
        if results_out:
            save_predictions(preds, results_out)
        gts = load_groundtruths(dataset)
        assert len(gts) == len(preds), (len(gts), len(preds))
        metrics = sgg_evaluate(gts, preds, mode=mode, num_predicates=num_predicates,
                               iou_thr=iou_thr, detection_method="pan_seg",
                               num_things=num_things)
    if is_distributed():
        box = [metrics]
        dist.broadcast_object_list(box, src=0)
        metrics = box[0]
    return metrics


def triplets_to_protocol(pred, batch: dict, b: int, mask_stride: int) -> SGPrediction:
    """A TripletPrediction of image ``b`` of ``batch`` in the eval protocol
    at the original resolution: its boolean masks cropped to the valid
    region, resized as PIL's mode-F bilinear on their device, > 0.5."""
    rh, rw = (int(x) for x in batch["image_shape"][b])
    oh, ow = (int(x) for x in batch["orig_shape"][b])
    ch = max(1, int(np.ceil(rh / mask_stride)))
    cw = max(1, int(np.ceil(rw / mask_stride)))
    m = pred.masks[:, :ch, :cw].float()
    return SGPrediction(
        labels=pred.labels.cpu().numpy().astype(np.int64),
        rel_pair_idxes=pred.rel_pairs.cpu().numpy().astype(np.int64),
        rel_dists=pred.r_dists.float().cpu().numpy(),
        masks=_resize_logits(m, (oh, ow)) > 0.5,
    )


def box_triplets_to_protocol(pred, batch: dict, b: int) -> SGPrediction:
    """A BoxTripletPrediction of image ``b`` (normalized xyxy on the padded
    canvas) in the eval protocol: pixel boxes at the original resolution.
    The resized image fills [0, rh) x [0, rw) of the canvas, so the boxes
    scale by the canvas size, then by original / resized."""
    rh, rw = (float(x) for x in batch["image_shape"][b])
    oh, ow = (float(x) for x in batch["orig_shape"][b])
    ph, pw = (float(s) for s in batch["image"].shape[1:3])
    boxes = pred.boxes.float().cpu().numpy()
    sx = pw * ow / max(rw, 1.0)
    sy = ph * oh / max(rh, 1.0)
    return SGPrediction(
        labels=pred.labels.cpu().numpy().astype(np.int64),
        rel_pair_idxes=pred.rel_pairs.cpu().numpy().astype(np.int64),
        rel_dists=pred.r_dists.float().cpu().numpy(),
        masks=None,
        boxes=boxes * np.array([sx, sy, sx, sy], np.float32),
    )


def evaluate_model_with_postprocess(apply_fn, postprocess_fn, dataset, pipe_cfg: PipelineConfig,
                                    batch_size: int = 1, mode: str = "sgdet",
                                    num_predicates: int = 56, num_things: int = 80,
                                    iou_thr: float = 0.5, results_out: str | None = None) -> dict:
    """The numpy oracle through a head's post-processing
    (``postprocess_fn(outputs, b, num_things=...) -> TripletPrediction``),
    on the device; the predictions come to the host at the original
    resolution. ``results_out`` pickles them. Sharded as
    :func:`evaluate_model`. Triplets with ``boxes`` (a box head's) score
    with ``detection_method="bbox"``."""
    if mode == "predcls":
        # predcls puts the GT detections in place of the prediction's, which
        # only lines up for a head conditioned on GT boxes (two-stage); a
        # one-stage head's pairs index its own queries
        raise ValueError("predcls is only defined for two-stage heads (not ported yet)")
    rank, world = world_info()
    preds: list[SGPrediction] = []
    for batch in Loader(shard(dataset, rank, world), pipe_cfg, batch_size):
        out = {k: v for k, v in apply_fn(batch["image"]).items() if k != "queries"}
        for b in range(batch["image"].shape[0]):
            if not batch["batch_valid"][b]:
                continue
            trip = postprocess_fn(out, b, num_things=num_things)
            if hasattr(trip, "boxes"):
                preds.append(box_triplets_to_protocol(trip, batch, b))
            else:
                preds.append(triplets_to_protocol(trip, batch, b, pipe_cfg.mask_stride))
    preds = _gather_in_order(preds)
    metrics = None
    if rank == 0:
        if results_out:
            save_predictions(preds, results_out)
        gts = load_groundtruths(dataset)
        assert len(gts) == len(preds), (len(gts), len(preds))
        use_boxes = any(p.boxes is not None for p in preds)
        metrics = sgg_evaluate(gts, preds, mode=mode, num_predicates=num_predicates,
                               iou_thr=iou_thr,
                               detection_method="bbox" if use_boxes else "pan_seg",
                               num_things=num_things)
    if is_distributed():
        box = [metrics]
        dist.broadcast_object_list(box, src=0)
        metrics = box[0]
    return metrics


def canvas_resize(masks, ch: int, cw: int, oh: int, ow: int, canvas_hw: tuple[int, int]):
    """Crop and bilinear-resize into a fixed canvas, on the masks' device.

    masks (N, H4, W4); the valid content occupies [:ch, :cw]; it is
    bilinear-resized (align_corners=False, edge clamp) to (oh, ow) and
    placed at the canvas origin, zeros elsewhere. f32 throughout, the ratio
    in_len / out_len an f32 divide, as in the JAX package.
    """
    CH, CW = canvas_hw
    dev = masks.device

    def axis(out_static, out_len, in_len):
        o = torch.arange(out_static, dtype=torch.float32, device=dev)
        ratio = (torch.tensor(in_len, dtype=torch.float32, device=dev)
                 / torch.tensor(out_len, dtype=torch.float32, device=dev))
        src = (o + 0.5) * ratio - 0.5
        i0 = torch.floor(src)
        f = (src - i0).clamp(0.0, 1.0)
        i0 = i0.long().clamp(0, in_len - 1)
        i1 = (i0 + 1).clamp(0, in_len - 1)
        return i0, i1, f, (o < out_len).float()

    y0, y1, fy, ym = axis(CH, oh, ch)
    x0, x1, fx, xm = axis(CW, ow, cw)
    m = masks.float()
    rows = m[:, y0, :] * (1.0 - fy)[None, :, None] + m[:, y1, :] * fy[None, :, None]
    out = rows[:, :, x0] * (1.0 - fx)[None, None, :] + rows[:, :, x1] * fx[None, None, :]
    return out * ym[None, :, None] * xm[None, None, :]


def evaluate_model_device(apply_fn, dataset, pipe_cfg: PipelineConfig, batch_size: int = 1,
                          mode: str = "sgdet", num_predicates: int = 56, num_things: int = 80,
                          iou_thr: float = 0.5, topks: tuple = (20, 50, 100),
                          device=None) -> dict:
    """sgdet with the whole scored path on ``device`` (default: where the
    model's outputs lie): forward, post-processing, canvas mask upsampling,
    recall matching. Returns the oracle's sgdet key set: R@K, mR@K,
    thing/stuff 4-group recall, phrdet. Sharded when there is a process
    group."""
    from pairnet_torch.evaluation.device_eval import SgdetAccumulator, device_eval_single
    from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess

    if mode != "sgdet":
        raise ValueError("the device engine scores sgdet only")
    # fixed canvas: the largest original resolution of the whole split, to 8
    CH = -(-max(d.height for d in dataset.data) // 8) * 8
    CW = -(-max(d.width for d in dataset.data) // 8) * 8
    dataset = shard(dataset, *world_info())
    gts = load_groundtruths(dataset)
    G_max = max(1, max((len(g.labels) for g in gts), default=0))
    R_max = max(1, max((len(g.rels) for g in gts), default=0))

    acc = SgdetAccumulator(num_predicates, num_things, topks)
    img_idx = 0
    for batch in Loader(dataset, pipe_cfg, batch_size):
        out = {k: v for k, v in apply_fn(batch["image"]).items() if k != "queries"}
        dev = out["rel"].device if device is None else torch.device(device)
        for b in range(batch["image"].shape[0]):
            if not batch["batch_valid"][b]:
                continue
            gt = gts[img_idx]
            img_idx += 1
            rh, rw = (int(x) for x in batch["image_shape"][b])
            oh, ow = (int(x) for x in batch["orig_shape"][b])
            ch = max(1, -(-rh // pipe_cfg.mask_stride))
            cw = max(1, -(-rw // pipe_cfg.mask_stride))
            trip = pairnet_postprocess(out, b, num_things=num_things)
            pm = canvas_resize(trip.masks, ch, cw, oh, ow, (CH, CW)) > 0.5

            # GT padded into the canvas, with fixed instance/relation counts
            G = len(gt.labels)
            gmask = np.zeros((G_max, CH, CW), bool)
            gm = np.asarray(gt.masks, bool)
            gmask[:G, : gm.shape[1], : gm.shape[2]] = gm
            glabels = np.zeros((G_max,), np.int64)
            glabels[:G] = gt.labels
            grels = np.zeros((R_max, 3), np.int64)
            grels[: len(gt.rels)] = gt.rels

            matched, matched_phr, rel_valid = device_eval_single(
                torch.from_numpy(glabels).to(dev), torch.from_numpy(grels).to(dev),
                torch.from_numpy(gmask).to(dev), trip.labels, trip.rel_pairs, trip.r_dists,
                pm, iou_thr, topks, phrdet=True,
            )
            del pm  # (2K, CH, CW): the largest tensor of the image
            acc.add(matched, matched_phr, rel_valid, grels, glabels)
    return acc.summarize(mode)


def evaluate_pq(apply_fn, postprocess_fn, dataset, pipe_cfg: PipelineConfig,
                batch_size: int = 1, num_classes: int = 133, num_things: int = 80) -> dict:
    """Panoptic Quality over a split. The fused id map
    (``m_id * INSTANCE_OFFSET + label``) lives on the stride-``mask_stride``
    padded canvas; its valid region is nearest-upsampled to the original
    resolution on the host and matched against the GT segments. Sharded,
    the per-class (IoU, tp, fp, fn) sums are summed over the ranks."""
    from pairnet_torch.evaluation.panoptic_quality import (
        PQStat,
        pan_seg_to_ids,
        pq_stats,
        pq_summarize,
    )

    dataset = shard(dataset, *world_info())
    images = []
    idx = 0
    for batch in Loader(dataset, pipe_cfg, batch_size):
        out = {k: v for k, v in apply_fn(batch["image"]).items() if k != "queries"}
        for b in range(batch["image"].shape[0]):
            if not batch["batch_valid"][b]:
                continue
            trip = postprocess_fn(out, b, num_things=num_things)
            rh, rw = (int(x) for x in batch["image_shape"][b])
            oh, ow = (int(x) for x in batch["orig_shape"][b])
            s = pipe_cfg.mask_stride
            ch = max(1, int(np.ceil(rh / s)))
            cw = max(1, int(np.ceil(rw / s)))
            pan = trip.pan_seg.cpu().numpy()[:ch, :cw]
            yi = np.minimum((np.arange(oh) * ch) // oh, ch - 1)
            xi = np.minimum((np.arange(ow) * cw) // ow, cw - 1)
            pred_ids, pred_map = pan_seg_to_ids(pan[yi][:, xi])
            # ids fused from the no-detection fill (label >= num_classes) are VOID
            pred_map = {i: lab for i, lab in pred_map.items() if lab < num_classes}
            valid = (np.isin(pred_ids, list(pred_map)) if pred_map
                     else np.zeros(pred_ids.shape, bool))
            pred_ids = np.where(valid, pred_ids, -1)
            gt_ids, gt_map = dataset.load_pan_ids(idx)
            images.append((gt_ids, gt_map, pred_ids, pred_map))
            idx += 1
    assert idx == len(dataset), (idx, len(dataset))
    agg = pq_stats(images, num_classes)
    if is_distributed():
        sums = all_reduce_arrays({"pq": [[agg[c].iou, agg[c].tp, agg[c].fp, agg[c].fn]
                                         for c in range(num_classes)]})["pq"]
        agg = {c: PQStat(float(iou), int(tp), int(fp), int(fn))
               for c, (iou, tp, fp, fn) in enumerate(sums)}
    pq = pq_summarize(agg, num_classes, num_things)
    metrics = {}
    for group, vals in pq.items():
        for k in ("PQ", "SQ", "RQ"):
            metrics[f"{group}_{k}"] = round(float(vals[k]), 4)
        metrics[f"{group}_n"] = vals["n"]
    return metrics
