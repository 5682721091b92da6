"""Test-time preprocessing -> fixed-shape host batches (the port's copy of the
test side of ``pairnet_tpu/data/pipeline.py``).

Keep-ratio resize to ``target_size`` (short, long), ImageNet normalization,
padding into one canvas, GT instances padded to ``max_inst``, relations to
``max_rels``, GT masks at ``mask_stride``. The train-time augmentation
(multi-scale, flip, relation-aware crop) is not ported yet; the config
fields that drive it are accepted and unused.

Batch contract (numpy):
  image       (B, H, W, 3) f32 normalized
  gt_labels   (B, G) int32        gt_valid (B, G) bool
  gt_boxes    (B, G, 4) f32       gt_masks (B, G, H/s, W/s) bool
  gt_rels     (B, R, 3) int32 [sub, obj, predicate_1based]
  rel_valid   (B, R) bool
  image_shape (B, 2) int32  (unpadded h, w after resize)
  orig_shape  (B, 2) int32  (original image h, w)
  batch_valid (B,) bool     (False for the padding of a trailing batch)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from pairnet_torch import native

IMAGENET_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


@dataclass
class PipelineConfig:
    target_size: tuple[int, int] = (800, 1333)  # (short, long) keep-ratio cap
    pad_size: tuple[int, int] | None = None  # (H, W) padded canvas; derived if None
    size_divisor: int = 32
    mask_stride: int = 4
    max_inst: int = 64
    max_rels: int = 100
    # train-time augmentation, accepted from the configs and not ported yet
    flip_prob: float = 0.5
    train_scales: tuple[int, ...] = ()
    crop_prob: float = 0.0
    crop_scales: tuple[int, ...] = (400, 500, 600)
    crop_size_range: tuple[int, int] = (384, 600)
    mean: np.ndarray = field(default_factory=lambda: IMAGENET_MEAN)
    std: np.ndarray = field(default_factory=lambda: IMAGENET_STD)

    def padded_hw(self) -> tuple[int, int]:
        if self.pad_size is not None:
            return self.pad_size
        short, long = self.target_size
        d = self.size_divisor
        pad = lambda v: ((v + d - 1) // d) * d  # noqa: E731
        return pad(short), pad(long)


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear uint8 resize by ``scale``: the native library (mmcv/cv2
    semantics, no antialias), else PIL; raises if neither is there."""
    h, w = img.shape[:2]
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    if native.available():
        return native.resize_bilinear(img, nh, nw)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "image resize needs the native library (g++ build of "
            f"pairnet_torch/native/preprocess.cc failed: {native.build_error()}) or PIL "
            "(not installed)") from e
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)


def resize_masks_nearest(masks: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """(N, H, W) bool -> (N, nh, nw) bool via nearest-neighbour index mapping."""
    n, h, w = masks.shape
    nh, nw = out_hw
    if n == 0:
        return np.zeros((0, nh, nw), bool)
    ys = np.minimum((np.arange(nh) + 0.5) * h / nh, h - 1).astype(np.int64)
    xs = np.minimum((np.arange(nw) + 0.5) * w / nw, w - 1).astype(np.int64)
    return masks[:, ys[:, None], xs[None, :]]


def keep_ratio_scale(h: int, w: int, short: int, long: int) -> float:
    """mmdet keep-ratio rescale factor for target (long, short)."""
    return min(long / max(h, w), short / min(h, w))


def preprocess_sample(dataset, idx: int, cfg: PipelineConfig) -> dict:
    """One image -> fixed-shape numpy sample dict (test time)."""
    img = dataset.load_image(idx)
    masks, _, _ = dataset.load_masks(idx)
    ann = dataset.get_ann_info(idx)
    rels = ann["rels"]  # (R, 3) predicate 1-based
    labels = np.asarray([m["category"] for m in ann["masks"]], np.int64)

    short, long = cfg.target_size
    orig_h, orig_w = img.shape[:2]
    img_r = resize_image(img, keep_ratio_scale(orig_h, orig_w, short, long))
    pad_h, pad_w = cfg.padded_hw()
    rh, rw = min(img_r.shape[0], pad_h), min(img_r.shape[1], pad_w)
    if native.available():
        # single-pass fused normalize + pad (C++/OpenMP)
        canvas = native.normalize_pad(np.ascontiguousarray(img_r[:rh, :rw]), cfg.mean,
                                      cfg.std, pad_h, pad_w)
    else:
        canvas = np.zeros((pad_h, pad_w, 3), np.float32)
        canvas[:rh, :rw] = (img_r[:rh, :rw].astype(np.float32) - cfg.mean) / cfg.std

    s = cfg.mask_stride
    mh, mw = pad_h // s, pad_w // s
    # resize masks to the resized-image geometry, then place on the canvas
    m_small = resize_masks_nearest(masks, (max(1, rh // s), max(1, rw // s)))
    G = cfg.max_inst
    gt_masks = np.zeros((G, mh, mw), bool)
    gt_labels = np.zeros((G,), np.int32)
    gt_valid = np.zeros((G,), bool)
    n = min(len(masks), G)
    gt_masks[:n, : m_small.shape[1], : m_small.shape[2]] = m_small[:n]
    gt_labels[:n] = labels[:n]
    gt_valid[:n] = True

    # boxes in resized-image pixels, derived from the (stride-s) masks
    gt_boxes = np.zeros((G, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(gt_masks[i])
        if len(ys):
            gt_boxes[i] = [xs.min() * s, ys.min() * s, (xs.max() + 1) * s, (ys.max() + 1) * s]

    R = cfg.max_rels
    gt_rels = np.zeros((R, 3), np.int32)
    rel_valid = np.zeros((R,), bool)
    # drop relations whose endpoints were truncated away by max_inst
    ok = (rels[:, 0] < n) & (rels[:, 1] < n) if len(rels) else np.zeros(0, bool)
    rels = rels[ok][:R]
    gt_rels[: len(rels)] = rels
    rel_valid[: len(rels)] = True

    return {
        "image": canvas,
        "gt_labels": gt_labels,
        "gt_boxes": gt_boxes,
        "gt_masks": gt_masks,
        "gt_valid": gt_valid,
        "gt_rels": gt_rels,
        "rel_valid": rel_valid,
        "image_shape": np.asarray([rh, rw], np.int32),
        "orig_shape": np.asarray([orig_h, orig_w], np.int32),
    }


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Test-time loader: the split in order, preprocessed on a thread pool
    (``num_workers`` threads; 0 runs in the caller's thread) with
    ``prefetch`` batches in flight, collated to fixed shapes. A trailing
    partial batch is padded with its first sample and ``batch_valid`` marks
    the real ones."""

    def __init__(self, dataset, cfg: PipelineConfig, batch_size: int, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _plan(self):
        n, b = len(self.dataset), self.batch_size
        return [list(range(start, min(start + b, n))) for start in range(0, n, b)]

    def _finalize(self, samples: list[dict]) -> dict:
        n_real = len(samples)
        samples = samples + [samples[0]] * (self.batch_size - n_real)
        batch = collate(samples)
        batch["batch_valid"] = np.arange(self.batch_size) < n_real
        return batch

    def __iter__(self):
        plan = self._plan()
        if self.num_workers <= 0:
            for idxs in plan:
                yield self._finalize([preprocess_sample(self.dataset, i, self.cfg)
                                      for i in idxs])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(idxs):
                return [pool.submit(preprocess_sample, self.dataset, i, self.cfg) for i in idxs]

            depth = max(1, self.prefetch)
            pending = [submit(idxs) for idxs in plan[:depth]]
            for nxt in range(depth, len(plan) + depth):
                futs = pending.pop(0)
                if nxt < len(plan):
                    pending.append(submit(plan[nxt]))
                yield self._finalize([f.result() for f in futs])
