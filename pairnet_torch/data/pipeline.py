"""Host-side preprocessing -> fixed-shape batches (the port's copy of
``pairnet_tpu/data/pipeline.py``, train and test side).

Keep-ratio resize to ``target_size`` (short, long), ImageNet normalization,
padding into one canvas, GT instances padded to ``max_inst``, relations to
``max_rels``, GT masks at ``mask_stride``. At train time, as the JAX
package: with probability ``crop_prob`` the relation-aware crop branch
(resize to a ``crop_scales`` short side, :func:`rel_random_crop`, falling
back to the plain branch when no triplet survives), a ``train_scales``
short side, and a horizontal flip with probability ``flip_prob``. The
draws come from a numpy ``Generator`` in the JAX package's order, so one
seed gives the same arrays bit for bit.

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

import os
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
    flip_prob: float = 0.5
    train_scales: tuple[int, ...] = ()  # multi-scale short sides (train)
    # crop branch (train): with prob crop_prob, resize to a random
    # crop_scales short side, rel_random_crop with a crop size drawn in
    # crop_size_range, then the multi-scale resize
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


def preprocess_sample(dataset, idx: int, cfg: PipelineConfig, train: bool = False,
                      rng: np.random.Generator | None = None) -> dict:
    """One image -> fixed-shape numpy sample dict. ``train`` draws the
    augmentation from ``rng`` in the JAX package's order: the crop branch's
    coin (only when ``cfg.crop_prob`` is set), then inside it the crop
    scale, the crop height and width and the offsets, then the train scale,
    then the flip's coin (always at train time)."""
    rng = rng or np.random.default_rng()
    img = dataset.load_image(idx)
    masks, _, _ = dataset.load_masks(idx)
    ann = dataset.get_ann_info(idx)
    rels = ann["rels"]  # (R, 3) predicate 1-based
    labels = np.asarray([m["category"] for m in ann["masks"]], np.int64)

    short, long = cfg.target_size
    orig_h, orig_w = img.shape[:2]
    if train and cfg.crop_prob and rng.random() < cfg.crop_prob:
        # resize -> rel_random_crop -> resize; when no triplet survives the
        # crop, the plain resize branch below runs on the original image
        short0 = int(rng.choice(cfg.crop_scales))
        img0 = resize_image(img, keep_ratio_scale(orig_h, orig_w, short0, long))
        m0 = resize_masks_nearest(masks, img0.shape[:2])
        cmin, cmax = cfg.crop_size_range
        h0, w0 = img0.shape[:2]
        ch = int(rng.integers(min(cmin, h0), min(cmax, h0) + 1))
        cw = int(rng.integers(min(cmin, w0), min(cmax, w0) + 1))
        cropped = rel_random_crop(img0, m0, labels, rels, (ch, cw), rng)
        if cropped is not None:
            img, masks, labels, rels = cropped
    if train and cfg.train_scales:
        short = int(rng.choice(cfg.train_scales))
    img_r = resize_image(img, keep_ratio_scale(img.shape[0], img.shape[1], short, long))
    if train and rng.random() < cfg.flip_prob:
        img_r = img_r[:, ::-1]
        masks = masks[:, :, ::-1]

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


def rel_random_crop(img: np.ndarray, masks: np.ndarray, labels: np.ndarray, rels: np.ndarray,
                    crop_hw: tuple[int, int], rng: np.random.Generator):
    """Relation-aware random crop (the reference's RelRandomCrop): crop the
    image at offsets drawn from ``rng`` (y, then x), drop instances whose
    mask vanishes, re-index the surviving relations by the prefix sum of
    kept instances, and return None when no triplet survives.

    img (H, W, 3) uint8; masks (N, H, W) bool; rels (R, 3) predicate 1-based.
    """
    ch, cw = crop_hw
    H, W = img.shape[:2]
    off_y = int(rng.integers(0, max(H - ch, 0) + 1))
    off_x = int(rng.integers(0, max(W - cw, 0) + 1))
    img_c = img[off_y : off_y + ch, off_x : off_x + cw]
    masks_c = masks[:, off_y : off_y + ch, off_x : off_x + cw]
    valid = masks_c.any(axis=(1, 2))
    new_index = np.cumsum(valid) - 1
    rels_left = [[int(new_index[s]), int(new_index[o]), int(p)]
                 for s, o, p in rels if valid[s] and valid[o]]
    if not rels_left:
        return None
    return img_c, masks_c[valid], labels[valid], np.asarray(rels_left, np.int32)


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Epoch loader: the split in order (shuffled by ``seed`` at train time),
    preprocessed, collated to fixed shapes. ``num_workers`` threads (None:
    ``PAIRNET_LOADER_WORKERS``, default 4) preprocess with ``prefetch``
    batches in flight, each sample drawing from its own
    ``default_rng([seed, position])``; with ``num_workers <= 0`` the
    caller's thread draws the shuffle and every sample from one sequential
    stream seeded ``seed``, as the JAX package's loader does. ``drop_last``
    (default: ``train``) drops a trailing partial batch; otherwise it is
    padded with its first sample and ``batch_valid`` marks the real ones.
    ``sample_transform(sample, rng)`` (e.g. :func:`to_twostage_batch`)
    runs on each preprocessed sample with that sample's generator (the one
    stream, after all the batch's samples, as JAX's loader runs it).

    Data parallelism: ``batch_size`` is the global batch; rank ``rank`` of
    ``world`` preprocesses only rows ``rank * b : (rank + 1) * b`` of each
    global batch (``b = batch_size / world``) at their global positions, so
    every rank builds the same order and each sample equals the world-1
    run's at the same position. The sequential stream needs world size 1.
    (A train image that repeats a (subject, object) pair keeps one of its
    predicates drawn from the dataset's own generator, as the reference
    does, in the order the threads ask: that draw follows neither the
    position nor the rank.)"""

    def __init__(self, dataset, cfg: PipelineConfig, batch_size: int, train: bool = False,
                 seed: int = 0, drop_last: bool | None = None, num_workers: int | None = None,
                 prefetch: int = 2, rank: int = 0, world: int = 1, sample_transform=None):
        self.dataset = dataset
        self.sample_transform = sample_transform
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = train if drop_last is None else drop_last
        if num_workers is None:
            num_workers = int(os.environ.get("PAIRNET_LOADER_WORKERS", "4"))
        self.num_workers = num_workers
        self.prefetch = prefetch
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} does not divide by the world size {world}")
        if world > 1 and num_workers <= 0:
            raise ValueError("the sequential sample stream (num_workers <= 0) needs world size 1")
        self.rank, self.world = rank, world

    def __len__(self) -> int:
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def _plan(self, order) -> list[tuple[int, list[int], int]]:
        """Per global batch: (position of this rank's first sample, its
        dataset indices, how many of its rows are real). A rank whose rows
        of a trailing batch are all padding gets the batch's first sample
        and no real row."""
        B = self.batch_size
        b = B // self.world
        end = len(order) - len(order) % B if self.drop_last else len(order)
        plan = []
        for start in range(0, end, B):
            first = start + self.rank * b
            idxs = [int(i) for i in order[first : min(first + b, start + B)]]
            plan.append((first, idxs, len(idxs)) if idxs else (start, [int(order[start])], 0))
        return plan

    def _make_sample(self, i: int, pos: int) -> dict:
        rng = np.random.default_rng([self.seed, pos])
        s = preprocess_sample(self.dataset, i, self.cfg, self.train, rng)
        return s if self.sample_transform is None else self.sample_transform(s, rng)

    def _finalize(self, samples: list[dict], n_real: int) -> dict:
        b = self.batch_size // self.world
        batch = collate(samples + [samples[0]] * (b - len(samples)))
        batch["batch_valid"] = np.arange(b) < n_real
        return batch

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.train:
            self.rng.shuffle(order)
        plan = self._plan(order)
        if self.num_workers <= 0:
            for _, idxs, n_real in plan:
                samples = [preprocess_sample(self.dataset, i, self.cfg, self.train, self.rng)
                           for i in idxs]
                if self.sample_transform is not None:  # after the batch's samples, as JAX's
                    samples = [self.sample_transform(s, self.rng) for s in samples]
                yield self._finalize(samples, n_real)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(start, idxs, n_real):
                return [pool.submit(self._make_sample, i, start + k)
                        for k, i in enumerate(idxs)], n_real

            depth = max(1, self.prefetch)
            pending = [submit(*item) for item in plan[:depth]]
            for nxt in range(depth, len(plan) + depth):
                futs, n_real = pending.pop(0)
                if nxt < len(plan):
                    pending.append(submit(*plan[nxt]))
                yield self._finalize([f.result() for f in futs], n_real)


def to_twostage_batch(sample: dict, max_pairs: int, train: bool,
                      rng: np.random.Generator | None = None,
                      relation_map: np.ndarray | None = None) -> dict:
    """A preprocessed sample with the two-stage relation-head fields: the
    detections are the GT boxes, labels 1-based (0 background); train pairs
    by :func:`~pairnet_torch.models.heads.twostage.core.sample_train_pairs`
    from ``rng``, test pairs all ordered pairs of the ``max_inst`` slots
    (the first ``max_pairs``)."""
    from pairnet_torch.models.heads.twostage.core import all_test_pairs, sample_train_pairs

    rng = rng or np.random.default_rng()
    n_valid = int(sample["gt_valid"].sum())
    G = sample["gt_valid"].shape[0]
    out = dict(sample)
    out["det_boxes"] = sample["gt_boxes"]
    out["det_labels"] = np.where(sample["gt_valid"], sample["gt_labels"] + 1, 0).astype(np.int32)
    out["det_valid"] = sample["gt_valid"]
    if relation_map is None:
        relation_map = np.zeros((G, G), np.int64)
        for s, o, p in sample["gt_rels"][sample["rel_valid"]]:
            relation_map[s, o] = p
    if train:
        pairs, labels, valid = sample_train_pairs(relation_map, n_valid, max_pairs, rng=rng)
    else:
        pairs, valid = all_test_pairs(n_valid, G)
        pairs, valid = pairs[:max_pairs], valid[:max_pairs]
        labels = relation_map[pairs[:, 0], pairs[:, 1]].astype(np.int32)
    out["pairs"] = pairs
    out["pair_labels"] = labels.astype(np.int32)
    out["pair_valid"] = valid
    return out
