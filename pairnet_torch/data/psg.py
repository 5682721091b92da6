"""PSG (Panoptic Scene Graph) dataset reader (the port's copy of
``pairnet_tpu/data/psg.py``).

* single ``psg.json`` with keys ``data``, ``test_image_ids``,
  ``thing_classes``, ``stuff_classes``, ``predicate_classes``,
* predicates are 1-indexed on load, images with zero relations are dropped,
* train/test split membership by ``test_image_ids``,
* relation dedup: train keeps one random predicate per (sub, obj) pair;
  test keeps unique triplets,
* NxN relation map with random keep on collision.

Panoptic PNGs are decoded by :mod:`.png` (``id = r + 256*g + 65536*b``), so
the evaluation path needs no PIL. Images are PNG (read by :mod:`.png`) or
another format such as JPEG, which needs PIL.
"""

from __future__ import annotations

import json
import os.path as osp
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from pairnet_torch.config.registry import DATASETS
from pairnet_torch.data import png


def rgb2id(color: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int64 panoptic segment ids."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 65536 * color[..., 2]


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """(H, W) int -> (H, W, 3) uint8 (inverse of rgb2id)."""
    ids = ids.astype(np.int64)
    return np.stack([ids % 256, (ids // 256) % 256, (ids // 65536) % 256], axis=-1).astype(
        np.uint8)


def read_image_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3) of an image file: PNG without PIL, other formats by PIL."""
    if path.lower().endswith(".png"):
        return png.read_rgb(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only PNG is read without PIL; install Pillow for "
                          "other image formats") from e
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


@dataclass
class PSGItem:
    image_id: str
    file_name: str
    pan_seg_file_name: str
    height: int
    width: int
    segments_info: list  # [{id, category_id, isthing, ...}]
    annotations: list  # [{bbox, category_id, ...}] aligned with segments_info
    relations: np.ndarray  # (R, 3) [sub_idx, obj_idx, predicate_1based]


@DATASETS.register()
class PSGDataset:
    def __init__(
        self,
        ann_file: str,
        data_root: str | None = None,
        img_prefix: str = "",
        seg_prefix: str | None = None,
        split: str = "train",
        test_mode: bool = False,
        all_bboxes: bool = True,
        seed: int = 10086,
    ):
        assert split in {"train", "test"}
        self.split = split
        self.test_mode = test_mode
        self.all_bboxes = all_bboxes
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix if seg_prefix is not None else img_prefix
        if data_root is not None:
            if not osp.isabs(ann_file):
                ann_file = osp.join(data_root, ann_file)
            if not osp.isabs(self.img_prefix):
                self.img_prefix = osp.join(data_root, self.img_prefix)
            if not osp.isabs(self.seg_prefix):
                self.seg_prefix = osp.join(data_root, self.seg_prefix)
        self._rng = np.random.default_rng(seed)

        with open(ann_file) as f:
            dataset = json.load(f)

        test_ids = set(dataset["test_image_ids"])
        self.THING_CLASSES = dataset["thing_classes"]
        self.STUFF_CLASSES = dataset["stuff_classes"]
        self.CLASSES = self.THING_CLASSES + self.STUFF_CLASSES
        self.PREDICATES = dataset["predicate_classes"]

        self.data: list[PSGItem] = []
        for d in dataset["data"]:
            rels = [[r[0], r[1], r[2] + 1] for r in d["relations"]]  # 1-index
            if len(rels) == 0:
                continue  # drop relation-less images
            in_test = d["image_id"] in test_ids
            if (split == "train") == in_test:
                continue
            self.data.append(
                PSGItem(
                    image_id=d["image_id"],
                    file_name=d["file_name"],
                    pan_seg_file_name=d.get("pan_seg_file_name", ""),
                    height=d["height"],
                    width=d["width"],
                    segments_info=d.get("segments_info", []),
                    annotations=d.get("annotations", []),
                    relations=np.asarray(rels, dtype=np.int32),
                )
            )

    def __len__(self) -> int:
        return len(self.data)

    # -- annotations -------------------------------------------------------
    def get_ann_info(self, idx: int) -> dict:
        d = self.data[idx]
        if self.all_bboxes:
            if d.annotations:
                gt_bboxes = np.asarray([a["bbox"] for a in d.annotations], np.float32)
                gt_labels = np.asarray([a["category_id"] for a in d.annotations], np.int64)
            else:
                gt_bboxes = np.zeros((0, 4), np.float32)
                gt_labels = np.zeros((0,), np.int64)
        else:
            things = [
                (a["bbox"], a["category_id"])
                for a, s in zip(d.annotations, d.segments_info)
                if s["isthing"]
            ]
            gt_bboxes = (
                np.asarray([t[0] for t in things], np.float32)
                if things
                else np.zeros((0, 4), np.float32)
            )
            gt_labels = np.asarray([t[1] for t in things], np.int64)

        gt_rels = self._dedup_relations(d.relations)

        # box-only datasets have no segments_info; index by annotations
        num_seg = len(d.segments_info) or len(d.annotations)
        relation_map = np.zeros((num_seg, num_seg), np.int64)
        for s, o, p in gt_rels:
            if relation_map[s, o] > 0:
                if self._rng.random() > 0.5:
                    relation_map[s, o] = p
            else:
                relation_map[s, o] = p

        return dict(
            bboxes=gt_bboxes,
            labels=gt_labels,
            rels=gt_rels,
            rel_maps=relation_map,
            masks=[
                {"id": s["id"], "category": s["category_id"], "is_thing": s["isthing"]}
                for s in d.segments_info
            ]
            or [
                # box-only datasets: one pseudo-segment per annotation
                {"id": i, "category": a["category_id"], "is_thing": True}
                for i, a in enumerate(d.annotations)
            ],
            seg_map=d.pan_seg_file_name,
        )

    def _dedup_relations(self, rels: np.ndarray) -> np.ndarray:
        if self.split == "train":
            pair_sets = defaultdict(list)
            for s, o, p in rels:
                pair_sets[(int(s), int(o))].append(int(p))
            out = [(s, o, int(self._rng.choice(ps))) for (s, o), ps in pair_sets.items()]
            return np.asarray(out, np.int32)
        seen: list[tuple] = []
        for s, o, p in rels:
            t = (int(s), int(o), int(p))
            if t not in seen:
                seen.append(t)
        return np.asarray(seen, np.int32)

    # -- image / mask loading ----------------------------------------------
    def load_image(self, idx: int) -> np.ndarray:
        return read_image_rgb(osp.join(self.img_prefix, self.data[idx].file_name))

    def _seg_ids(self, idx: int) -> np.ndarray:
        d = self.data[idx]
        return rgb2id(png.read_rgb(osp.join(self.seg_prefix, d.pan_seg_file_name)))

    def load_masks(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decode the panoptic PNG -> (masks (N, H, W) bool, labels (N,),
        semantic (H, W)): one binary mask per segment (things and stuff);
        the semantic map uses 255 as ignore."""
        d = self.data[idx]
        seg_ids = self._seg_ids(idx)
        masks = []
        labels = []
        semantic = np.full(seg_ids.shape, 255, np.uint8)
        for s in d.segments_info:
            m = seg_ids == s["id"]
            masks.append(m)
            labels.append(s["category_id"])
            semantic[m] = s["category_id"]
        if masks:
            return np.stack(masks), np.asarray(labels, np.int64), semantic
        h, w = seg_ids.shape
        return np.zeros((0, h, w), bool), np.zeros((0,), np.int64), semantic

    def load_pan_ids(self, idx: int) -> tuple[np.ndarray, dict]:
        """Decode the panoptic PNG -> (seg_ids (H, W) int64, id->label map).
        Pixels whose id is not in segments_info are VOID (-1) for PQ."""
        d = self.data[idx]
        seg_ids = self._seg_ids(idx)
        id2label = {int(s["id"]): int(s["category_id"]) for s in d.segments_info}
        labeled = np.isin(seg_ids, list(id2label))
        return np.where(labeled, seg_ids, -1), id2label
