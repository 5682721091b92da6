"""Synthetic PSG-format dataset generator (the port's copy of
``pairnet_tpu/data/synthetic.py``).

Writes a tiny but schema-complete PSG dataset (psg.json + RGB images +
panoptic PNGs) for end-to-end evaluation without the real data: axis-aligned
coloured rectangles (things) over a background (stuff), relations between
random segment pairs. The same seed gives the same arrays and annotations as
the JAX package's generator; the PNGs are written by :mod:`.png`, not PIL.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pairnet_torch.data import png
from pairnet_torch.data.psg import id2rgb

THING_CLASSES = ["ball", "box", "cat", "dog"]
STUFF_CLASSES = ["sky", "grass", "water"]
PREDICATES = ["on", "beside", "over", "under", "near"]


def make_synthetic_psg(
    root: str,
    num_images: int = 8,
    num_test: int = 3,
    height: int = 96,
    width: int = 128,
    max_things: int = 4,
    seed: int = 0,
) -> str:
    """Generate the dataset under ``root``; returns the psg.json path."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    pan_dir = os.path.join(root, "panoptic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)

    n_thing = len(THING_CLASSES)
    n_classes = n_thing + len(STUFF_CLASSES)
    data = []
    for i in range(num_images):
        image_id = f"img{i:04d}"
        seg_ids = np.zeros((height, width), np.int64)
        segments_info = []
        annotations = []

        # background stuff segment (id 1)
        stuff_cls = int(rng.integers(n_thing, n_classes))
        seg_ids[:] = 1
        segments_info.append({"id": 1, "category_id": stuff_cls, "isthing": False})
        annotations.append({"bbox": [0, 0, width, height], "category_id": stuff_cls})

        n = int(rng.integers(2, max_things + 1))
        for t in range(n):
            cls = int(rng.integers(0, n_thing))
            w = int(rng.integers(12, width // 2))
            h = int(rng.integers(12, height // 2))
            x0 = int(rng.integers(0, width - w))
            y0 = int(rng.integers(0, height - h))
            sid = t + 2
            seg_ids[y0 : y0 + h, x0 : x0 + w] = sid
            segments_info.append({"id": sid, "category_id": cls, "isthing": True})
            annotations.append({"bbox": [x0, y0, x0 + w, y0 + h], "category_id": cls})

        # drop segments that were fully occluded, keeping lists aligned
        live = set(np.unique(seg_ids).tolist())
        keep = [k for k, s in enumerate(segments_info) if s["id"] in live]
        segments_info = [segments_info[k] for k in keep]
        annotations = [annotations[k] for k in keep]

        n_seg = len(segments_info)
        n_rel = int(rng.integers(1, max(2, n_seg)))
        relations = []
        for _ in range(n_rel):
            s, o = rng.choice(n_seg, size=2, replace=False)
            p = int(rng.integers(0, len(PREDICATES)))  # 0-based on disk
            relations.append([int(s), int(o), p])

        # deterministic class-keyed colors for the RGB image
        img = np.zeros((height, width, 3), np.uint8)
        for s in segments_info:
            color = (np.asarray([37, 91, 143]) * (s["category_id"] + 1) % 255).astype(np.uint8)
            img[seg_ids == s["id"]] = color
        img = np.clip(img.astype(np.int32) + rng.integers(-8, 9, img.shape), 0, 255).astype(
            np.uint8)

        png.write(os.path.join(img_dir, f"{image_id}.png"), img)
        png.write(os.path.join(pan_dir, f"{image_id}_pan.png"), id2rgb(seg_ids))

        data.append(
            {
                "image_id": image_id,
                "file_name": f"images/{image_id}.png",
                "pan_seg_file_name": f"panoptic/{image_id}_pan.png",
                "height": height,
                "width": width,
                "segments_info": segments_info,
                "annotations": annotations,
                "relations": relations,
            }
        )

    test_ids = [d["image_id"] for d in data[-num_test:]]
    psg = {
        "data": data,
        "test_image_ids": test_ids,
        "thing_classes": THING_CLASSES,
        "stuff_classes": STUFF_CLASSES,
        "predicate_classes": PREDICATES,
    }
    ann_path = os.path.join(root, "psg.json")
    with open(ann_path, "w") as f:
        json.dump(psg, f)
    return ann_path


def write_box_only_split(root: str, ann_file: str) -> str:
    """The fixture under ``root`` as a box-only split in VG's schema:
    ``ann_file`` holds psg.json's images, annotations (boxes) and relations,
    without segments or panoptic PNGs (relations index the annotations).
    Written under a private name, then renamed into place; returns its path."""
    path = os.path.join(root, ann_file)
    if os.path.exists(path):
        return path
    with open(os.path.join(root, "psg.json")) as f:
        psg = json.load(f)
    for d in psg["data"]:
        d.pop("segments_info", None)
        d.pop("pan_seg_file_name", None)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(psg, f)
    os.replace(tmp, path)
    return path
