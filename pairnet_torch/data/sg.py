"""The box-only scene graph datasets and views of a split (the port's copy
of ``pairnet_tpu/data/sg.py``):

* ``SceneGraphDataset`` (Visual Genome VG-150) and ``OIV6Dataset`` (Open
  Images V6): PSG's json schema (``data``, ``test_image_ids``,
  ``thing_classes``, ``stuff_classes``, ``predicate_classes``) with boxes
  only, no panoptic PNGs; the masks are the boxes filled, for the
  pipeline; scoring uses ``detection_method="bbox"``;
* the balanced relation sampler (``BalancedRelationDataset``) and a rank's
  shard of a split for sharded scoring.
"""

from __future__ import annotations

import numpy as np

from pairnet_torch.config.registry import DATASETS
from pairnet_torch.data.psg import PSGDataset


@DATASETS.register()
class SceneGraphDataset(PSGDataset):
    """VG-150 through the PSG reader; the masks are synthesized from the
    boxes for the pipeline only."""

    detection_method = "bbox"

    def load_masks(self, idx: int):
        d = self.data[idx]
        n = len(d.annotations)
        boxes = np.asarray([a["bbox"] for a in d.annotations], np.float32)
        labels = np.asarray([a["category_id"] for a in d.annotations], np.int64)
        masks = np.zeros((n, d.height, d.width), bool)
        for i, b in enumerate(boxes):
            x0, y0, x1, y1 = (int(v) for v in b)
            masks[i, max(y0, 0): max(y1, 0), max(x0, 0): max(x1, 0)] = True
        semantic = np.full((d.height, d.width), 255, np.uint8)
        return masks, labels, semantic


@DATASETS.register()
class OIV6Dataset(SceneGraphDataset):
    """Open Images V6 scene graphs; box scoring only."""

    detection_method = "bbox"


class IndexedDataset:
    """``dataset`` seen through ``indices``: item i is ``dataset``'s item
    ``indices[i]`` (a rank's shard of a split, the balanced sampler's
    repeats); everything else is the wrapped dataset's."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    def __len__(self) -> int:
        return len(self.indices)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def get_ann_info(self, idx: int):
        return self.dataset.get_ann_info(self.indices[idx])

    def load_image(self, idx: int):
        return self.dataset.load_image(self.indices[idx])

    def load_masks(self, idx: int):
        return self.dataset.load_masks(self.indices[idx])

    def load_pan_ids(self, idx: int):
        return self.dataset.load_pan_ids(self.indices[idx])

    @property
    def data(self):
        return _IndexedView(self.dataset.data, self.indices)


class BalancedRelationDataset(IndexedDataset):
    """LVIS-style repeat-factor oversampling keyed on predicate frequency
    (the reference's balanced_wrapper): per-predicate repeat factor
    r(c) = max(1, sqrt(thr / f(c))) with f(c) the predicate's share of all
    relations; per-image factor r(I) = the max over the image's predicates,
    rounded up; image I appears r(I) times in a row. The frequencies
    default to the wrapped split's own."""

    def __init__(self, dataset, oversample_thr: float, rel_cls_freq: dict | None = None):
        if rel_cls_freq is None:
            freq = np.zeros(len(dataset.PREDICATES) + 1)
            for i in range(len(dataset)):
                for p in dataset.data[i].relations[:, 2]:
                    freq[int(p)] += 1
            rel_cls_freq = {c: f for c, f in enumerate(freq) if f > 0}

        total = sum(rel_cls_freq.values())
        repeat = {c: max(1.0, np.sqrt(oversample_thr / (f / total)))
                  for c, f in rel_cls_freq.items()}

        repeat_indices: list[int] = []
        for idx in range(len(dataset)):
            rels = dataset.get_ann_info(idx)["rels"]
            factors = [repeat.get(int(p), 1.0) for p in rels[:, 2]] or [1.0]
            repeat_indices.extend([idx] * int(np.ceil(max(factors))))
        super().__init__(dataset, repeat_indices)

    @property
    def repeat_indices(self) -> list[int]:
        return self.indices


def shard(dataset, rank: int, world: int):
    """Rank ``rank``'s images of a split scored by ``world`` ranks: image i
    goes to rank i mod world, so the shards are disjoint and together
    complete (no image dropped, none counted twice). The split itself at
    world size 1."""
    if world == 1:
        return dataset
    return IndexedDataset(dataset, range(rank, len(dataset), world))


class _IndexedView:
    """``base`` seen through ``indices``: item i is ``base[indices[i]]``."""

    def __init__(self, base, indices):
        self._base = base
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._base[self._indices[i]]

    def __iter__(self):
        for i in self._indices:
            yield self._base[i]
