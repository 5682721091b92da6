"""Render saved predictions: the port's counterpart of ``tools/vis_results.py``.

Usage::

    python -m pairnet_torch.tools.vis_results CONFIG RESULTS.pkl [--out-dir viz]
        [--topk 20] [--limit N] [--split test] [--cfg-options k=v ...]

Reads the ``--save-results`` pickle of ``python -m pairnet_torch.tools.test``
and the config's dataset, and writes per image ``<i>.png`` (the image, a
panoptic overlay of the top-k triplets' masks, the triplets outlined, the
scene graph), ``<i>.png.dot`` and ``<i>.png.triplets.txt`` with the ranked
'subject --predicate--> object' lines. Draws and writes with numpy only.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualize saved PSG results")
    p.add_argument("config")
    p.add_argument("results", help="pickle from pairnet_torch.tools.test --save-results")
    p.add_argument("--out-dir", default="viz")
    p.add_argument("--topk", type=int, default=20)
    p.add_argument("--limit", type=int, default=0, help="max images (0=all)")
    p.add_argument("--split", default="test")
    p.add_argument("--cfg-options", nargs="+", default=[], help="dotted-path overrides k=v")
    return p.parse_args(argv)


def painted_pan_seg(masks, rel_pair_idxes, r_scores, topk, hw):
    """A painter's panoptic view of the top-k triplets' masks: entity
    ``idx`` paints ``idx + 1`` where no higher-ranked mask has painted."""
    pan_seg = np.zeros(hw, np.int64)
    painted = np.zeros(hw, bool)
    for rank in np.argsort(-r_scores)[:topk]:
        for idx in rel_pair_idxes[rank]:
            m = masks[int(idx)] & ~painted
            pan_seg[m] = int(idx) + 1
            painted |= m
    return pan_seg


def main(argv=None) -> int:
    """Writes the visualizations; returns the number of images rendered."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.evaluation.runner import load_predictions
    from pairnet_torch.train.builder import build_dataset
    from pairnet_torch.utils.visualize import save_visualization

    cfg = load_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    dataset = build_dataset(cfg, split=args.split)
    preds = load_predictions(args.results)
    if len(preds) != len(dataset):
        raise SystemExit(f"results file has {len(preds)} images, dataset has {len(dataset)}")
    os.makedirs(args.out_dir, exist_ok=True)

    n = min(len(preds), args.limit) if args.limit else len(preds)
    for i in range(n):
        img = np.asarray(dataset.load_image(i), np.uint8)
        p = preds[i]
        r_scores = p.rel_dists[:, 1:].max(-1)
        r_labels = p.rel_dists[:, 1:].argmax(-1) + 1
        pan_seg = None
        if p.masks is not None and p.masks.shape[1:] == img.shape[:2]:
            pan_seg = painted_pan_seg(p.masks, p.rel_pair_idxes, r_scores, args.topk,
                                      img.shape[:2])
        out = os.path.join(args.out_dir, f"{i:06d}.png")
        lines = save_visualization(
            out, img, pan_seg=pan_seg, masks=p.masks, labels=p.labels,
            rel_pairs=p.rel_pair_idxes, r_labels=r_labels, r_scores=r_scores,
            class_names=list(dataset.CLASSES), predicate_names=list(dataset.PREDICATES),
            topk=args.topk,
        )
        logging.info("%s: %d triplets rendered", out, len(lines))
    logging.info("wrote %d visualizations to %s", n, args.out_dir)
    return n


if __name__ == "__main__":
    main(sys.argv[1:])
