"""Score a scene-graph model: the port's counterpart of ``tools/test.py``.

Usage::

    python -m pairnet_torch.tools.test CONFIG [WORK_DIR] --eval sgdet
        [--cfg-options k=v ...] [--out metrics.json] [--device cpu]
    torchrun --nproc_per_node N -m pairnet_torch.tools.test CONFIG ...

With no WORK_DIR the model keeps seeded random weights (a warning says
so); with one, the newest ``WORK_DIR/ckpts/epoch_<n>.pt`` that the port's
``Trainer`` wrote is loaded. The forward runs in bf16 (default) or f32 on
``--device`` (default ``cuda:LOCAL_RANK``). Pair-Net scores sgdet on the
device engine (``--eval-engine numpy`` or ``--save-results``: the host
oracle); every other one-stage head (PSGTr, PSGFormer, the Mask2Former
baselines, PSGTr2, DETR4Seg, the box Pair-Net ``CrossHeadBBox``, which
scores boxes: ``detection_method="bbox"``) through its own
post-processing and the host oracle, as the JAX CLI routes them; PQ through the head's
post-processing. A two-stage model (``SceneGraphTwoStage``) scores predcls and
sgcls on GT boxes (either engine) and sgdet through the frozen detector of the
config's ``model.detector``, in f32 whatever ``--dtype``, as JAX's CLI scores
it; PQ exits for it, as JAX's does. Under ``torchrun`` the ranks
score disjoint shards of the split (image i on rank i mod world) and merge
the metrics exactly (``evaluation/runner.py``); rank 0 logs and writes
``--out`` and ``--save-results``. The MSDA kernels follow the JAX package's
environment names, read here and only here: ``PAIRNET_DEFORM_IMPL``
(``pallas_v16`` -> int4, ``pallas_v12``/``pallas_v14`` -> int8,
``pallas_v6``/``pallas_v7`` -> exact, ``rows``/``patch`` -> plain; unset:
int4 for bf16, exact for f32) and ``PAIRNET_FLASH_ATTN=1`` (the masked
flash cross-attention kernel in the decoder layers with >= 2048 keys).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time
from pathlib import Path

import torch

DEFORM_IMPLS = {"pallas_v16": "int4", "pallas_v12": "int8", "pallas_v14": "int8",
                "pallas_v6": "exact", "pallas_v7": "exact", "rows": "plain", "patch": "plain"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a PSG model")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", help="work dir with ckpts/ (optional)")
    p.add_argument("--eval", default="sgdet",
                   choices=["sgdet", "sgcls", "predcls", "pairdet", "PQ"],
                   help="PQ scores panoptic segmentation quality")
    p.add_argument("--out", help="dump metrics json here")
    p.add_argument("--save-results", help="pickle per-image predictions here")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--eval-engine", choices=["device", "numpy"], default="device",
                   help="device: recall matching and mask upsampling on the model's device "
                        "(the default for sgdet); numpy: the host oracle engine (needs PIL)")
    p.add_argument("--split", choices=["test", "train"], default="test",
                   help="dataset split to score")
    p.add_argument("--dtype", choices=["f32", "bf16"], default="bf16",
                   help="bf16 (default): bf16 parameters and activations and the int4 MSDA "
                        "kernels, the serving configuration; f32: the exact MSDA kernel")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default=None, help="torch device (default: cuda:LOCAL_RANK)")
    return p.parse_args(argv)


def deform_impl(dtype: str) -> str:
    """The MSDA impl that ``PAIRNET_DEFORM_IMPL`` names, else the dtype's default."""
    name = os.environ.get("PAIRNET_DEFORM_IMPL")
    if not name:
        return "int4" if dtype == "bf16" else "exact"
    if name not in DEFORM_IMPLS:
        raise ValueError(f"PAIRNET_DEFORM_IMPL={name!r}: expected one of {sorted(DEFORM_IMPLS)}")
    return DEFORM_IMPLS[name]


def load_weights(model, work_dir: str | None):
    """The newest ``ckpts/epoch_<n>.pt`` of ``work_dir`` into ``model``;
    with no work dir the seeded random weights stay."""
    if not work_dir:
        logging.warning("no checkpoint given: evaluating RANDOM weights")
        return model
    ckpts = sorted((int(m.group(1)), p) for p in (Path(work_dir) / "ckpts").glob("epoch_*.pt")
                   if (m := re.fullmatch(r"epoch_(\d+)\.pt", p.name)))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {work_dir}/ckpts (epoch_<n>.pt)")
    epoch, path = ckpts[-1]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd["state"]["model"])
    logging.info("loaded checkpoint epoch %s from %s", epoch, path)
    return model


def make_apply_fn(model, device, dtype):
    """``apply_fn(images) -> outputs``: the loader's numpy images in ``dtype``
    on ``device`` through the model; bf16 outputs come back as f32, so the
    post-processing is the same whatever the compute dtype. The per-layer
    lists of the DETR heads are left out, as the JAX runners leave them."""

    def apply_fn(images):
        with torch.inference_mode():
            out = model(torch.from_numpy(images).to(device=device, dtype=dtype))
        return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in out.items()
                if torch.is_tensor(v)}

    return apply_fn


def main(argv=None) -> dict:
    args = parse_args(argv)
    from pairnet_torch.parallel.mesh import distributed

    with distributed(args.device) as (rank, world, device):
        return _main(args, rank, world, device)


def _main(args, rank: int, world: int, device: torch.device) -> dict:
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(message)s")

    from pairnet_torch import native
    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.flagship import set_deform_impl, set_flash_attention
    from pairnet_torch.train.builder import build_dataset, build_detector, build_pipeline_cfg

    cfg = load_config(args.config)
    if args.cfg_options:
        cfg = apply_overrides(cfg, args.cfg_options)
    head_type = cfg.model["relation_head" if "relation_head" in cfg.model else "bbox_head"].type
    if cfg.model.type == "SceneGraphTwoStage":
        return _main_twostage(args, cfg, rank, device)
    impl = deform_impl(args.dtype)
    flash = os.environ.get("PAIRNET_FLASH_ATTN") == "1"
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32

    dataset = build_dataset(cfg, split=args.split)
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    native.available()  # build the loader's host library now, outside the timed run
    model = load_weights(build_detector(cfg, device=device), args.checkpoint).to(dtype)
    set_deform_impl(model, impl)
    set_flash_attention(model, flash)
    logging.info("scoring on %s x %d ranks, %s, MSDA %s, flash attention %s", device, world,
                 args.dtype, impl, "on" if flash else "off")
    apply_fn = make_apply_fn(model, device, dtype)

    from pairnet_torch.evaluation import runner

    t0 = time.time()
    if args.eval == "PQ":
        from pairnet_torch.train.dispatch import get_postprocess_fn

        metrics = runner.evaluate_pq(
            apply_fn, get_postprocess_fn(head_type), dataset, pipe_cfg,
            batch_size=args.batch_size, num_classes=cfg.num_object_classes,
            num_things=cfg.evaluation.num_things,
        )
    else:
        kwargs = dict(batch_size=args.batch_size, mode=args.eval,
                      num_predicates=cfg.num_relation_classes,
                      num_things=cfg.evaluation.num_things,
                      iou_thr=cfg.evaluation.get("iou_thr", 0.5))
        if head_type != "PairNetHead":
            from pairnet_torch.train.dispatch import get_postprocess_fn

            metrics = runner.evaluate_model_with_postprocess(
                apply_fn, get_postprocess_fn(head_type), dataset, pipe_cfg,
                results_out=args.save_results, **kwargs)
        elif args.eval_engine == "device" and args.eval == "sgdet" and not args.save_results:
            metrics = runner.evaluate_model_device(apply_fn, dataset, pipe_cfg, **kwargs)
        else:
            metrics = runner.evaluate_model(apply_fn, dataset, pipe_cfg,
                                            results_out=args.save_results, **kwargs)
    return _report(args, metrics, t0, len(dataset), rank, device)


def _report(args, metrics: dict, t0: float, n_images: int, rank: int, device) -> dict:
    """Add the time and rate to the metrics, log them, write ``--out``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    metrics[f"{args.eval}_eval_time_s"] = round(dt, 2)
    metrics[f"{args.eval}_images_per_s"] = round(n_images / dt, 3)

    for k, v in sorted(metrics.items()):
        logging.info("%s: %.4f", k, v)
    if args.out and rank == 0:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
        logging.info("metrics written to %s", args.out)
    return metrics


def head_dists(seg, num_dets: int, num_things: int, num_classes: int):
    """The fused segments' distributions in a relation head's label space
    of ``num_classes``: background at 0, the ``num_dets`` detections'
    things at 1..T with their box-head probabilities (whose background is
    last), the stuff segments as the one-hot of their label."""
    T, C = num_things, num_classes
    k = min(T, C - 1)  # the things the head's label space holds
    dists = seg.dists.new_zeros((*seg.labels.shape, C))
    dists[:, :num_dets, 0] = seg.dists[:, :num_dets, T]
    dists[:, :num_dets, 1:k + 1] = seg.dists[:, :num_dets, :k]
    stuff = seg.labels[:, num_dets:].long().clamp(0, C - 1)
    dists[:, num_dets:] = (stuff[..., None] == torch.arange(C, device=stuff.device)).to(
        dists.dtype)
    return dists


def detector_segments(det_cfg: dict, backbone_cfg, num_classes: int, max_dets: int,
                      mask_stride: int, device):
    """``detector_apply(images, image_shape)`` of the two-stage sgdet path:
    the frozen ``PanopticFPN`` of ``det_cfg`` (its own ``backbone``, else a
    copy of ``backbone_cfg``; weights from its ``checkpoint`` work dir, else
    seeded) in f32, then :func:`heuristic_fusion_segments`. Returns the
    segments' (boxes, labels, dists, valid, mask logits +-1), the dists in
    the relation head's label space of ``num_classes`` (:func:`head_dists`):
    JAX passes the box head's (T + 1)-wide distribution with background
    last, which its sgdet heads cannot take at the published widths (81
    against 134). ``detector_apply.detector`` is the frozen detector."""
    from pairnet_torch.models.frameworks.panoptic_fpn import heuristic_fusion_segments
    from pairnet_torch.train.builder import build_model

    det_cfg = dict(det_cfg)
    det_cfg.setdefault("type", "PanopticFPN")
    det_cfg.setdefault("max_dets", max_dets)
    det_cfg.setdefault("backbone", dict(backbone_cfg))
    ckpt = det_cfg.pop("checkpoint", None)
    detector = load_weights(build_model(det_cfg, device=device), ckpt).float()
    T, S = detector.num_things, detector.num_stuff

    def detector_apply(images, image_shape):
        with torch.inference_mode():
            img = torch.as_tensor(images).to(device=device, dtype=torch.float32)
            shape = torch.as_tensor(image_shape).to(device)
            dets, sem, det_masks = detector(img, shape, with_masks=True)
            seg = heuristic_fusion_segments(dets, det_masks, sem, T, S, mask_stride=mask_stride)
            return (seg.boxes, seg.labels, head_dists(seg, dets.labels.shape[1], T, num_classes),
                    seg.valid, torch.where(seg.masks, 1.0, -1.0))

    detector_apply.detector = detector
    return detector_apply


def make_twostage_apply_fn(model, device, dtype):
    """``apply_fn(batch) -> outputs``: a two-stage batch (numpy arrays or
    tensors) on ``device``, its image in ``dtype``; f32 outputs."""

    def apply_fn(batch):
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        b["image"] = b["image"].to(dtype)
        with torch.inference_mode():
            out = model(b)
        return {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in out.items()}

    return apply_fn


def _main_twostage(args, cfg, rank: int, device: torch.device) -> dict:
    """The two-stage branch, as JAX's CLI runs it: the relation model in f32
    (JAX scores it uncast, whatever ``--dtype``), predcls / sgcls on GT
    boxes (``--eval-engine`` device or numpy), sgdet through the frozen
    detector on the numpy oracle. PQ exits, as JAX's does. Under ``torchrun``
    :func:`evaluate_twostage` scores this rank's shard and merges the
    predictions on rank 0, which hands every rank the metrics."""
    from pairnet_torch import native
    from pairnet_torch.evaluation.runner import evaluate_twostage
    from pairnet_torch.train.builder import build_dataset, build_detector, build_pipeline_cfg

    if args.eval == "PQ":
        raise SystemExit("PQ for the two-stage path scores its frozen detector; evaluate the "
                         "detector's own config instead")
    dataset = build_dataset(cfg, split=args.split)
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    native.available()
    model = load_weights(build_detector(cfg, device=device), args.checkpoint).float()
    detector_apply = None
    if args.eval == "sgdet":
        detector_apply = detector_segments(cfg.model.get("detector", {}), cfg.model.backbone,
                                           cfg.model.relation_head.num_classes,
                                           pipe_cfg.max_inst, pipe_cfg.mask_stride, device)
    logging.info("scoring the two-stage %s on %s, f32", cfg.model.relation_head.type, device)
    t0 = time.time()
    metrics = evaluate_twostage(
        make_twostage_apply_fn(model, device, torch.float32), dataset, pipe_cfg,
        max_pairs=cfg.data.get("test_max_pairs"), batch_size=args.batch_size, mode=args.eval,
        num_predicates=cfg.num_relation_classes, num_things=cfg.evaluation.num_things,
        iou_thr=cfg.evaluation.get("iou_thr", 0.5), detector_apply=detector_apply,
        eval_engine=args.eval_engine if args.eval in ("predcls", "sgcls") else "numpy",
        device=device)
    return _report(args, metrics, t0, len(dataset), rank, device)


if __name__ == "__main__":
    main(sys.argv[1:])
