#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line then):
  0. the card: nvidia-smi name and power limit; no CUDA -> fail.
  1. build the CUDA kernels from pairnet_torch/csrc (one nvcc each, in parallel).
  2. hold every kernel against its plain PyTorch version at the pixel
     decoder's encoder geometry of an 800x1344 image, batch 2, with wide
     sampling offsets (many taps out of the plane): the forward kernels and
     the three instances of the backward kernel (f32, bf16, bf16_grad).
  3. serve full-width Pair-Net R-50 (800x1344, batch 8, bf16, int4 MSDA):
     counts each kernel's launches in that run, checks the outputs.
  4. an f32 forward (batch 1, TF32 off) through the exact kernel against
     the same forward through the plain MSDA.
  5. each serving kernel against its plain version again, on the inputs
     the main paths gave it (first encoder layer: batch 8 bf16 serving for
     the int4 kernels, batch 1 f32 for the exact one), with the tolerances
     of phase 2; timings with CUDA events: serving img/s, each kernel and
     its plain version on those inputs (a kernel's ``ms`` as the host
     issues its calls, ``device_ms`` with them queued behind a spin of the
     card), and each kernel's bound. One quantize call launches each of its
     two passes once and no fill (the profiler's kernel names; the call
     captured as a CUDA graph holds exactly two kernels and nothing else).
  6. train full-width Pair-Net R-50 (800x1344, batch 4, bf16 compute over
     f32 masters, the geometry of ``python -m pairnet_torch.bench --train``):
     a warm-up and 3 steps on the exact backward, then 1 step on the
     bf16_grad backward; counts 6 forward and 6 backward MSDA launches and
     2 Hungarian launches per step, no host sync of the solver and no call
     of a plain version; checks finite losses, a positive
     grad norm, a head weight moved, the frozen stem unchanged, the Seesaw
     counts grown and a gradient in every encoder layer's sampling offsets.
  7. one f32 train step (batch 1, TF32 off) through the MSDA kernels
     against the same step through the plain MSDA, which replays the
     kernel run's attention masks, pair picks and Hungarian targets (the
     entries it would have set otherwise are counted): losses and every
     MSDA parameter gradient; the plain Hungarian loop on the kernel run's
     own costs gives its assignments (differences counted, must be 0).
  8. the training kernels on the inputs the training paths handed them
     (first encoder layer), with phase 2's tolerances; their timings.
  9. score: ``pairnet_torch.tools.test.main`` on the flagship config
     ``configs/pairnet/pairnet_r50_psg.py`` over a synthetic PSG split of 16
     test images at 800x1333 (padded to 800x1344), batch 8, bf16, the
     default int4 MSDA: sgdet on the device engine, then PQ; the metric key
     sets of the JAX package's engines, finite values, 6 int4 quantize and
     6 int4 gather launches per forward, no flash launch, no plain call.
 10. score again with PAIRNET_DEFORM_IMPL=pallas_v12 and
     PAIRNET_FLASH_ATTN=1 (sgdet and PQ), with pallas_v14 (sgdet), and in
     f32 with pallas_v12 (sgdet): 6 int8 quantize and 6 int8 gather
     launches per forward, one flash launch per decoder layer with >= 2048
     keys, no plain call.
 11. the int8 kernels on the inputs phase 10's first encoder layer handed
     them, the flash kernel on those of the first decoder layer at each key
     length, with phase 2's tolerances; their timings, SDPA's for the flash
     kernel (whose bound takes its operations at the tensor-core rate of
     its products, PR 3's f32-rate bound logged beside), and scoring
     images/s; each int8 quantize call's two passes, as in phase 5.
 12. the Hungarian kernel against the plain loop (equal row2col and
     col2row): on the costs of phase 6's two matchers, 4x100x100 integer
     costs (ties), padded rows and columns, n < m and n > m, a single NaN
     entry; a whole NaN row terminates (logged, not compared). Times of the
     kernel, the wrapper and the plain loop on the card, the byte bound,
     the search steps per call (the kernel's counter), and scipy's
     linear_sum_assignment on the host with the copy there (a note).
 13. train with the CLI: ``pairnet_torch.tools.train.main`` on the flagship
     config at its own train pipeline (multi-scale, crop 0.5, flip 0.5,
     batch 2, f32) over the 8 train images of phase 9's split:
     ``--max-epochs 1`` (4 steps), then ``--resume --max-epochs 2``, then
     ``pairnet_torch.tools.test.main`` scores ``epoch_2.pt`` (sgdet);
     checks the NaN guard on every step, both checkpoints, the resume at
     epoch 1, 6 + 6 MSDA and 2 Hungarian launches per step, no solver sync,
     no plain call, phase 9's sgdet key set; logs s per step and the
     loader's time for an epoch.
 14. serve full-width Pair-Net Swin-B (``flagship(backbone="swinb")``,
     800x1344, batch 8, bf16, int4 MSDA): 6 int4 quantize and 6 int4 gather
     launches per forward, no plain call, finite outputs, 100 pairs per
     image; the int4 kernels against their plain versions on this path's
     inputs; img/s, the spans of ``bench --breakdown``, the backbone's
     kernels by kind and the window attention's share (a profiler scope).
 15. an f32 Swin-B forward (batch 1, TF32 off) through the exact kernel
     against the same forward through the plain MSDA, as phase 4.
 16. score ``configs/pairnet/pairnet_swinb_psg.py`` with
     ``pairnet_torch.tools.test.main`` over phase 9's split, its class and
     predicate name lists extended to PSG's 133 and 56 (bf16, int4,
     sgdet, ``--save-results``: the numpy oracle, which resizes without
     PIL), then ``pairnet_torch.tools.vis_results.main`` on the pickle: one
     PNG per image, 3W + H wide (2W + H without a panoptic panel), with its
     ``.dot`` and ``.triplets.txt``; PIL never loaded.
 17. train ``pairnet_swinb_psg.py`` with ``pairnet_torch.tools.train.main``
     (its pipeline, batch 2, f32) for one epoch of 4 steps over phase 9's
     train images: the NaN guard, 6 + 6 MSDA and 2 Hungarian launches per
     step, no solver sync, no plain call; a parameter moved in every Swin
     stage and in a relative-position table; s per step.
 18. the attn, fc and direct configs, and ``conv_small`` / ``conv_base`` by
     ``model.bbox_head.mapper=...``, built by ``build_model`` at full width,
     serve a batch of 2 bf16 through int4: 6 + 6 launches, no plain call,
     finite outputs, 100 pairs per image.
Phases 19-21 use, besides this process, a group of 2 spawned ranks on the
same card (gloo: NCCL takes one rank a card; a test harness, never a path
the package picks), started at phase 19 and stopped after phase 21.
 19. ``pairnet_torch.tools.train.main`` under NCCL at world size 1 in the
     environment ``torchrun`` gives (default device ``cuda:LOCAL_RANK``),
     phase 13's setup for one epoch: its losses within ``TOL_TRAIN_REL`` of
     phase 13's, one checkpoint, 6 + 6 MSDA and 2 Hungarian launches a
     step. Then one f32 step of full-width R-50 (TF32 off, dropout off) on
     the 2 ranks, batch 1 each, against this process's world-1 step of the
     global batch of 2, whose attention masks, pair picks and targets the
     ranks replay for their rows: the losses and every MSDA gradient within
     phase 7's tolerance, the parameters equal on both ranks after the
     step. Then 3 bf16 steps, batch 2 a rank: s per step and the coalesced
     gradient all-reduce's ms (two ranks on one card: no scaling measured).
 20. ``pairnet_torch.tools.test.main`` under NCCL at world size 1: sgdet and
     PQ equal to phase 9's; then on the 2 ranks, each scoring 8 of the 16
     images: within 1e-6 of phase 9's on each rank, 6 + 6 int4 launches a
     rank. Random weights score 0, so then the same runners on head
     outputs planted from the split's GT (``planted_scoring``): sgdet R@20
     and PQ above 0, rank 0's shard alone more than 1e-3 off the whole, and
     the 2 ranks within 1e-6 of world 1.
 21. the full-width 6-layer encoder (f32, TF32 off) on the 800x1344 levels
     (S = 22050) split over the 2 ranks through
     ``parallel/spatial.py::sequence_parallel_encoder``: within
     ``TOL_FORWARD_REL`` of the sequential stack in this process; each rank
     6 exact launches at Q = S / 2 local queries against the gathered
     plane, and the exact kernel against its plain version at that Q.
Phases 22-24 drive the one-stage zoo (PSGTr, PSGFormer, the Mask2Former
baselines, PSGTr2, DETR4Seg), each built by ``build_model`` from its
published R-50 config with seeded random weights:
 22. serve each at 800x1344, batch 2, bf16, int4 MSDA where there is a
     pixel decoder (the baseline, its MyPSGFormerHead form, PSGTr2), then
     the head's post-processing: 6 + 6 int4 launches per forward there and
     none elsewhere, no plain call, finite outputs; ms per batch (CUDA
     events), the process's peak GiB and the peak above what was
     allocated before the forward, and PSGTr's ms split into backbone,
     transformer and mask branch. Then the baseline's f32 forward (batch 1, TF32 off)
     through the exact kernel against the plain MSDA within
     ``TOL_FORWARD_REL``, its reference route's attention masks replayed.
 23. the oracle's PIL-exact mask resize of 200 masks to 800x1333 on the
     card, bit-equal to the host's, both timed; then
     ``pairnet_torch.tools.test.main`` on ``psgtr_r50_psg.py`` and
     ``baseline_r50_psg.py`` over phase 9's split, bf16: sgdet (through the
     head's post-processing and the oracle, as the JAX CLI routes these
     heads, the masks resized on the card) then PQ; phase 9's key sets,
     finite values, img/s.
 24. ``pairnet_torch.tools.train.main`` on ``psgtr_r50_psg.py``,
     ``psgformer_r50_psg.py`` and ``baseline_seesaw_r50_psg.py`` (their
     pipeline, batch 2, f32) for one epoch of 2 steps over 4 synthetic
     800x1333 train images: the NaN guard, a checkpoint, 1 / 2 / 2
     Hungarian launches per step and 6 + 6 MSDA launches for the baseline,
     no solver sync, no plain call; s per step. Then the baseline's f32
     train step (batch 1, TF32 off) through the exact forward and the bwd2
     backward against the plain MSDA within ``TOL_TRAIN_REL`` (losses x
     max(1, |plain|), each MSDA gradient x its max), the kernel run's
     attention masks and Hungarian assignments replayed.
Phases 25-28 drive the box Pair-Net (``CrossHeadBBox`` on Deformable-DETR,
the VG / OIv6 / COCO configs), built by ``build_model`` from the
published configs at full width with seeded random weights:
 25. the MSDA kernels at the box head's geometry against their plain
     versions (phase 2's tolerances), batch 2, the neck's 4 levels at
     800x1344 (S = 22323), wide offsets: the encoder's Q = S, then the
     decoder's Q = 100 on 4-d box references spread up to 1.5 box sizes;
     the exact forward (f32, bf16 values), the int4 quantize and gather,
     the backward (f32, bf16, bf16_grad); ms and bound at each geometry.
 26. serve ``pairnet_r101_vg.py``, ``pairnet_rnext101_vg.py`` and
     ``cross_r50_oiv6.py`` (601 classes) at 800x1344, batch 2, bf16, int4:
     12 int4 quantize and 12 gather launches a forward, no plain call;
     finite outputs, boxes in [0, 1], 100 triplets per image; ms per batch
     and the R-101 model's ms by part. Then an f32 forward (batch 1, TF32
     off) through the exact kernel against the plain MSDA within
     ``TOL_FORWARD_REL``, the three discrete steps (proposal top-k, query
     re-rank, pair top-k) replayed, their decided ranks counted.
 27. ``pairnet_torch.tools.test.main`` on ``pairnet_r101_vg.py`` over phase
     9's 16 images read as a box-only VG split, batch 8, bf16 int4: sgdet
     with ``detection_method="bbox"``, JAX's key set, finite values, 12 + 12
     int4 launches a forward.
 28. ``pairnet_torch.tools.train.main`` on ``pairnet_r101_vg.py`` and the
     detection-only ``od_r101_vg.py`` (batch 2, f32) for one epoch of 2
     steps over phase 24's 4 train images: 12 exact forward and 12 bwd2
     launches and 2 Hungarian launches a step (the detection-only step's
     encoder matcher, 64 GT boxes against the 22323 proposals, through the
     long instance), no solver sync, no plain call; then the long
     instance on that step's own costs, equal to the plain loop's, with
     its ms, search steps, ns a step and cluster size (CTAs a problem);
     and each config's f32 step on a
     seeded batch of 2 split into forward, targets, loss, backward and
     optimizer (the device time of each phase's span under the profiler).
Phases 29-32 drive the two-stage family (``SceneGraphTwoStage`` with the
MOTIFS, IMP, GPS-Net and VCTree heads on a frozen Panoptic FPN), built by
``build_model`` from the published configs at full width with seeded
random weights:
 29. ``csrc/nms.cu`` against the plain sweep, keep masks equal: the RPN's
     geometry (2 images x 4,819 boxes, thr 0.7), the detections' (2 x 256
     with 80 class offsets, thr 0.5) and 3 x 300 boxes, with a quarter of
     the scores tied and pairs planted at IoU exactly 0.5 and 0.7; IoUs
     within 1e-6 of a threshold (off it) counted and refused. Then, after
     phase 30, the kernel on that phase's own RPN and detection calls: ms
     as the sum of its two kernels' times (the mask kernel and the sweep
     each launched alone behind a spin, each logged), as issued and spun, the plain
     sweep's ms, the sweep's barriers (one a 64-box block) beside the kept
     boxes, and the bound:
     the larger of the bytes (boxes and valid read, keep written) and the
     operations of the IoUs this run's sweep computes (each kept box
     against the later boxes still in play) at the f32 rate.
 30. sgdet served at 800x1344, batch 2: ``PanopticFPN`` R-50 (80 things,
     53 stuff, 256 proposals, 64 detections; f32; its seeded box
     classifier x8, regressions x0.1, mask logits x4) -> the fusion -> the
     head over all 4,032 pairs an image: MOTIFS bf16 and f32, IMP, GPS-Net
     and VCTree bf16, through the test CLI's own sgdet calls
     (``detector_segments`` with the detector loaded from a work dir,
     ``sgdet_batch``, ``make_twostage_apply_fn``, ``twostage_postprocess``);
     2 NMS launches a forward and no plain sweep; finite outputs; ms per
     batch, peak GiB and ms by part (CUDA events recorded by ``PartTimer``'s
     hooks on those calls' modules and methods); the fusion's operations on
     the card (a CUDA graph of it).
 31. ``pairnet_torch.tools.test.main`` on the MOTIFS predcls config
     (device and numpy engines), the IMP predcls config in sgcls mode (IMP
     classifies the GT boxes itself; the MOTIFS sgcls config raises, as
     it needs ``det_dists``, checked) and the MOTIFS sgdet config over 4
     synthetic 800x1333 test images, batch 2: JAX's key sets, finite
     values, 2 NMS launches a detector forward; img/s.
 32. ``pairnet_torch.tools.train.main`` on the MOTIFS and VCTree predcls
     configs (f32, batch 2) over phase 24's 4 train images, one epoch of 2
     steps, then ``--resume`` for a second: finite losses, a head
     parameter moved, every BatchNorm statistic unchanged; s per step.
Phase 33 drives the checkpoint bridge's reference leg:
 33. two checkpoints in mmcv's layout (``{"meta", "state_dict",
     "optimizer"}``) of the flagship ``pairnet_r50_psg.py`` at full width
     (seeded R-50): the port's ``state_dict()`` with ``num_batches_tracked``
     on every BatchNorm, and a Mask2Former one (the segmenter's keys only,
     under ``panoptic_head``). ``pairnet_torch.tools.train.main
     --load-from`` each for one epoch over phase 9's train images (f32,
     batch 2, 4 steps; the CLI's unit is the epoch): before the first step
     every tensor the file names equals the file's and every other one its
     seeded init (for Mask2Former: PPN and Relation Fusion); 6 + 6 MSDA and
     2 Hungarian launches a step, no plain call, finite losses. Then
     ``pairnet_torch.tools.test.main`` scores each work dir (bf16 sgdet,
     int4): phase 9's key set, finite values. Logged: each file's load
     time and s per step. The JAX orbax leg (``tools/export_orbax.py``,
     then ``pairnet_torch.tools.import_jax``) needs orbax, which the card's
     machine lacks: the CPU tests hold it.
Then one JSON line of kernels (with this path's entries, ``<name>@bbox``,
``hungarian_long@od`` and ``nms``), one of serving, one of training, one
of evaluation, one of the train CLI, one of Swin-B and the other heads
(``swin``), one of phases 19-21 (``parallel``), one of phases 22-24
(``zoo``), one of phases 25-28 (``bbox``), one of phases 29-32
(``twostage``), one of phase 33 (``bridge``), the card's name and power
limit, and the final line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

IMG = (800, 1344)
SHAPES = tuple((IMG[0] // s, IMG[1] // s) for s in (32, 16, 8))  # the encoder's levels
BATCH, CHECK_BATCH = 8, 2  # serving batch; batch of the kernel-vs-plain checks
DEVICE = "cuda:0"
H, D, P = 8, 32, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
# H100 SXM tensor cores, dense: bf16 products, and f32 as 3xTF32 (three
# TF32 products per f32 product) at a third of the TF32 rate
TC_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
TOL_EXACT_F32 = 1e-4  # max |kernel - plain|, f32 values
TOL_EXACT_BF16_REL = 1e-3  # max |kernel - plain| / max |plain|, bf16 values
TOL_FORWARD_REL = 1e-3  # phase 4: max |exact - plain| / max(1, max |plain|)
TOL_TRAIN_REL = 1e-3  # phase 7: losses within it x max(1, |plain|), each gradient x its max |plain|
TRAIN_BATCH, TRAIN_STEPS = 4, 3
# masked_attn: max |kernel - plain| / max(1, max |plain|). The two sum the
# f32 scores in another order (the kernel on tensor cores: exact bf16
# products, or 3xTF32 for f32; P.V with P in bf16 hi and lo parts), and a
# score's rounding error grows with its size: 3e-7 to 5e-7 on N(0, 1)
# inputs, up to 6.4e-5 on the decoder's, whose max |plain| is ~5 (measured
# on an H100)
TOL_FLASH = 1e-4
LQ = 100  # decoder queries
SCORE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs/pairnet/pairnet_r50_psg.py")
SWIN_CONFIG = os.path.join(os.path.dirname(SCORE_CONFIG), "pairnet_swinb_psg.py")
SCORE_SPLIT = ("data.dataset.data_root=", "data.dataset.synthetic={'num_images':24,"
               "'num_test':16,'height':800,'width':1333,'seed':3}")
SCORE_IMAGES = 16
# the metric keys of the JAX package's engines: SgdetAccumulator.summarize("sgdet")
# with phrdet, evaluate_pq, and the two keys tools/test.py adds
TOPKS = (20, 50, 100)
SGDET_KEYS = ({f"sgdet_recall_R@{k}" for k in TOPKS} | {f"sgdet_mean_recall_mR@{k}" for k in TOPKS}
              | {f"sgdet_group_{g}_R@{k}" for g in ("tt", "ts", "st", "ss") for k in TOPKS}
              | {f"phrdet_recall_R@{k}" for k in TOPKS}
              | {"sgdet_eval_time_s", "sgdet_images_per_s"})
PQ_KEYS = ({f"{g}_{m}" for g in ("All", "Things", "Stuff") for m in ("PQ", "SQ", "RQ", "n")}
           | {"PQ_eval_time_s", "PQ_images_per_s"})
# the backward's least work per in-plane corner and channel: one FMA for
# s_c = sum_d g*v, one multiply and one add for dvalue (dweights and dlocs
# are then per-corner sums over s_c); bf16_grad rounds each dvalue term too
BWD_OPS_PER_CORNER = {"exact": 4, "bf16_grad": 5}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run unless ``ok`` (not an ``assert``: it holds under -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class PartTimer:
    """CUDA-event spans of the named parts of a path, recorded by hooks on
    the path's own objects: forward pre/post hooks on modules, and wrappers
    on bound methods (an instance attribute over the class's) and on module
    functions. They record only between ``start`` and ``stop``; ``ms`` sums
    each part's spans. ``PartTimer(parent)`` records into the parent's
    spans and removes only its own hooks."""

    def __init__(self, parent=None):
        self.root = parent or self
        self.on, self.spans, self.undo = False, [], []

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, name, fn):
        root = self.root

        def timed(*a, **k):
            if not root.on:
                return fn(*a, **k)
            begin = root._event()
            out = fn(*a, **k)
            root.spans.append((name, begin, root._event()))
            return out

        return timed

    def method(self, name, obj, attr):
        setattr(obj, attr, self.wrap(name, getattr(obj, attr)))
        self.undo.append(lambda: delattr(obj, attr))

    def function(self, name, module, attr):
        orig = getattr(module, attr)
        setattr(module, attr, self.wrap(name, orig))
        self.undo.append(lambda: setattr(module, attr, orig))

    def modules(self, name, *mods):
        root = self.root
        for mod in mods:
            begins = []

            def pre(m, args, begins=begins):
                if root.on:
                    begins.append(root._event())

            def post(m, args, out, begins=begins):
                if root.on:
                    root.spans.append((name, begins.pop(), root._event()))

            self.undo += [mod.register_forward_pre_hook(pre).remove,
                          mod.register_forward_hook(post).remove]

    def start(self):
        self.spans.clear()
        self.on = True

    def stop(self):
        self.on = False

    def remove(self):
        while self.undo:
            self.undo.pop()()

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, begin, end in self.spans:
            out[name] = out.get(name, 0.0) + begin.elapsed_time(end)
        return out


def msda_inputs(B, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    S = sum(h * w for h, w in SHAPES)
    L = len(SHAPES)
    value = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    # wide: locations over [-0.6, 1.6], many bilinear corners off the plane
    locs = torch.rand((B, S, H, L, P, 2), generator=g, device=dev) * 2.2 - 0.6
    w = torch.rand((B, S, H, L, P), generator=g, device=dev)
    w = w / w.sum(dim=(-1, -2), keepdim=True)
    return value, locs, w


def flash_inputs(B, Lk, dtype, seed, dev):
    """q (B*H, LQ, D), k and v (B*H, Lk, D) of N(0, 1) entries; a head-shared
    mask (B, LQ, Lk) about half set, whole 1024-key spans masked in every
    7th row, and one live key in every row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B * H, n, D), generator=g, device=dev).to(dtype)
               for n in (LQ, Lk, Lk))
    mask = torch.rand((B, LQ, Lk), generator=g, device=dev) < 0.5
    mask[:, ::7, :1024] = True
    live = torch.randint(0, Lk, (B, LQ, 1), generator=g, device=dev)
    mask.scatter_(2, live, False)
    return q, k, v, mask


def inside_corners(locs, shapes=SHAPES):
    """Bilinear corners of ``locs`` (B, Q, H, L, P, 2) inside their level's
    plane (``shapes``): the taps whose work the backward has to do."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[..., lvl, :, 0] * w - 0.5)
        y0 = torch.floor(locs[..., lvl, :, 1] * h - 0.5)
        for dx in (0, 1):
            for dy in (0, 1):
                n += int(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)).sum())
    return n


def touched_rows(locs, shapes=SHAPES):
    """Distinct (image, token, head) value rows that the in-plane bilinear
    corners of ``locs`` (B, Q, H, L, P, 2) read: the rows a gather must
    fetch at least once, however many taps share them."""
    B, _, H = locs.shape[:3]
    b = torch.arange(B, device=locs.device).view(B, 1, 1, 1)
    hd = torch.arange(H, device=locs.device).view(1, 1, H, 1)
    S = sum(h * w for h, w in shapes)
    rows, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[..., lvl, :, 0] * w - 0.5).long()
        y0 = torch.floor(locs[..., lvl, :, 1] * h - 0.5).long()
        for dx in (0, 1):
            for dy in (0, 1):
                x, y = x0 + dx, y0 + dy
                inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                flat = (b * S + start + y * w + x) * H + hd
                rows.append(flat[inside])
        start += h * w
    return int(torch.unique(torch.cat(rows)).numel())


class Replay:
    """Records what ``fn`` returns in one run and hands it back, call by
    call, in a second run, counting the entries the second run's own result
    would have set otherwise (``diff(own, kept)``)."""

    def __init__(self, fn, diff):
        self.fn, self.diff, self.kept, self.replay, self.flips = fn, diff, [], None, 0

    def __call__(self, *args, **kwargs):
        own = self.fn(*args, **kwargs)
        if self.replay is None:
            self.kept.append(own)
            return own
        kept = next(self.replay)
        self.flips += self.diff(own, kept)
        return kept

    def start_replay(self):
        self.replay = iter(self.kept)


def decided_ranks(values, k, tol):
    s = torch.sort(values.double().flatten(), descending=True).values[: k + 1]
    gap = (s[:-1] - s[1:]).abs()
    before = torch.cat([gap.new_tensor([float("inf")]), gap[: k - 1]])
    return (before > tol) & (gap[:k] > tol)


# phases 19-21: a group of RANKS processes on cuda:0. NCCL takes one rank
# a card, so the group runs gloo, which takes CUDA tensors for every
# collective the port issues (a test harness: the package never picks a
# backend other than NCCL for CUDA)
RANKS = 2
RANK_TIMEOUT_S = 300
SP_SEED = 5


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class launcher_env:
    """The environment ``torchrun --nproc_per_node 1`` gives its process:
    world size 1, rank 0, local rank 0 and a rendezvous on localhost."""

    def __enter__(self):
        env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
        self.saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch_counts():
    """Every kernel wrapper's launch count."""
    from pairnet_torch.ops.deform_attn_bwd import deform_attn_bwd
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize
    from pairnet_torch.ops.hungarian import batched_hungarian

    return {"deform_attn_exact": deform_attn_exact.launches,
            "deform_attn_bwd": dict(deform_attn_bwd.launches),
            "int4_quantize": int4_quantize.launches, "int4_gather": int4_gather.launches,
            "hungarian": batched_hungarian.launches}


def zero_launch_counts():
    from pairnet_torch.ops.deform_attn_bwd import deform_attn_bwd
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize
    from pairnet_torch.ops.hungarian import batched_hungarian

    deform_attn_exact.launches = int4_quantize.launches = int4_gather.launches = 0
    batched_hungarian.launches = 0
    deform_attn_bwd.launches.clear()


def no_dropout(model):
    """The Relation Fusion FFN's dropout off: ranks draw their own masks."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def step_replays(model):
    """Replays of a train step's attention masks and pair picks on
    ``model`` and of its targets (``trainer.pairnet_targets``): a world-1
    run records them, each rank replays its rows."""
    from pairnet_torch.train import trainer as trainer_mod

    dec, head = model.bbox_head.transformer_decoder, model.bbox_head
    masks = Replay(lambda *a: type(dec).attn_mask_small(dec, *a),
                   lambda own, kept: int((own != kept).sum()))
    pairs = Replay(lambda imp: type(head).pair_topk(head, imp),
                   lambda own, kept: sum(int((o != k).sum()) for o, k in zip(own, kept)))
    fields = ("r_labels", "r_weights", "sub_ids", "obj_ids", "gt_importance", "query2gt")
    targets = Replay(trainer_mod.pairnet_targets, lambda own, kept: sum(
        int((getattr(own, f) != getattr(kept, f)).sum()) for f in fields))
    dec.attn_mask_small, head.pair_topk = masks, pairs
    return {"masks": masks, "pairs": pairs, "targets": targets}


def batch_rows(x, rows):
    """Rows ``rows`` of a recorded value: a tensor, or a (named) tuple of them."""
    if torch.is_tensor(x):
        return x[rows]
    vals = [batch_rows(v, rows) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def encoder_stack(dev, seq_group=None):
    """The pixel decoder's 6 encoder layers at full width (256 channels, 8
    heads, 3 levels, 4 points, FFN 1024), seeded, deformable kernels
    perturbed; split over ``seq_group`` when given."""
    from pairnet_torch.flagship import init_weights, perturb_deform_kernels
    from pairnet_torch.models.necks.pixel_decoder import DeformableEncoderLayer

    with torch.device("meta"):
        stack = torch.nn.ModuleList([DeformableEncoderLayer(256, H, len(SHAPES), P, 1024,
                                                            seq_group=seq_group)
                                     for _ in range(6)])
    stack = stack.to_empty(device=dev)
    init_weights(stack, SP_SEED)
    return perturb_deform_kernels(stack, SP_SEED)


def encoder_inputs(dev):
    from pairnet_torch.models.layers import encoder_reference_points

    S = sum(h * w for h, w in SHAPES)
    g = torch.Generator(device=dev).manual_seed(SP_SEED)
    tokens = torch.randn((1, S, 256), generator=g, device=dev)
    pos = torch.randn((1, S, 256), generator=g, device=dev) * 0.1
    return tokens, pos, encoder_reference_points(SHAPES, device=dev)[None]


def rank_dp_step(rank, world, replay_path, batch_size):
    """One f32 step (TF32 off) of full-width R-50 on this rank's rows of the
    global batch, replaying the world-1 run's masks, pair picks and targets
    of those rows: the global losses, the MSDA gradients, whether the
    parameters equal rank 0's after the step, the replayed differences and
    the launches."""
    import torch.distributed as dist

    from pairnet_torch.bench import train_batch, train_setup
    from pairnet_torch.models.layers import MSDeformAttention
    from pairnet_torch.parallel.mesh import rank_rows
    from pairnet_torch.train import trainer as trainer_mod
    from pairnet_torch.train.trainer import to_device

    dev = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kept = torch.load(replay_path, map_location=dev, weights_only=False)
    model, state, step = train_setup(dev, compute_dtype=None)
    no_dropout(model)
    replays = step_replays(model)
    rows = slice(rank * batch_size, (rank + 1) * batch_size)
    for name, r in replays.items():
        r.kept = [batch_rows(x, rows) for x in kept[name]]
        r.start_replay()
    batch = to_device(rank_rows(train_batch(batch_size * world, IMG), rank, world), dev)
    orig = trainer_mod.pairnet_targets
    trainer_mod.pairnet_targets = replays["targets"]
    zero_launch_counts()
    try:
        metrics = step(state, batch)
    finally:
        trainer_mod.pairnet_targets = orig
    torch.cuda.synchronize()
    launches = launch_counts()
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    grads = {f"{n}.{pn}": p.grad.detach().cpu() for n, m in model.named_modules()
             if isinstance(m, MSDeformAttention) for pn, p in m.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params_equal_rank0": bool(torch.equal(flat, ref)), "launches": launches,
            "replayed": {k: r.flips for k, r in replays.items()}}


def rank_bf16_steps(rank, world, batch_size, steps):
    """bf16 training at ``batch_size`` a rank: a warm-up, then ``steps``
    steps timed (host clock, synchronised); then the coalesced gradient
    all-reduce alone, timed three times."""
    from pairnet_torch.bench import train_batch, train_setup
    from pairnet_torch.parallel.mesh import all_reduce_coalesced, rank_rows
    from pairnet_torch.train.trainer import to_device

    dev = torch.device(DEVICE)
    model, state, step = train_setup(dev)
    batch = to_device(rank_rows(train_batch(batch_size * world, IMG), rank, world), dev)
    step(state, batch)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch) for _ in range(steps)]
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / steps
    launches = launch_counts()
    grads = [p.grad for p in model.parameters()]
    ar_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_coalesced(grads)
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t0) * 1e3)
    return {"s_per_step": s_per_step, "all_reduce_ms": ar_ms, "launches": launches,
            "grad_bytes": sum(g.numel() * g.element_size() for g in grads),
            "losses": [{k: float(v) for k, v in m.items()} for m in metrics]}


def rank_score(rank, world, config, split_opts, batch_size):
    """``pairnet_torch.tools.test.main`` (sgdet, then PQ) on this rank's
    shard of the split, bf16, the default int4 MSDA."""
    from pairnet_torch.tools import test as cli

    out = {}
    for what in ("sgdet", "PQ"):
        torch.cuda.synchronize()
        zero_launch_counts()
        metrics = cli.main([config, "--eval", what, "--batch-size", str(batch_size), "--dtype",
                            "bf16", "--device", DEVICE, "--cfg-options", *split_opts])
        torch.cuda.synchronize()
        out[what] = {"metrics": metrics, "launches": launch_counts()}
    return out


def planted_scoring(rank=0, world=1, shard_of=None):
    """sgdet (the device engine) and PQ of phase 9's test split with head
    outputs planted from each image's ground truth in place of a model's,
    so that the metrics score above 0 and differ between images (random
    weights score 0 everywhere, which a dropped or doubled image leaves
    at 0). Per image, seeded by its index: two of every three GT relations
    (from a per-image offset) as a pair with the GT labels, predicate and
    masks (+-8 logits), the rest random; the fusion queries carry the GT
    segments, every fourth dropped. Every process plants the whole split
    (keyed by the hash of the loader's image); the runners then score this
    rank's shard and merge over the group. ``shard_of=(r, n)`` scores
    shard r of n alone at world size 1."""
    import hashlib

    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.data.pipeline import Loader
    from pairnet_torch.data.sg import shard
    from pairnet_torch.evaluation import runner
    from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess
    from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg

    cfg = apply_overrides(load_config(SCORE_CONFIG), list(SCORE_SPLIT))
    split = build_dataset(cfg, "test")
    pipe_cfg = build_pipeline_cfg(cfg, train=False)
    C1, NR, K, Q = cfg.num_object_classes + 1, cfg.num_relation_classes, 10, 8

    def key(image):
        return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()

    planted = {}
    for i, batch in enumerate(Loader(split, pipe_cfg, 1)):
        rng = np.random.default_rng([4, i])
        _, _, h4, w4 = batch["gt_masks"].shape
        out = {"sub": rng.normal(size=(1, K, C1)), "obj": rng.normal(size=(1, K, C1)),
               "rel": rng.normal(size=(1, K, NR)),
               "sub_seg": rng.normal(size=(1, K, h4, w4)) - 4,
               "obj_seg": rng.normal(size=(1, K, h4, w4)) - 4,
               "cls": rng.normal(size=(1, Q, C1)), "mask": rng.normal(size=(1, Q, h4, w4))}
        gm, gl = batch["gt_masks"][0], batch["gt_labels"][0]
        skip = int(rng.integers(3))
        for j, (s_, o_, p_) in enumerate(batch["gt_rels"][0][batch["rel_valid"][0]][:K]):
            if j % 3 == skip:
                continue
            out["sub"][0, j, gl[s_]] += 10
            out["obj"][0, j, gl[o_]] += 10
            out["rel"][0, j, p_ - 1] += 10
            out["sub_seg"][0, j] = np.where(gm[s_], 8.0, -8.0)
            out["obj_seg"][0, j] = np.where(gm[o_], 8.0, -8.0)
        for q in range(min(Q, int(batch["gt_valid"][0].sum()))):
            if q % 4 != 3:
                out["cls"][0, q, gl[q]] += 10
                out["mask"][0, q] = np.where(gm[q], 8.0, -8.0)
        planted[key(batch["image"][0])] = {k: v.astype(np.float32) for k, v in out.items()}
    pad = next(iter(planted.values()))  # a padded row of a batch (not scored)

    def apply_fn(images):
        outs = [planted.get(key(img), pad) for img in images]
        return {k: torch.from_numpy(np.concatenate([o[k] for o in outs])).to(DEVICE)
                for k in outs[0]}

    if shard_of is not None:
        split = shard(split, *shard_of)
    num_things = cfg.evaluation.num_things
    return {"sgdet": runner.evaluate_model_device(
                apply_fn, split, pipe_cfg, batch_size=BATCH, num_predicates=NR,
                num_things=num_things, iou_thr=cfg.evaluation.get("iou_thr", 0.5)),
            "PQ": runner.evaluate_pq(apply_fn, pairnet_postprocess, split, pipe_cfg,
                                     batch_size=BATCH, num_classes=cfg.num_object_classes,
                                     num_things=num_things)}


def rank_sp_encoder(rank, world):
    """The full-width encoder stack with its tokens split over the group, f32
    (TF32 off): the output (rank 0 returns it), the launches, and the exact
    kernel against its plain version on layer 0's inputs at the local
    queries."""
    import torch.distributed as dist

    from pairnet_torch.models import layers as layers_mod
    from pairnet_torch.ops.deform_attn import ms_deform_attn_plain
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.parallel.spatial import sequence_parallel_encoder

    dev = torch.device(DEVICE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    group = dist.group.WORLD
    stack = encoder_stack(dev, seq_group=group)
    tokens, pos, ref = encoder_inputs(dev)
    captured = []
    orig = layers_mod.ms_deform_attn

    def capturing(value, shapes, locs, weights, **kw):
        if not captured:
            captured.append(tuple(t.detach().clone() for t in (value, locs, weights)))
        return orig(value, shapes, locs, weights, **kw)

    layers_mod.ms_deform_attn = capturing
    zero_launch_counts()
    try:
        with torch.no_grad():
            out = sequence_parallel_encoder(stack, tokens, pos, ref, SHAPES, group)
        torch.cuda.synchronize()
    finally:
        layers_mod.ms_deform_attn = orig
    launches = launch_counts()
    v, lc, wt = captured[0]
    err = float((deform_attn_exact(v, SHAPES, lc, wt)
                 - ms_deform_attn_plain(v, SHAPES, lc, wt)).abs().max())
    return {"out": out.cpu() if rank == 0 else None, "launches": launches,
            "exact_vs_plain": err, "value_tokens": v.shape[1], "local_queries": lc.shape[1]}


RANK_TASKS = {"dp_step": rank_dp_step, "bf16_steps": rank_bf16_steps, "score": rank_score,
              "planted_score": planted_scoring, "sp_encoder": rank_sp_encoder}


def rank_main(rank, world, store, tasks, results):
    """A rank of the group: join it, then run the parent's tasks in order
    until told to stop; a failure is sent back and ends the rank."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN"):
        os.environ.pop(k, None)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        while True:
            name, kwargs = tasks.get()
            if name == "stop":
                return
            try:
                results.put((rank, True, RANK_TASKS[name](rank, world, **kwargs)))
            except Exception:  # noqa: BLE001 - sent to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
                return
    finally:
        dist.destroy_process_group()


class RankGroup:
    """RANKS processes on cuda:0 in one gloo group (spawned, daemonic), each
    running the tasks :meth:`run` sends; :meth:`close` stops them."""

    def __init__(self, store_dir):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.tasks = [ctx.Queue() for _ in range(RANKS)]
        self.results = ctx.Queue()
        store = os.path.join(store_dir, "store")
        self.procs = [ctx.Process(target=rank_main, args=(r, RANKS, store, self.tasks[r],
                                                          self.results), daemon=True)
                      for r in range(RANKS)]
        for p in self.procs:
            p.start()

    def run(self, name, **kwargs):
        """Each rank's result of task ``name``, in rank order."""
        import queue

        for q in self.tasks:
            q.put((name, kwargs))
        got = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(got) < RANKS:
            try:
                rank, ok, out = self.results.get(timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(f"two-rank task {name}: no result from ranks "
                                   f"{sorted(set(range(RANKS)) - set(got))} in "
                                   f"{RANK_TIMEOUT_S} s") from None
            if not ok:
                raise RuntimeError(f"two-rank task {name} failed on rank {rank}:\n{out}")
            got[rank] = out
        return [got[r] for r in range(RANKS)]

    def close(self):
        for q in self.tasks:
            q.put(("stop", {}))
        for p in self.procs:
            p.join(30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def parallel_phases(smi, tf32, ref13, p9, score, int4_expect, launches, reset_launches,
                    count_plain_calls):
    """Phases 19-21 (see the module doc): ``ref13`` is phase 13's first
    run's losses, ``p9`` phase 9's sgdet and PQ metrics, ``tf32`` the TF32
    flags to restore; ``score``, ``launches``, ``reset_launches`` and
    ``count_plain_calls`` are main's helpers. Returns the ``parallel``
    JSON entry."""
    import shutil

    import torch.distributed as dist

    from pairnet_torch.bench import train_batch, train_setup
    from pairnet_torch.models.layers import MSDeformAttention
    from pairnet_torch.ops.hungarian import batched_hungarian
    from pairnet_torch.parallel import mesh as mesh_mod
    from pairnet_torch.tools import train as train_cli
    from pairnet_torch.train import trainer as trainer_mod
    from pairnet_torch.train.trainer import to_device

    dev = torch.device(DEVICE)

    t_parallel = time.perf_counter()
    inits = []  # (backend, world, device) of each process group the CLIs made
    orig_init = mesh_mod.init_distributed

    def recording_init(*a, **k):
        out = orig_init(*a, **k)
        inits.append((dist.get_backend() if dist.is_initialized() else None, out[1], str(out[2])))
        return out

    def metric_diff(got, want):
        keys = {k for k in want if not k.endswith(("_eval_time_s", "_images_per_s"))}
        check(keys <= set(got), f"metric keys {sorted(keys - set(got))} missing")
        return max(abs(got[k] - want[k]) for k in keys)

    torch.cuda.empty_cache()
    mesh_mod.init_distributed = recording_init
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    group = RankGroup(store_dir)  # the ranks start up while the world-1 runs go
    saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN",
                                                  "PAIRNET_DEBUG_NANS")}
    try:
        # --- (19) train, data parallel ---
        os.environ["PAIRNET_DEBUG_NANS"] = "1"
        work = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
        try:
            torch.cuda.synchronize()
            reset_launches()
            syncs0 = batched_hungarian.syncs
            count_plain_calls(True)
            try:
                with launcher_env():
                    summary = train_cli.main([SCORE_CONFIG, "--work-dir", work, "--max-epochs",
                                              "1", "--cfg-options", *SCORE_SPLIT])
            finally:
                count_plain_calls(False)
            torch.cuda.synchronize()
            ckpts19 = sorted(os.listdir(os.path.join(work, "ckpts")))
        finally:
            shutil.rmtree(work, ignore_errors=True)
            os.environ.pop("PAIRNET_DEBUG_NANS", None)
        got, steps = launches(), summary["steps"]
        check(inits[-1] == ("nccl", 1, DEVICE), f"train CLI process group {inits[-1]}")
        check(not dist.is_initialized(), "the train CLI left its process group")
        want = {"deform_attn_exact": 6 * steps, "int4": 0, "deform_attn_bwd": {"f32": 6 * steps},
                "hungarian": 2 * steps, "plain": {}}
        check((summary["world"], steps) == (1, 4) and got == want,
              f"NCCL world-1 train CLI: world {summary['world']}, {steps} steps, launches {got}")
        check(batched_hungarian.syncs == syncs0, "the Hungarian synced with the host")
        check(ckpts19 == ["epoch_1.pt"], f"checkpoints {ckpts19}")
        cli19_err = {k: abs(summary["last"][k] - v) for k, v in ref13.items()}
        for k, v in ref13.items():
            check(cli19_err[k] <= TOL_TRAIN_REL * max(1.0, abs(v)),
                  f"NCCL world-1 train CLI {k}: {summary['last'][k]} vs phase 13's {v}")
        cli19_s = summary["seconds"] / steps
        log(f"[19] {smi}: train CLI under NCCL at world size 1 (launcher environment, default "
            f"device {inits[-1][2]}), {os.path.relpath(SCORE_CONFIG)} as phase 13: {steps} steps, "
            f"{cli19_s:.3f} s per step, launches {got}, checkpoints {ckpts19}; losses vs phase "
            f"13's max|d| {max(cli19_err.values()):.3g} (tol {TOL_TRAIN_REL} x max(1, |ref|))")

        # the world-1 f32 step over the global batch (TF32 off), recording
        # its masks, pair picks and targets for the ranks to replay
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model_w, state_w, step_w = train_setup(dev, compute_dtype=None)
        no_dropout(model_w)
        replays = step_replays(model_w)
        orig_targets = trainer_mod.pairnet_targets
        trainer_mod.pairnet_targets = replays["targets"]
        try:
            m_w1 = {k: float(v) for k, v in
                    step_w(state_w, to_device(train_batch(RANKS, IMG), dev)).items()}
        finally:
            trainer_mod.pairnet_targets = orig_targets
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        g_w1 = {f"{n}.{pn}": p.grad.detach().clone() for n, m in model_w.named_modules()
                if isinstance(m, MSDeformAttention) for pn, p in m.named_parameters()}
        replay_path = os.path.join(store_dir, "replay.pt")
        torch.save({k: r.kept for k, r in replays.items()}, replay_path)
        del model_w, state_w, step_w, replays
        torch.cuda.empty_cache()
        dp = group.run("dp_step", replay_path=replay_path, batch_size=1)
        check(dp[0]["metrics"] == dp[1]["metrics"], "the ranks' global losses differ")
        dp_loss_err, dp_grad_rel = {}, 0.0
        for k, ref in m_w1.items():
            dp_loss_err[k] = abs(dp[0]["metrics"][k] - ref)
            check(dp_loss_err[k] <= TOL_TRAIN_REL * max(1.0, abs(ref)),
                  f"two-rank step {k}: {dp[0]['metrics'][k]} vs world-1 {ref}")
        check(len(g_w1) == 48 and set(dp[0]["grads"]) == set(g_w1), "MSDA gradients")
        for k, ref in g_w1.items():
            for r in dp:
                d = float((r["grads"][k].to(dev) - ref).abs().max())
                scale = float(ref.abs().max())
                dp_grad_rel = max(dp_grad_rel, d / max(scale, 1e-30))
                check(d <= TOL_TRAIN_REL * scale,
                      f"two-rank step grad {k}: max|d| {d} (max {scale})")
        for rank, r in enumerate(dp):
            check(r["params_equal_rank0"], f"rank {rank}'s parameters differ from rank 0's")
            check(r["launches"] == {"deform_attn_exact": 6, "deform_attn_bwd": {"f32": 6},
                                    "int4_quantize": 0, "int4_gather": 0, "hungarian": 2},
                  f"rank {rank} step launches {r['launches']}")
        log(f"[19] {smi}: two ranks on {DEVICE} (gloo; a harness: NCCL takes one rank a card), "
            f"one f32 step of full-width R-50, batch 1 a rank, TF32 off, against the world-1 step "
            f"of the global batch 2: losses max|d| {max(dp_loss_err.values()):.3g}, 48 MSDA "
            f"gradients within {dp_grad_rel:.3g} of their max (tol {TOL_TRAIN_REL}), parameters "
            f"equal on both ranks after the step; replayed from the world-1 run "
            f"{[r['replayed'] for r in dp]}; launches a rank {dp[0]['launches']}")
        bf = group.run("bf16_steps", batch_size=2, steps=TRAIN_STEPS)
        for rank, r in enumerate(bf):
            n = TRAIN_STEPS
            check(r["launches"] == {"deform_attn_exact": 6 * n, "deform_attn_bwd": {"bf16": 6 * n},
                                    "int4_quantize": 0, "int4_gather": 0, "hungarian": 2 * n},
                  f"rank {rank} bf16 launches {r['launches']}")
            check(all(math.isfinite(v) for m in r["losses"] for v in m.values()),
                  f"rank {rank} bf16 losses")
        check(bf[0]["losses"] == bf[1]["losses"], "the ranks' bf16 losses differ")
        log(f"[19] {smi}: two ranks sharing one card (not a scaling measurement), bf16, batch 2 "
            f"a rank (global 4), {TRAIN_STEPS} steps: s per step "
            f"{[round(r['s_per_step'], 3) for r in bf]}; the coalesced gradient all-reduce alone "
            f"({bf[0]['grad_bytes'] / 2 ** 20:.1f} MiB, gloo through the host) ms "
            f"{[[round(t, 1) for t in r['all_reduce_ms']] for r in bf]}; launches a rank "
            f"{bf[0]['launches']}")

        # --- (20) score, sharded ---
        score20 = {}
        for what in ("sgdet", "PQ"):
            with launcher_env():
                m20, _, pf20 = score(what, {}, device=None)
            check(inits[-1] == ("nccl", 1, DEVICE), f"test CLI process group {inits[-1]}")
            check(pf20 == int4_expect, f"NCCL world-1 {what} launches per forward {pf20}")
            check(metric_diff(m20, p9[what]) == 0, f"NCCL world-1 {what} differs from phase 9's")
            score20[what] = {"world1": m20}
        sc = group.run("score", config=SCORE_CONFIG, split_opts=list(SCORE_SPLIT),
                       batch_size=BATCH)
        for what in ("sgdet", "PQ"):
            for rank, r in enumerate(sc):
                d = metric_diff(r[what]["metrics"], p9[what])
                check(d <= 1e-6, f"two-rank {what} on rank {rank}: {d} from phase 9's")
                check(r[what]["launches"]["int4_quantize"] == 6
                      and r[what]["launches"]["int4_gather"] == 6
                      and r[what]["launches"]["deform_attn_exact"] == 0,
                      f"two-rank {what} rank {rank} launches {r[what]['launches']}")
            score20[what]["two_ranks"] = [r[what]["metrics"] for r in sc]
        log(f"[20] {smi}: test CLI under NCCL at world size 1: sgdet and PQ equal phase 9's "
            f"({score20['sgdet']['world1']['sgdet_images_per_s']} / "
            f"{score20['PQ']['world1']['PQ_images_per_s']} img/s); two ranks over disjoint shards "
            f"of {SCORE_IMAGES // RANKS} images: within 1e-6 of phase 9's on each rank; launches "
            f"a rank {sc[0]['sgdet']['launches']}")
        # random weights score 0, which hides a dropped or doubled image: the
        # same runners on outputs planted from the GT, which score above 0
        pl1 = planted_scoring()
        pl_half = planted_scoring(shard_of=(0, RANKS))
        headline = {"sgdet": "sgdet_recall_R@20", "PQ": "All_PQ"}
        for what, k in headline.items():
            check(pl1[what][k] > 0, f"planted {what} scores {k} = {pl1[what][k]}")
        half_d = {w: metric_diff(pl_half[w], pl1[w]) for w in headline}
        check(min(half_d.values()) > 1e-3, f"planted shard 0 alone departs from the whole "
              f"split by only {half_d}")
        pl2 = group.run("planted_score")
        planted_d = max(metric_diff(r[w], pl1[w]) for r in pl2 for w in headline)
        check(planted_d <= 1e-6, f"two-rank planted scoring {planted_d} from world 1's")
        score20["planted"] = {"world1": pl1, "shard0_alone": pl_half,
                              "two_ranks_max_abs_err": planted_d}
        log(f"[20] {smi}: outputs planted from the GT: world 1 sgdet R@20 "
            f"{pl1['sgdet']['sgdet_recall_R@20']:.6f}, mR@20 "
            f"{pl1['sgdet']['sgdet_mean_recall_mR@20']:.6f}, PQ {pl1['PQ']['All_PQ']:.6f}; shard "
            f"0 alone departs from them by up to {half_d} (so a dropped or doubled image "
            f"shows); two ranks within {planted_d:.3g} of world 1 (tol 1e-6)")

        # --- (21) the sequence-parallel encoder ---
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        stack = encoder_stack(dev)
        tokens, pos, ref = encoder_inputs(dev)
        with torch.no_grad():
            want = tokens
            for layer in stack:
                want = layer(want, pos, ref, SHAPES)
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        sp = group.run("sp_encoder")
        sp_err = float((sp[0]["out"].to(dev) - want).abs().max())
        sp_bound = TOL_FORWARD_REL * max(1.0, float(want.abs().max()))
        check(sp_err <= sp_bound, f"sp encoder vs sequential: max|d| {sp_err} > {sp_bound}")
        S = want.shape[1]
        for rank, r in enumerate(sp):
            check(r["launches"]["deform_attn_exact"] == 6, f"rank {rank} sp launches")
            check((r["value_tokens"], r["local_queries"]) == (S, S // RANKS),
                  f"rank {rank}: value plane {r['value_tokens']}, queries {r['local_queries']}")
            check(r["exact_vs_plain"] <= TOL_EXACT_F32,
                  f"rank {rank}: exact vs plain at local Q {r['exact_vs_plain']}")
        del stack, tokens, pos, ref, want
        log(f"[21] {smi}: full-width 6-layer encoder on the {IMG[0]}x{IMG[1]} levels (S = {S}) "
            f"split over 2 ranks (Q = {S // RANKS} local queries against the gathered plane), "
            f"f32, TF32 off: max|d| vs the sequential stack {sp_err:.3g} (tol {TOL_FORWARD_REL} x "
            f"max(1, max|seq|)); exact kernel vs plain at local Q "
            f"{[round(r['exact_vs_plain'], 9) for r in sp]} (tol {TOL_EXACT_F32}); 6 exact "
            f"launches a rank")
    finally:
        group.close()
        mesh_mod.init_distributed = orig_init
        shutil.rmtree(store_dir, ignore_errors=True)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    parallel_s = time.perf_counter() - t_parallel
    log(f"[21] phases 19-21 took {parallel_s:.1f} s")
    return {
        "card": smi, "seconds": parallel_s,
        "train_cli_nccl_world1": {"steps": steps, "s_per_step": cli19_s,
                                  "losses": summary["last"], "loss_max_abs_err_vs_phase13":
                                      max(cli19_err.values())},
        "dp_f32_step_two_ranks": {"loss_max_abs_err": max(dp_loss_err.values()),
                                  "msda_grad_max_rel_err": dp_grad_rel,
                                  "replayed": [r["replayed"] for r in dp]},
        "dp_bf16_two_ranks_one_card": {"batch_per_rank": 2, "s_per_step":
                                       [r["s_per_step"] for r in bf],
                                       "all_reduce_ms": [r["all_reduce_ms"] for r in bf],
                                       "grad_bytes": bf[0]["grad_bytes"]},
        "score": score20,
        "sp_encoder": {"tokens": S, "ranks": RANKS, "max_abs_err": sp_err,
                       "exact_vs_plain_local_q": [r["exact_vs_plain"] for r in sp]},
    }



ZOO_DIR = os.path.dirname(os.path.dirname(SCORE_CONFIG))
ZOO_CONFIGS = {  # phase 22: every head of the one-stage zoo, R-50
    "psgtr": ("psgtr/psgtr_r50_psg.py", []),
    "psgformer": ("psgformer/psgformer_r50_psg.py", []),
    "baseline": ("baseline/baseline_r50_psg.py", []),
    "mypsgformer": ("baseline/baseline_r50_psg.py", ["model.bbox_head.type=MyPSGFormerHead",
                                                     "model.bbox_head.temp=0.1"]),
    "psgtr2": ("psgtr/psgtr2_r50_psg_plus.py", []),
    "detr4seg": ("detr4seg/detr4seg_r50_psg.py", []),
}
ZOO_MSDA = ("baseline", "mypsgformer", "psgtr2")  # the heads on the MSDA pixel decoder
ZOO_SCORE = ("psgtr/psgtr_r50_psg.py", "baseline/baseline_r50_psg.py")  # phase 23
ZOO_TRAIN = {"psgtr/psgtr_r50_psg.py": 1, "psgformer/psgformer_r50_psg.py": 2,  # phase 24:
             "baseline/baseline_seesaw_r50_psg.py": 2}  # config -> Hungarian calls per step
# 4 train images at 800x1333: one epoch of 2 steps at batch 2
ZOO_TRAIN_SPLIT = ("data.dataset.data_root=", "data.dataset.synthetic={'num_images':6,"
                   "'num_test':2,'height':800,'width':1333,'seed':4}")


class HeadMaskReplay(Replay):
    """Replays only the attention masks of the reference route's
    prediction head (its third output); its cls and mask logits stay the
    run's own, which carry the gradients."""

    def __call__(self, *args, **kwargs):
        own = self.fn(*args, **kwargs)
        if self.replay is None:
            self.kept.append(own[2])
            return own
        kept = next(self.replay)
        self.flips += int((own[2] != kept).sum())
        return (own[0], own[1], kept)


def psgtr_breakdown(model, images, cuda_ms):
    """Where a PSGTr forward's time goes (CUDA events, each part alone on
    the inputs the forward gives it): the backbone, the DETR transformer
    with the class and box heads, and the mask branch (attention maps and
    the mask head, subject and object)."""
    from pairnet_torch.models.heads.psgtr_head import detr_tokens, mask_branch

    head = model.bbox_head
    x = images.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        feats = model.backbone(x)
        proj = head.input_proj(feats[-1])
        (outs,), memory = head.transformer(*detr_tokens(proj), head.query_embed.weight)

        def backbone():
            model.backbone(x)

        def whole_head():
            head(feats)

        def masks():
            for side in ("sub", "obj"):
                mask_branch(proj, memory, outs[-1], getattr(head, f"{side}_bbox_attention"),
                            getattr(head, f"{side}_mask_head"), feats)

        parts = {"backbone": cuda_ms(torch, backbone, 3), "head": cuda_ms(torch, whole_head, 3),
                 "mask_branch": cuda_ms(torch, masks, 3)}
    parts["transformer_and_heads"] = parts["head"] - parts["mask_branch"]
    return parts


def zoo_phases(smi, tf32, score, int4_expect, launches, reset_launches, count_plain_calls):
    """Phases 22-24 (see the module doc): the one-stage zoo served, scored
    and trained at full width. ``score``, ``launches``, ``reset_launches``
    and ``count_plain_calls`` are main's helpers, ``int4_expect`` phase 9's
    launches per forward, ``tf32`` the TF32 flags to restore. Returns the
    ``zoo`` JSON entry."""
    import shutil

    from pairnet_torch.bench import train_batch
    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.flagship import perturb_deform_kernels, set_deform_impl
    from pairnet_torch.models import matchers as matchers_mod
    from pairnet_torch.models.frameworks.psgtr import build_model
    from pairnet_torch.models.heads import baseline_head as baseline_mod
    from pairnet_torch.models.layers import MSDeformAttention
    from pairnet_torch.ops import hungarian as hungarian_mod
    from pairnet_torch.ops.hungarian import (
        batched_hungarian,
        solve_n_le_m_cuda,
        solve_n_le_m_plain_steps,
    )
    from pairnet_torch.tools import train as train_cli
    from pairnet_torch.tools.msda_kernels import cuda_ms
    from pairnet_torch.train.dispatch import get_postprocess_fn
    from pairnet_torch.train.optim import build_optimizer
    from pairnet_torch.train.trainer import TrainState, make_train_step, to_device

    dev = torch.device(DEVICE)
    t_zoo = time.perf_counter()
    h4, w4 = IMG[0] // 4, IMG[1] // 4

    def zoo_model(name, dtype):
        path, opts = ZOO_CONFIGS[name]
        cfg = apply_overrides(load_config(os.path.join(ZOO_DIR, path)), opts)
        model = perturb_deform_kernels(build_model(cfg.model, device=dev)).to(dtype)
        return model, cfg.model.bbox_head.type

    # --- (22) serving the zoo at full width, bf16, int4 where there is MSDA ---
    g = torch.Generator(device=dev).manual_seed(22)
    images = torch.randn((2, *IMG, 3), generator=g, device=dev)
    served = {}
    for name in ZOO_CONFIGS:
        model, head = zoo_model(name, torch.bfloat16)
        set_deform_impl(model, "int4")
        post = get_postprocess_fn(head)
        imgs = images.to(torch.bfloat16)

        def serve_zoo():
            with torch.inference_mode():
                out = model(imgs)
                return out, [post(out, b) for b in range(imgs.shape[0])]

        serve_zoo()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()  # the weights and what earlier phases hold
        reset_launches()
        count_plain_calls(True)
        out, preds = serve_zoo()
        torch.cuda.synchronize()
        count_plain_calls(False)
        got = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        forward_peak = peak - resident / 2 ** 30
        n_int4 = 12 if name in ZOO_MSDA else 0
        check(got == {"deform_attn_exact": 0, "int4": n_int4, "deform_attn_bwd": {},
                      "hungarian": 0, "plain": {}}, f"{name} serving launches {got}")
        for key, val in out.items():
            if torch.is_tensor(val):
                check(bool(torch.isfinite(val.float()).all()), f"{name}: {key} finite")
        check(out["rel" if head != "Detr4SegHead" else "cls"].shape[1] == 100,
              f"{name}: 100 queries")
        for key in ("sub_seg", "mask"):
            if key in out:
                check(tuple(out[key].shape[-2:]) == (h4, w4), f"{name}: {key} at stride 4")
        check(len(preds) == 2 and all(tuple(p.labels.shape) == (200,)
                                      and tuple(p.pan_seg.shape) == (h4, w4) for p in preds),
              f"{name}: predictions")
        ms = cuda_ms(torch, serve_zoo, 3)
        served[name] = {"config": ZOO_CONFIGS[name][0], "cfg_options": ZOO_CONFIGS[name][1],
                        "ms_per_batch_of_2": ms, "peak_gib": peak,
                        "forward_peak_gib": forward_peak, "msda_launches_per_forward": n_int4}
        if name == "psgtr":
            served[name]["breakdown_ms"] = psgtr_breakdown(model, imgs, cuda_ms)
        del model, out, preds
        torch.cuda.empty_cache()

    # Baseline's f32 forward, batch 1, TF32 off: the exact kernel against the
    # plain MSDA, the reference route's attention masks replayed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32, _ = zoo_model("baseline", torch.float32)
    dec = model32.bbox_head.transformer_decoder
    masks = HeadMaskReplay(lambda *a: type(dec).forward_head(dec, *a), None)
    dec.forward_head = masks
    outs = {}
    for impl in ("exact", "plain"):
        set_deform_impl(model32, impl)
        if impl == "plain":
            masks.start_replay()
        reset_launches()
        with torch.inference_mode():
            outs[impl] = model32(images[:1])
        torch.cuda.synchronize()
        outs[impl + "_launches"] = launches()["deform_attn_exact"]
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(outs["exact_launches"] == 6 and outs["plain_launches"] == 0,
          f"baseline f32 forward exact launches {outs['exact_launches']}, plain "
          f"{outs['plain_launches']}")
    fwd_err = {}
    for key in ("cls", "mask", "rel", "subject_scores", "object_scores", "queries"):
        ref = outs["plain"][key].float()
        fwd_err[key] = float((outs["exact"][key].float() - ref).abs().max())
        bound = TOL_FORWARD_REL * max(1.0, float(ref.abs().max()))
        check(fwd_err[key] <= bound, f"baseline f32 {key}: exact vs plain {fwd_err[key]} > {bound}")
    del model32, outs
    torch.cuda.empty_cache()
    log(f"[22] {smi}: the zoo at full width, {IMG[0]}x{IMG[1]} batch 2 bf16 (int4 MSDA on the "
        f"pixel decoder; peak GiB of the process, + the part above what was allocated before "
        f"the forward): " + ", ".join(
            f"{n} {v['ms_per_batch_of_2']:.2f} ms, peak {v['peak_gib']:.2f} GiB "
            f"(+{v['forward_peak_gib']:.2f}), "
            f"{v['msda_launches_per_forward']} MSDA" for n, v in served.items())
        + f"; PSGTr's ms { {k: round(v, 3) for k, v in served['psgtr']['breakdown_ms'].items()} }"
        + f"; baseline f32 exact vs plain max|d| { {k: f'{v:.3g}' for k, v in fwd_err.items()} } "
        f"(tol {TOL_FORWARD_REL} x max(1, max|plain|)), {masks.flips} attention-mask bits "
        f"the plain run would set otherwise")

    # --- (23) scoring psgtr and baseline with the CLI, sgdet then PQ ---
    # the oracle's PIL-exact resize of an image's 200 masks to 800x1333 runs
    # on the masks' device: the card's result bit-equal to the host's
    from pairnet_torch.evaluation.runner import _resize_logits

    g = torch.Generator(device=dev).manual_seed(23)
    bits = torch.rand((200, IMG[0] // 4, -(-1333 // 4)), generator=g, device=dev) > 0.5
    out_hw = (IMG[0], 1333)
    t0 = time.perf_counter()
    on_card = _resize_logits(bits, out_hw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_host = _resize_logits(bits.float().cpu().numpy(), out_hw)
    host_s = time.perf_counter() - t0
    check(np.array_equal(on_card, on_host), "the oracle's mask resize on the card differs from "
          "the host's")
    del bits, on_card, on_host
    scored = {"oracle_resize_s": {"card": card_s, "host": host_s}}
    for path in ZOO_SCORE:
        msda = "baseline" in path
        expect = int4_expect if msda else {k: ({} if isinstance(v, dict) else 0)
                                           for k, v in int4_expect.items()}
        for what in ("sgdet", "PQ"):
            metrics, _, per_fwd = score(what, {}, config=os.path.join(ZOO_DIR, path))
            check(per_fwd == expect, f"{path} {what} launches per forward {per_fwd}")
            scored[f"{path} {what}"] = {"metrics": metrics, "launches_per_forward": per_fwd}
    log(f"[23] the oracle's resize of 200 masks to {out_hw}: on the card {card_s:.3f} s, on the "
        f"host {host_s:.3f} s, bit-equal; scored {list(ZOO_SCORE)} on phase 9's split, bf16: "
        + ", ".join(f"{k} {v['metrics'][k.split()[-1] + '_images_per_s']} img/s"
                    for k, v in scored.items() if k != "oracle_resize_s")
        + "; key sets as phase 9's (the JAX engines'), values finite")

    # --- (24) training: the train CLI, then Baseline's f32 step exact vs plain ---
    trained = {}
    saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN",
                                                  "PAIRNET_DEBUG_NANS")}
    os.environ["PAIRNET_DEBUG_NANS"] = "1"
    solver_costs = {}  # (config, solved shape) -> the first costs the solver got
    orig_solve = hungarian_mod._solve_n_le_m

    def recording_solve(cost):
        solver_costs.setdefault((path, tuple(cost.shape)), cost.detach().clone())
        return orig_solve(cost)

    hungarian_mod._solve_n_le_m = recording_solve
    try:
        for path, n_hung in ZOO_TRAIN.items():
            work = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
            try:
                torch.cuda.synchronize()
                reset_launches()
                syncs0 = batched_hungarian.syncs
                count_plain_calls(True)
                try:
                    summary = train_cli.main([os.path.join(ZOO_DIR, path), "--work-dir", work,
                                              "--device", DEVICE, "--max-epochs", "1",
                                              "--cfg-options", *ZOO_TRAIN_SPLIT])
                finally:
                    count_plain_calls(False)
                torch.cuda.synchronize()
                got, steps = launches(), summary["steps"]
                n_msda = 6 * steps if "baseline" in path else 0
                want = {"deform_attn_exact": n_msda, "int4": 0,
                        "deform_attn_bwd": {"f32": n_msda} if n_msda else {},
                        "hungarian": n_hung * steps, "plain": {}}
                check(steps == 2, f"{path}: {steps} steps")
                check(got == want, f"{path} train CLI launches {got}, expected {want}")
                check(batched_hungarian.syncs == syncs0, f"{path}: the Hungarian synced")
                check(all(math.isfinite(v) for v in summary["last"].values()),
                      f"{path} losses {summary['last']}")
                ckpts = sorted(os.listdir(os.path.join(work, "ckpts")))
                check(ckpts == ["epoch_1.pt"], f"{path} checkpoints {ckpts}")
                trained[path] = {"steps": steps, "s_per_step": summary["seconds"] / steps,
                                 "hungarian_launches_per_step": got["hungarian"] / steps,
                                 "msda_launches_per_step": n_msda / steps,
                                 "losses": summary["last"]}
            finally:
                shutil.rmtree(work, ignore_errors=True)
    finally:
        hungarian_mod._solve_n_le_m = orig_solve
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    # the Hungarian kernel on the zoo matchers' own costs, held to the plain loop
    hung = []
    for (path, shape), cost in solver_costs.items():
        r2c, steps = solve_n_le_m_cuda(cost)
        (want_r2c, want_steps), plain_ms = plain_with_ms(lambda: solve_n_le_m_plain_steps(cost))
        check(torch.equal(r2c, want_r2c) and torch.equal(steps, want_steps),
              f"{path} {shape}: the Hungarian kernel's assignments or search steps differ from "
              "the plain loop's")
        B_, n_, m_ = shape
        e = {"config": path, "solved_as": list(shape),
             "ms": cuda_ms(torch, lambda: solve_n_le_m_cuda(cost), 20),
             "device_ms": cuda_ms(torch, lambda: solve_n_le_m_cuda(cost), 20, spin=True),
             "plain_ms": plain_ms,
             "bound_ms": (cost.numel() * 4 + B_ * n_ * 8 + B_ * 4) / HBM_BYTES_PER_S * 1e3,
             "search_steps": int(steps.sum()), "search_steps_max": int(steps.max())}
        e["ns_per_step"] = e["device_ms"] * 1e6 / max(e["search_steps_max"], 1)
        hung.append(e)
    keep_loop_input("short_zoo", {f"{path} {tuple(shape)}": cost
                                  for (path, shape), cost in solver_costs.items()})

    # Baseline's f32 train step (batch 1, TF32 off): the exact forward and
    # bwd2 backward against the plain MSDA, replaying the kernel run's
    # attention masks and Hungarian assignments
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch1 = to_device(train_batch(1, IMG), dev)
    hung_diff = lambda own, kept: sum(int((o != k).sum()) for o, k in zip(own, kept))  # noqa
    replays = {"masks": HeadMaskReplay(None, None),
               "mask assignments": Replay(matchers_mod.batched_hungarian, hung_diff),
               "triplet assignments": Replay(baseline_mod.batched_hungarian, hung_diff)}
    orig = (matchers_mod.batched_hungarian, baseline_mod.batched_hungarian)
    runs = {}
    for impl in ("exact", "plain"):
        model_f, head = zoo_model("baseline", torch.float32)
        set_deform_impl(model_f, impl)
        dec = model_f.bbox_head.transformer_decoder
        replays["masks"].fn = lambda *a, dec=dec: type(dec).forward_head(dec, *a)
        dec.forward_head = replays["masks"]
        matchers_mod.batched_hungarian = replays["mask assignments"]
        baseline_mod.batched_hungarian = replays["triplet assignments"]
        if impl == "plain":
            for r in replays.values():
                r.start_replay()
        optimizer = build_optimizer(model_f)
        state = TrainState(model_f, optimizer, 56)
        step = make_train_step(model_f, optimizer, {}, head_type=head)
        reset_launches()
        try:
            m = {k: float(v) for k, v in step(state, batch1).items()}
        finally:
            matchers_mod.batched_hungarian, baseline_mod.batched_hungarian = orig
        torch.cuda.synchronize()
        grads = {f"{n}.{pn}": p.grad.detach().clone()
                 for n, mod in model_f.named_modules() if isinstance(mod, MSDeformAttention)
                 for pn, p in mod.named_parameters()}
        runs[impl] = (m, grads, launches())
        del model_f, state, step, optimizer
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (m_k, g_k, l_k), (m_p, g_p, l_p) = runs["exact"], runs["plain"]
    check(l_k["deform_attn_exact"] == 6 and l_k["deform_attn_bwd"] == {"f32": 6}
          and l_k["hungarian"] == 2, f"baseline f32 kernel step launches {l_k}")
    check(l_p["deform_attn_exact"] == 0 and not l_p["deform_attn_bwd"],
          f"baseline plain step launches {l_p}")
    loss_err, grad_rel = {}, 0.0
    for k, ref in m_p.items():
        loss_err[k] = abs(m_k[k] - ref)
        check(loss_err[k] <= TOL_TRAIN_REL * max(1.0, abs(ref)),
              f"baseline f32 step {k}: {m_k[k]} vs {ref}")
    check(len(g_k) == len(g_p) == 6 * 8, f"{len(g_k)} MSDA parameter gradients")
    for k, ref in g_p.items():
        d = float((g_k[k] - ref).abs().max())
        scale = float(ref.abs().max())
        grad_rel = max(grad_rel, d / max(scale, 1e-30))
        check(d <= TOL_TRAIN_REL * scale, f"baseline f32 step grad {k}: max|d| {d} (max {scale})")
    flips = {k: r.flips for k, r in replays.items()}
    del runs, g_k, g_p, batch1
    torch.cuda.empty_cache()
    zoo_s = time.perf_counter() - t_zoo
    log(f"[24] train CLI, one epoch of 2 steps at batch 2 f32 over 4 train images at 800x1333: "
        + ", ".join(f"{p} {v['s_per_step']:.3f} s/step, {v['hungarian_launches_per_step']:g} "
                    f"Hungarian + {v['msda_launches_per_step']:g} + "
                    f"{v['msda_launches_per_step']:g} MSDA launches per step"
                    for p, v in trained.items())
        + "; the Hungarian kernel on their costs: " + ", ".join(
            f"{'x'.join(map(str, e['solved_as']))} {e['ms']:.4f} ms (spun {e['device_ms']:.4f}, "
            f"{e['search_steps_max']} steps, plain {e['plain_ms']:.1f})" for e in hung)
        + f"; baseline f32 step exact vs plain: losses max|d| {max(loss_err.values()):.3g}, "
        f"48 MSDA gradients largest rel {grad_rel:.3g} (tol {TOL_TRAIN_REL}), the plain run "
        f"would have set otherwise: {flips}; phases 22-24 took {zoo_s:.1f} s")
    return {"serving": served, "baseline_f32_exact_vs_plain": {
                "max_abs_err": fwd_err, "mask_bits_replayed": masks.flips},
            "scoring": scored, "train_cli": trained, "hungarian": hung,
            "baseline_f32_step": {"loss_max_abs_err": max(loss_err.values()),
                                  "msda_grad_max_rel_err": grad_rel, "replayed": flips},
            "seconds": zoo_s}


BBOX_DIR = os.path.join(ZOO_DIR, "deformable_detr")
BBOX_CONFIG = os.path.join(BBOX_DIR, "pairnet_r101_vg.py")  # the slice's flagship
BBOX_SERVE = {"pairnet_r101_vg": "deformable_detr/pairnet_r101_vg.py",  # phase 26
              "pairnet_rnext101_vg": "deformable_detr/pairnet_rnext101_vg.py",
              "cross_r50_oiv6": "deformable_detr/cross_r50_oiv6.py"}
# the neck's 4 levels at 800x1344: strides 8, 16, 32 and the extra 64
BBOX_SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))
BBOX_Q = 100  # the decoder's queries
# phase 28: 4 train images at 800x1333, one epoch of 2 steps at batch 2
BBOX_TRAIN_SPLIT = ZOO_TRAIN_SPLIT
# phase 27: phase 9's 16 test images, read as a box-only VG split
BBOX_SCORE_SPLIT = SCORE_SPLIT


def bbox_msda_inputs(B, Q, dtype, seed, dev, box=False):
    """MSDA inputs at the box head's 4 levels: value (B, S, H, D), locs,
    weights. Point references: locations over [-0.6, 1.6] (wide). Box
    references (the decoder's, Q = 100): random boxes, centres in [0, 1],
    w and h in [0.05, 1], offsets of up to 3 P, so loc = centre + offset /
    P * wh / 2 spreads up to 1.5 box sizes and many taps leave the plane."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = sum(h * w for h, w in BBOX_SHAPES)
    L = len(BBOX_SHAPES)
    value = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    if box:
        ref = torch.rand((B, Q, 1, L, 1, 4), generator=g, device=dev)
        ref[..., 2:] = ref[..., 2:] * 0.95 + 0.05
        off = (torch.rand((B, Q, H, L, P, 2), generator=g, device=dev) * 2 - 1) * 3 * P
        locs = ref[..., :2] + off / P * ref[..., 2:] * 0.5
    else:
        locs = torch.rand((B, Q, H, L, P, 2), generator=g, device=dev) * 2.2 - 0.6
    w = torch.rand((B, Q, H, L, P), generator=g, device=dev)
    w = w / w.sum(dim=(-1, -2), keepdim=True)
    return value, locs, w


class TopkRecorder:
    """Stands in for ``pairnet_bbox_head.topk_first``: records the three
    discrete steps of a forward (proposal top-k, query re-rank, pair
    top-k), then replays the recorded picks in a second run, counting the
    picks that run would have made otherwise and the ranks each step
    decides by a margin of 10x the gap between the two runs' inputs."""

    def __init__(self, fn):
        self.fn, self.kept, self.replay = fn, [], None
        self.flips, self.decided = [], []

    def __call__(self, x, k):
        own = self.fn(x, k)
        if self.replay is None:
            self.kept.append((x.detach().clone(), own))
            return own
        x0, kept = next(self.replay)
        tol = 10 * float((x.float() - x0.float()).abs().max()) + 1e-6
        self.flips.append(int((own != kept).sum()))
        # a -inf sentinel after the values: the last of k = all ranks has
        # no successor to be confused with
        row = torch.cat([x[0].flatten().double(), x.new_full((1,), -math.inf).double()])
        self.decided.append(int(decided_ranks(row, k, tol).sum()))
        return kept

    def start_replay(self):
        self.replay = iter(self.kept)


def bbox_breakdown(model, images, cuda_ms):
    """Where a box Pair-Net forward's time goes (CUDA events, each part
    alone on the inputs the forward gives it): backbone, neck, the 4-level
    encoder, and the rest of the head (proposals, decoder, PPN, Relation
    Fusion)."""
    head = model.bbox_head
    x = images.permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        feats = model.backbone(x)
        levels = model.neck(feats)
        parts = {"backbone": cuda_ms(torch, lambda: model.backbone(x), 3),
                 "neck": cuda_ms(torch, lambda: model.neck(feats), 3),
                 "encoder": cuda_ms(torch, lambda: head.encode(levels), 3),
                 "head": cuda_ms(torch, lambda: head(levels), 3)}
    parts["decoder_ppn_relation"] = parts["head"] - parts["encoder"]
    return parts


def bbox_phases(smi, tf32, record, compare, count_plain_calls, plain_calls):
    """Phases 25-28 (see the module doc): the box Pair-Net (CrossHeadBBox on
    Deformable-DETR) served, scored and trained at full width. ``record``
    and ``compare`` (the kernel-vs-plain checks by kernel) are main's,
    ``count_plain_calls`` and ``plain_calls`` its count of plain-version
    calls, ``tf32`` the TF32 flags to restore. Returns (the ``bbox`` JSON
    entry, the kernel entries of this path)."""
    import shutil

    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.flagship import perturb_deform_kernels, set_deform_impl
    from pairnet_torch.models.frameworks.psgtr import build_model
    from pairnet_torch.models.heads import pairnet_bbox_head as bbox_mod
    from pairnet_torch.ops import hungarian as hungarian_mod
    from pairnet_torch.ops.deform_attn import ms_deform_attn_plain
    from pairnet_torch.ops.deform_attn_bwd import (
        deform_attn_bwd,
        ms_deform_attn_bwd_plain,
    )
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.ops.deform_attn_int4 import (
        int4_gather,
        int4_gather_plain,
        int4_quantize,
        int4_quantize_plain,
    )
    from pairnet_torch.ops.hungarian import (
        SHORT_COLS,
        batched_hungarian,
        long_cluster,
        solve_n_le_m_cuda,
        solve_n_le_m_plain,
    )
    from pairnet_torch.tools import test as test_cli
    from pairnet_torch.tools import train as train_cli
    from pairnet_torch.tools.msda_kernels import cuda_ms
    from pairnet_torch.train.dispatch import get_postprocess_fn

    dev = torch.device(DEVICE)
    t_bbox = time.perf_counter()
    shapes, L = BBOX_SHAPES, len(BBOX_SHAPES)
    S = sum(h * w for h, w in shapes)

    def reset():
        deform_attn_exact.launches = int4_quantize.launches = int4_gather.launches = 0
        batched_hungarian.launches = batched_hungarian.long_launches = 0
        deform_attn_bwd.launches.clear()
        plain_calls.clear()

    def counts():
        return {"deform_attn_exact": deform_attn_exact.launches,
                "int4_quantize": int4_quantize.launches, "int4_gather": int4_gather.launches,
                "deform_attn_bwd": dict(deform_attn_bwd.launches),
                "hungarian": batched_hungarian.launches,
                "hungarian_long": batched_hungarian.long_launches, "plain": dict(plain_calls)}

    def tap_flops(lc):
        return 10 * lc.shape[0] * lc.shape[1] * H * D * L * P

    def touched_bytes(value, lc):  # the value rows this run's taps read, once
        return touched_rows(lc, shapes) * value.shape[3] * value.element_size()

    # --- (25) the kernels at the box head's geometry, against their plain versions ---
    geo = {}
    for gname, Q, box in (("encoder Q=S", S, False), (f"decoder Q={BBOX_Q} box refs", BBOX_Q, True)):
        v32, lc, wt = bbox_msda_inputs(2, Q, torch.float32, 25, dev, box)
        vb = v32.to(torch.bfloat16)
        g = torch.randn((2, Q, H * D), device=dev, generator=torch.Generator(device=dev)
                        .manual_seed(26))
        vbytes = None if Q == S else touched_bytes(v32, lc)
        e = {}
        _, e["exact f32"] = record(
            "deform_attn_exact", None, lambda: deform_attn_exact(v32, shapes, lc, wt),
            lambda: ms_deform_attn_plain(v32, shapes, lc, wt), compare["exact_f32"],
            (v32, lc, wt), tap_flops(lc), f"f32, {gname}, max|d|", phase=25,
            in_bytes=None if vbytes is None else vbytes + nbytes(lc, wt))
        _, e["exact bf16"] = record(
            "deform_attn_exact", None, lambda: deform_attn_exact(vb, shapes, lc, wt),
            lambda: ms_deform_attn_plain(vb, shapes, lc, wt), compare["exact_bf16"],
            (vb, lc, wt), tap_flops(lc), f"bf16 values, {gname}, rel", phase=25,
            in_bytes=None if vbytes is None else vbytes // 2 + nbytes(lc, wt))
        (codes, scales), e["int4_quantize"] = record(
            "int4_quantize", None, lambda: int4_quantize(vb, shapes),
            lambda: int4_quantize_plain(vb, shapes), compare["quantize"], (vb,),
            5 * vb.numel(), f"bf16, {L} levels, codes and scales", phase=25)
        _, e["int4_gather"] = record(
            "int4_gather", None, lambda: int4_gather(codes, scales, shapes, lc, wt),
            lambda: int4_gather_plain(codes, scales, shapes, lc, wt), compare["gather"],
            (codes, scales, lc, wt), tap_flops(lc), f"{gname}, max|d|, within 1 bf16 ulp",
            phase=25, in_bytes=None if vbytes is None else vbytes // 4 + nbytes(scales, lc, wt))
        for inst, val, bwd in (("f32", v32, "exact"), ("bf16", vb, "exact"),
                               ("bf16_grad", vb, "bf16_grad")):
            ops = BWD_OPS_PER_CORNER[bwd] * D * inside_corners(lc, shapes)
            _, e[f"deform_attn_bwd ({inst})"] = record(
                f"deform_attn_bwd ({inst})", None,
                lambda: deform_attn_bwd(val, shapes, lc, wt, g, bwd),
                lambda: ms_deform_attn_bwd_plain(val, shapes, lc, wt, g,
                                                 bf16_grad=bwd == "bf16_grad"),
                compare["bwd"], (val, lc, wt, g), ops, f"{gname}, max|d|", phase=25)
        geo[gname] = {k: {f: r[f] for f in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")} for k, r in e.items()}
        del v32, vb, lc, wt, g, codes, scales
        torch.cuda.empty_cache()
    log(f"[25] {smi}: the MSDA kernels at the box head's geometry (batch 2, levels {shapes}, "
        f"S = {S}, wide offsets) within phase 2's tolerances; ms (bound): " + "; ".join(
            f"{gn}: " + ", ".join(f"{k} {r['ms']:.4f} ({r['bound_ms']:.4f})" for k, r in v.items())
            for gn, v in geo.items()))

    # --- (26) serving at full width, bf16, int4; then f32 exact vs plain ---
    g = torch.Generator(device=dev).manual_seed(27)
    images = torch.randn((2, *IMG, 3), generator=g, device=dev)

    def bbox_model(rel, dtype, opts=()):
        cfg = apply_overrides(load_config(os.path.join(ZOO_DIR, rel)), list(opts))
        return perturb_deform_kernels(build_model(cfg.model, device=dev)).to(dtype), cfg

    post = get_postprocess_fn("CrossHeadBBox")
    served = {}
    for name, rel in BBOX_SERVE.items():
        model, cfg = bbox_model(rel, torch.bfloat16)
        set_deform_impl(model, "int4")
        imgs = images.to(torch.bfloat16)

        def serve_bbox():
            with torch.inference_mode():
                out = model(imgs)
                return out, [post(out, b) for b in range(imgs.shape[0])]

        serve_bbox()  # warm-up
        torch.cuda.synchronize()
        reset()
        count_plain_calls(True)
        out, preds = serve_bbox()
        torch.cuda.synchronize()
        count_plain_calls(False)
        got = counts()
        want = {"deform_attn_exact": 0, "int4_quantize": 12, "int4_gather": 12,
                "deform_attn_bwd": {}, "hungarian": 0, "hungarian_long": 0, "plain": {}}
        check(got == want, f"{name} serving launches {got}")
        C = cfg.num_object_classes
        for key, shape in {"cls": (2, 100, C), "box": (2, 100, 4), "rel": (2, 100,
                           cfg.num_relation_classes), "importance": (2, 100, 100),
                           "enc_cls": (2, S, C), "sub_pos": (2, 100)}.items():
            check(tuple(out[key].shape) == shape, f"{name}: {key} {tuple(out[key].shape)}")
        for key, val in out.items():
            if torch.is_tensor(val):
                check(bool(torch.isfinite(val.float()).all()), f"{name}: {key} finite")
        check(bool(((out["box"] >= 0) & (out["box"] <= 1)).all()), f"{name}: boxes in [0, 1]")
        check(len(preds) == 2 and all(tuple(p.labels.shape) == (200,)
                                      and tuple(p.rel_pairs.shape) == (100, 2)
                                      and bool(((p.boxes >= 0) & (p.boxes <= 1)).all())
                                      for p in preds), f"{name}: 100 triplets per image")
        served[name] = {"config": rel, "launches": got,
                        "ms_per_batch_of_2": cuda_ms(torch, serve_bbox, 3)}
        if name == "pairnet_r101_vg":
            serving_launches = got
            served[name]["breakdown_ms"] = bbox_breakdown(model, imgs, cuda_ms)
        del model, out, preds
        torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32, _ = bbox_model("deformable_detr/pairnet_r101_vg.py", torch.float32)
    topk = TopkRecorder(bbox_mod.topk_first)
    bbox_mod.topk_first = topk
    outs = {}
    try:
        for impl in ("exact", "plain"):
            set_deform_impl(model32, impl)
            if impl == "plain":
                topk.start_replay()
            reset()
            with torch.inference_mode():
                outs[impl] = model32(images[:1])
            torch.cuda.synchronize()
            outs[impl + "_launches"] = counts()["deform_attn_exact"]
    finally:
        bbox_mod.topk_first = topk.fn
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(outs["exact_launches"] == 12 and outs["plain_launches"] == 0,
          f"f32 forward exact launches {outs['exact_launches']}, plain {outs['plain_launches']}")
    fwd_err = {}
    for key in ("enc_cls", "enc_box", "cls", "box", "importance", "queries", "rel"):
        ref = outs["plain"][key].float()
        fwd_err[key] = float((outs["exact"][key].float() - ref).abs().max())
        bound = TOL_FORWARD_REL * max(1.0, float(ref.abs().max()))
        check(fwd_err[key] <= bound, f"bbox f32 {key}: exact vs plain {fwd_err[key]} > {bound}")
    steps3 = ("proposal top-k", "query re-rank", "pair top-k")
    decided = dict(zip(steps3, topk.decided))
    flips = dict(zip(steps3, topk.flips))
    del model32, outs
    torch.cuda.empty_cache()
    log(f"[26] {smi}: box Pair-Net served at full width, {IMG[0]}x{IMG[1]} batch 2 bf16 int4: "
        + ", ".join(f"{n} {v['ms_per_batch_of_2']:.2f} ms" for n, v in served.items())
        + f"; launches per forward {serving_launches}; boxes in [0, 1], 100 triplets per image; "
        f"pairnet_r101_vg ms {served['pairnet_r101_vg']['breakdown_ms']}; f32 batch 1 exact vs "
        f"plain (TF32 off): max|d| { {k: f'{v:.3g}' for k, v in fwd_err.items()} } (tol "
        f"{TOL_FORWARD_REL} x max(1, max|plain|)); decided ranks {decided} of "
        f"{[100, 100, 100]}; picks the plain run would make otherwise (replayed) {flips}")

    # --- (27) scoring with the CLI: bbox sgdet, bf16 int4 ---
    forwards = [0]
    orig_apply_fn = test_cli.make_apply_fn

    def counting_apply_fn(*args):
        apply_fn = orig_apply_fn(*args)

        def counted(imgs):
            forwards[0] += 1
            return apply_fn(imgs)
        return counted

    saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN")}
    test_cli.make_apply_fn = counting_apply_fn
    torch.cuda.synchronize()
    reset()
    count_plain_calls(True)
    try:
        metrics = test_cli.main([BBOX_CONFIG, "--eval", "sgdet", "--batch-size", str(BATCH),
                                 "--dtype", "bf16", "--device", DEVICE, "--cfg-options",
                                 *BBOX_SCORE_SPLIT])
        torch.cuda.synchronize()
    finally:
        count_plain_calls(False)
        test_cli.make_apply_fn = orig_apply_fn
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    got, nf = counts(), forwards[0]
    check(nf == -(-SCORE_IMAGES // BATCH), f"{nf} forwards for {SCORE_IMAGES} images")
    per_fwd = {k: v / nf for k, v in got.items() if k in ("int4_quantize", "int4_gather",
                                                           "deform_attn_exact")}
    check(per_fwd == {"deform_attn_exact": 0, "int4_quantize": 12, "int4_gather": 12}
          and not got["plain"], f"bbox scoring launches per forward {per_fwd}, plain "
          f"{got['plain']}")
    check(set(metrics) == SGDET_KEYS, f"bbox sgdet keys {sorted(set(metrics) ^ SGDET_KEYS)}")
    check(all(math.isfinite(v) for v in metrics.values()), f"bbox sgdet metrics {metrics}")
    log(f"[27] scored {os.path.relpath(BBOX_CONFIG)} on phase 9's {SCORE_IMAGES} images read as "
        f"a box-only VG split, batch {BATCH} bf16 int4, sgdet with detection_method='bbox': "
        f"{metrics['sgdet_images_per_s']} img/s; key set as the JAX engine's, values finite; "
        f"launches per forward {per_fwd}")

    # --- (28) training with the CLI: the Pair-Net losses, then detection only ---
    trained = {}
    long_costs = []
    orig_solve = hungarian_mod._solve_n_le_m

    def recording_solve(cost):
        if cost.shape[2] > SHORT_COLS and not long_costs:
            long_costs.append(cost.detach().clone())
        return orig_solve(cost)

    saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN",
                                                  "PAIRNET_DEBUG_NANS")}
    os.environ["PAIRNET_DEBUG_NANS"] = "1"
    hungarian_mod._solve_n_le_m = recording_solve
    try:
        for rel, n_long in (("deformable_detr/pairnet_r101_vg.py", 0),
                            ("deformable_detr/od_r101_vg.py", 1)):
            work = tempfile.mkdtemp(prefix="chip_smoke_bbox_")
            try:
                torch.cuda.synchronize()
                reset()
                syncs0 = batched_hungarian.syncs
                count_plain_calls(True)
                try:
                    summary = train_cli.main([os.path.join(ZOO_DIR, rel), "--work-dir", work,
                                              "--device", DEVICE, "--max-epochs", "1",
                                              "--cfg-options", *BBOX_TRAIN_SPLIT])
                finally:
                    count_plain_calls(False)
                torch.cuda.synchronize()
                got, steps = counts(), summary["steps"]
                want = {"deform_attn_exact": 12 * steps, "int4_quantize": 0, "int4_gather": 0,
                        "deform_attn_bwd": {"f32": 12 * steps}, "hungarian": 2 * steps,
                        "hungarian_long": n_long * steps, "plain": {}}
                check(steps == 2, f"{rel}: {steps} steps")
                check(got == want, f"{rel} train CLI launches {got}, expected {want}")
                check(batched_hungarian.syncs == syncs0, f"{rel}: the Hungarian synced")
                check(all(math.isfinite(v) for v in summary["last"].values()),
                      f"{rel} losses {summary['last']}")
                trained[rel] = {"steps": steps, "s_per_step": summary["seconds"] / steps,
                                "launches": got, "losses": summary["last"]}
            finally:
                shutil.rmtree(work, ignore_errors=True)
    finally:
        hungarian_mod._solve_n_le_m = orig_solve
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    check(len(long_costs) == 1, "the detection-only step gave the long instance no problem")
    cost = long_costs[0]
    keep_loop_input("hungarian_long", cost)
    B_, n_, m_ = cost.shape
    got_r2c, steps_t = solve_n_le_m_cuda(cost)
    want_r2c = solve_n_le_m_plain(cost)
    n_diff = int((got_r2c != want_r2c).sum())
    check(n_diff == 0, f"long Hungarian on the step's costs: {n_diff} assignments differ")
    hung_long = {
        "solved_as": [B_, n_, m_], "max_abs_err": float(n_diff),
        "ms": cuda_ms(torch, lambda: solve_n_le_m_cuda(cost), 10),
        "device_ms": cuda_ms(torch, lambda: solve_n_le_m_cuda(cost), 10, spin=True),
        "plain_ms": cuda_ms(torch, lambda: solve_n_le_m_plain(cost), 1),
        "bound_ms": (cost.numel() * 4 + B_ * n_ * 8 + B_ * 4) / HBM_BYTES_PER_S * 1e3,
        "search_steps": int(steps_t.sum()), "search_steps_max": int(steps_t.max()),
        "cluster_ctas": long_cluster(m_)}
    check(hung_long["cluster_ctas"] >= 2, f"long Hungarian cluster {hung_long['cluster_ctas']}")
    hung_long["ns_per_step"] = hung_long["device_ms"] * 1e6 / max(hung_long["search_steps_max"], 1)

    # where a step's time goes: each config's f32 step (exact MSDA) on
    # bench's seeded batch of 2 with boxes from its stride-4 masks, the
    # phases by the port's spans under the profiler
    from pairnet_torch.bench import span_breakdown, time_train, train_batch
    from pairnet_torch.ops.boxes import masks_to_boxes
    from pairnet_torch.train.optim import build_optimizer
    from pairnet_torch.train.trainer import TrainState, make_train_step, to_device

    step_split = {}
    for rel in ("deformable_detr/pairnet_r101_vg.py", "deformable_detr/od_r101_vg.py"):
        model, cfg = bbox_model(rel, torch.float32)
        set_deform_impl(model, "exact")
        batch = to_device(train_batch(2, IMG), dev)
        batch["gt_labels"] = batch["gt_labels"].clamp_max(cfg.num_object_classes - 1)
        batch["gt_rels"][..., 2].clamp_(1, cfg.num_relation_classes)
        batch["gt_boxes"] = torch.stack([masks_to_boxes(m.float()) * 4 for m in batch["gt_masks"]])
        batch["image_shape"] = torch.tensor([IMG] * 2, dtype=torch.int32, device=dev)
        optimizer = build_optimizer(model)
        state = TrainState(model, optimizer, cfg.num_relation_classes)
        step = make_train_step(model, optimizer, dict(cfg.get("loss", {})),
                               head_type="CrossHeadBBox")
        ms, peak = time_train(step, state, batch, 3)
        spans = span_breakdown(lambda: step(state, batch), dev)["spans"]
        step_split[rel] = {"ms_per_step": ms, "peak_gib": peak / 2 ** 30,
                           "phase_device_ms": {k[len("train."):]: v["device_ms"]
                                               for k, v in spans.items()
                                               if k.startswith("train.") and k != "train.step"},
                           "kernels_launched": spans["train.step"]["kernels"]}
        del model, state, step, optimizer, batch
        torch.cuda.empty_cache()
    bbox_s = time.perf_counter() - t_bbox
    log(f"[28] train CLI, one epoch of 2 steps at batch 2 f32 over 4 train images at 800x1333: "
        + ", ".join(f"{p} {v['s_per_step']:.3f} s/step, launches {v['launches']}"
                    for p, v in trained.items())
        + f"; no solver sync; the long Hungarian on the detection-only step's encoder costs "
        f"({B_}x{n_}x{m_}): equal to the plain loop's, {hung_long['ms']:.4f} ms (spun "
        f"{hung_long['device_ms']:.4f}), {hung_long['search_steps_max']} search steps "
        f"({hung_long['ns_per_step']:.0f} ns a step, clusters of "
        f"{hung_long['cluster_ctas']} CTAs), plain loop {hung_long['plain_ms']:.1f} "
        f"ms, bound {hung_long['bound_ms']:.5f} ms; the f32 step on a seeded batch of 2: "
        + ", ".join(f"{p} {v['ms_per_step']:.1f} ms (phases "
                    f"{ {k: round(x, 2) for k, x in v['phase_device_ms'].items()} } device ms, "
                    f"{v['kernels_launched']} kernels)"
                    for p, v in step_split.items())
        + f"; phases 25-28 took {bbox_s:.1f} s")

    # this path's kernel entries: launches from its runs (serving 26, training
    # 28), timings at the encoder geometry, both geometries kept
    pair_train = trained["deformable_detr/pairnet_r101_vg.py"]["launches"]
    od_train = trained["deformable_detr/od_r101_vg.py"]["launches"]
    enc, decg = geo["encoder Q=S"], geo[f"decoder Q={BBOX_Q} box refs"]
    entries = []
    for name, key, launches, src, rep in (
            ("deform_attn_exact@bbox", "exact f32", pair_train["deform_attn_exact"],
             "deform_attn_exact.cu", "pairnet_tpu/ops/pallas_deform_attn_v6.py:171"),
            ("int4_quantize@bbox", "int4_quantize", serving_launches["int4_quantize"],
             "deform_attn_quant.cu", "pairnet_tpu/ops/pallas_deform_attn_v16.py:89"),
            ("int4_gather@bbox", "int4_gather", serving_launches["int4_gather"],
             "deform_attn_quant.cu", "pairnet_tpu/ops/pallas_deform_attn_v16.py:244"),
            ("deform_attn_bwd (f32)@bbox", "deform_attn_bwd (f32)",
             pair_train["deform_attn_bwd"].get("f32", 0), "deform_attn_bwd.cu",
             "pairnet_tpu/ops/pallas_deform_bwd2.py:196")):
        entries.append({**{f: enc[key][f] for f in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                                     "bound_ms", "bound_by")},
                        "name": name, "route": "cuda", "source": f"pairnet_torch/csrc/{src}",
                        "replaces": rep, "launches": launches, "library_ms": None,
                        "geometry": f"encoder Q=S={S}", "decoder_q100_box_refs": decg[key]})
    entries.append({
        "name": "hungarian_long@od", "route": "cuda", "source": "pairnet_torch/csrc/hungarian.cu",
        "replaces": "pairnet_tpu/ops/hungarian.py:36 (_solve_n_le_m, a lax.while_loop; not a "
                    "pallas_call site)",
        "launches": od_train["hungarian_long"], "bound_by": "bytes", "library_ms": None,
        **{f: hung_long[f] for f in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                     "solved_as", "search_steps", "search_steps_max",
                                     "ns_per_step", "cluster_ctas")}})
    return {"kernels_at_geometry": geo, "serving": served,
            "f32_exact_vs_plain": {"max_abs_err": fwd_err, "decided_ranks": decided,
                                   "picks_replayed": flips},
            "scoring": {"config": os.path.relpath(BBOX_CONFIG), "metrics": metrics,
                        "launches_per_forward": per_fwd},
            "train_cli": trained, "hungarian_long": hung_long, "step_split": step_split,
            "seconds": bbox_s}, entries


TS_DIR = ZOO_DIR  # configs/
TS_SERVE = {"MotifHead": "motifs/panoptic_fpn_r50_sgdet_psg.py",  # phase 30
            "IMPHead": "imp/panoptic_fpn_r50_sgdet_psg.py",
            "GPSHead": "gpsnet/panoptic_fpn_r50_sgdet_psg.py",
            "VCTreeHead": "vctree/panoptic_fpn_r50_sgdet_psg.py"}
TS_SCORE = {"predcls": ("motifs/panoptic_fpn_r50_predcls_psg.py",),  # phase 31
            "sgcls": ("imp/panoptic_fpn_r50_predcls_psg.py", "model.relation_head.mode=sgcls"),
            "sgdet": ("motifs/panoptic_fpn_r50_sgdet_psg.py",)}
TS_NO_DISTS = "motifs/panoptic_fpn_r50_sgcls_psg.py"  # needs det_dists: raises on GT boxes
TS_TRAIN = ("motifs/panoptic_fpn_r50_predcls_psg.py", "vctree/panoptic_fpn_r50_predcls_psg.py")
# phase 31: 4 synthetic test images at 800x1333 (sgdet's 117 full-resolution
# segment masks an image are scored on the host by the numpy oracle)
TS_SCORE_SPLIT = ("data.dataset.data_root=", "data.dataset.synthetic={'num_images':8,"
                  "'num_test':4,'height':800,'width':1333,'seed':7}")
TS_BATCH = 2
TS_IMAGE_SHAPE = (800, 1333)  # the resized image inside IMG
TS_DET = {"type": "PanopticFPN", "backbone": {"type": "ResNet", "depth": 50}, "num_things": 80,
          "num_stuff": 53, "num_proposals": 256, "max_dets": 64, "score_thr": 0.3}
# f32 operations of one IoU with both areas at hand (csrc/nms.cu::box_iou: 2 min, 2 max and
# 2 sub for the overlap's sides, 2 max at 0, 1 product, 2 sums for the union, 1 max, 1
# divide, the compare), and of one box's area (2 sub, 2 max, 1 product)
IOU_OPS, AREA_OPS = 14, 5
TWOSTAGE_KEYS = {  # the JAX engines' keys by mode (evaluate_twostage), and the CLI's two
    mode: ({f"{mode}_recall_R@{k}" for k in TOPKS} | {f"{mode}_mean_recall_mR@{k}" for k in TOPKS}
           | {f"{mode}_group_{g}_R@{k}" for g in ("tt", "ts", "st", "ss") for k in TOPKS}
           | {f"{mode}_eval_time_s", f"{mode}_images_per_s"}
           | ({f"pair_accuracy_A@{k}" for k in TOPKS} | {"object_mean_iou", "object_iou_recall"}
              if mode != "sgdet" else {f"phrdet_recall_R@{k}" for k in TOPKS}))
    for mode in ("predcls", "sgcls", "sgdet")}


def nms_case(B, n, thr, dev, seed, offset=False):
    """Sorted boxes (B, n, 4), valid (B, n) for the NMS kernel: n random
    boxes over an 800x1344 image with a quarter of the scores tied to a
    neighbour's, pairs at IoU exactly 0.5 and 0.7 planted (exact in f32),
    a tenth invalid; with ``offset`` the detections' class offsets (80
    classes) applied as ``batched_nms`` applies them."""
    from pairnet_torch.ops.nms import score_order

    g = torch.Generator(device=dev).manual_seed(seed)
    xy = torch.rand((B, n, 2), generator=g, device=dev) * torch.tensor([1344.0, 800.0], device=dev)
    wh = 8 + torch.rand((B, n, 2), generator=g, device=dev) * 300
    boxes = torch.cat([xy, xy + wh], -1)
    for i in range(0, n - 2, 9):  # a 10 x 10 box, its 10 x 5 (IoU 0.5) and 10 x 7 (0.7) parts
        x, y = xy[:, i].floor().unbind(-1)
        boxes[:, i] = torch.stack([x, y, x + 10, y + 10], -1)
        boxes[:, i + 1] = torch.stack([x, y, x + 10, y + 5], -1)
        boxes[:, i + 2] = torch.stack([x, y, x + 10, y + 7], -1)
    scores = torch.rand((B, n), generator=g, device=dev)
    scores[:, 2::4] = scores[:, 1::4][:, : scores[:, 2::4].shape[1]]
    valid = torch.rand((B, n), generator=g, device=dev) > 0.1
    if offset:
        labels = torch.randint(0, 80, (B, n), generator=g, device=dev)
        mc = boxes.abs().amax(dim=(-2, -1), keepdim=True) + 1.0
        boxes = boxes + labels.float()[..., None] * (2.0 * mc)
    order = score_order(scores, valid)
    take = lambda x: torch.gather(x, 1, order if x.dim() == 2 else order[..., None].expand(
        -1, -1, x.shape[-1]))  # noqa: E731
    return take(boxes).contiguous(), take(valid).contiguous()


def near_threshold(boxes, thr):
    """Pairs of boxes (B, N, 4) whose IoU lies within 1e-6 of ``thr`` but
    not on it, and those exactly on it."""
    from pairnet_torch.ops.boxes import box_iou

    iou = box_iou(boxes, boxes)[0]
    iou = iou.masked_fill(torch.eye(iou.shape[-1], dtype=torch.bool, device=iou.device), -1.0)
    d = (iou - thr).abs()
    return int(((d < 1e-6) & (d > 0)).sum()) // 2, int((d == 0).sum()) // 2


def nms_swept(boxes, valid, keep, thr):
    """The IoUs this run's sweep computes: each kept box i against every
    later valid box j that no kept box before i has suppressed. j is
    suppressed by the first kept box that overlaps it by more than
    ``thr``, and is swept by the kept boxes up to that one."""
    from pairnet_torch.ops.boxes import box_iou

    n = keep.shape[-1]
    idx = torch.arange(n, device=keep.device)
    sweeps = keep[:, :, None] & valid[:, None, :] & (idx[:, None] < idx[None, :])
    hits = sweeps & (box_iou(boxes, boxes)[0] > thr)
    first = torch.where(hits.any(1), hits.to(torch.uint8).argmax(1), n)  # (B, N): by i
    return int((sweeps & (idx[None, :, None] <= first[:, None, :])).sum())


def nms_flops(boxes, valid, keep, thr):
    """The operations of this run's sweep: its IoUs, and each valid box's area once."""
    return IOU_OPS * nms_swept(boxes, valid, keep, thr) + AREA_OPS * int(valid.sum())


def plain_with_ms(fn):
    """fn()'s result and its ms by CUDA events around one call (the plain
    Hungarian loop: its result is checked and the same call timed)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def keep_loop_input(name, value):
    """With ``CHIP_SMOKE_LOOP_INPUTS=FILE``, add a loop kernel's main-path
    inputs to that file (``torch.save``), for
    ``pairnet_torch/tools/loop_kernels.py --inputs FILE``."""
    path = os.environ.get("CHIP_SMOKE_LOOP_INPUTS")
    if path:
        saved = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        saved[name] = value
        torch.save(saved, path)


def nms_split(entry, keep, boxes, valid, thr):
    """The NMS call's two kernels timed apart (CUDA events around each
    launched alone, behind a spin; their sum becomes the entry's ``ms``,
    the whole call's time as issued stays as ``issued_ms``), and the
    sweep's barriers: one a 64-box block, beside the boxes kept."""
    from pairnet_torch.ops.nms import nms_sorted_parts
    from pairnet_torch.tools.msda_kernels import cuda_ms

    mask, sweep, parts_keep = nms_sorted_parts(boxes, valid, thr)
    mask()
    sweep()
    torch.cuda.synchronize()
    check(torch.equal(parts_keep, keep), "nms: the two launches apart keep other boxes")
    mask_ms, sweep_ms = cuda_ms(torch, mask, 10, spin=True), cuda_ms(torch, sweep, 10, spin=True)
    entry.update(issued_ms=entry["ms"], mask_ms=mask_ms, sweep_ms=sweep_ms, ms=mask_ms + sweep_ms,
                 kept_per_image=keep.sum(1).tolist(), barriers_per_image=-(-keep.shape[1] // 64))
    log(f"[29] {entry['name']}: mask kernel {mask_ms:.4f} ms + sweep {sweep_ms:.4f} ms = "
        f"{entry['ms']:.4f} ms (the call as issued {entry['issued_ms']:.4f}); kept "
        f"{entry['kept_per_image']} boxes, {entry['barriers_per_image']} sweep barriers an image")


def twostage_phases(smi, record):
    """Phases 29-32 (see the module doc): the NMS kernel, and the two-stage
    family (the Panoptic FPN detector, MOTIFS / IMP / GPS-Net / VCTree)
    served, scored and trained at full width. ``record`` is main's
    kernel-vs-plain check and timing; it adds the NMS kernel's entry to the
    ``kernels`` line. Returns the ``twostage`` JSON entry."""
    import shutil

    from pairnet_torch.config import apply_overrides, load_config
    from pairnet_torch.evaluation.runner import sgdet_batch
    from pairnet_torch.models.frameworks import panoptic_fpn as pfpn_mod
    from pairnet_torch.models.frameworks.psgtr import build_model
    from pairnet_torch.models.heads.twostage.heads import twostage_postprocess
    from pairnet_torch.ops import nms as nms_mod
    from pairnet_torch.tools import test as test_cli
    from pairnet_torch.tools import train as train_cli
    from pairnet_torch.tools.msda_kernels import cuda_ms, graph_nodes

    dev = torch.device(DEVICE)
    plain_nms = {"calls": 0}
    orig_plain = nms_mod.nms_sorted_plain

    def counted_plain(*a, **k):
        plain_nms["calls"] += 1
        return orig_plain(*a, **k)

    def equal_keep(k, p):
        check(torch.equal(k, p), f"nms keep masks differ at {int((k != p).sum())} boxes")
        return 0.0

    # --- (29) the NMS kernel against the plain sweep ---
    cases = {}
    for name, (B, n, thr, offset) in {"rpn": (2, 4819, 0.7, False),
                                      "detections": (2, 256, 0.5, True),
                                      "ties_thr_0.5": (3, 300, 0.5, False)}.items():
        boxes, valid = nms_case(B, n, thr, dev, seed=29 + n, offset=offset)
        got = nms_mod.nms_sorted_cuda(boxes, valid, thr)
        want = nms_mod.nms_sorted_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        equal_keep(got, want)
        near, exact = near_threshold(boxes, thr)
        cases[name] = {"B": B, "N": n, "thr": thr, "kept": int(got.sum()),
                       "iou_within_1e-6_of_thr": near, "iou_exactly_thr": exact}
        check(near == 0, f"nms {name}: {near} IoUs within 1e-6 of the threshold (not on it)")
        check(offset or exact > 0, f"nms {name}: no planted pair at IoU exactly {thr}")
    log(f"[29] {smi}: nms kernel vs plain sweep: keep masks equal "
        + "; ".join(f"{k} (B {c['B']}, N {c['N']}, thr {c['thr']}): kept {c['kept']}, IoUs "
                    f"exactly at thr {c['iou_exactly_thr']}, within 1e-6 of it "
                    f"{c['iou_within_1e-6_of_thr']}" for k, c in cases.items()))

    # --- (30) serving sgdet: detector -> fusion -> relation head, full width ---
    # the CLI's sgdet path (evaluate_twostage's batch: detector_segments' apply,
    # sgdet_batch, make_twostage_apply_fn, twostage_postprocess), the detector
    # loaded from a work dir as a user's; ms by part from CUDA events that hooks
    # on its modules and calls record
    g = torch.Generator(device=dev).manual_seed(30)
    images = torch.randn((TS_BATCH, *IMG, 3), generator=g, device=dev)
    shape = torch.tensor([TS_IMAGE_SHAPE] * TS_BATCH, device=dev)
    T, S = TS_DET["num_things"], TS_DET["num_stuff"]
    det_work = tempfile.mkdtemp(prefix="chip_smoke_detector_")
    seeded = build_model(TS_DET, device=dev, seed=30)
    with torch.no_grad():  # seeded weights made decisive: peaky classes, boxes near anchors
        seeded.roi_head.bbox_head.fc_cls.weight.mul_(8.0)
        seeded.roi_head.bbox_head.fc_reg.weight.mul_(0.1)
        seeded.rpn_head.rpn_reg.weight.mul_(0.1)
        seeded.roi_head.mask_head.conv_logits.weight.mul_(4.0)
    os.makedirs(os.path.join(det_work, "ckpts"))
    torch.save({"epoch": 1, "state": {"model": seeded.state_dict()}},
               os.path.join(det_work, "ckpts", "epoch_1.pt"))
    del seeded
    captured = {}

    def capturing_cuda(boxes, valid, thr):
        captured.setdefault(boxes.shape[1], (boxes.clone(), valid.clone(), thr))
        return orig_cuda(boxes, valid, thr)

    orig_cuda = nms_mod.nms_sorted_cuda
    timer = PartTimer()
    timer.function("fusion", pfpn_mod, "heuristic_fusion_segments")  # read by detector_segments
    try:
        detector_apply = test_cli.detector_segments(
            {**TS_DET, "checkpoint": det_work}, TS_DET["backbone"],
            load_config(os.path.join(TS_DIR, TS_SERVE["MotifHead"])).model.relation_head
            .num_classes, 64, 4, dev)
    finally:
        timer.remove()
        shutil.rmtree(det_work, ignore_errors=True)
    detector = detector_apply.detector
    timer.modules("detector backbone + FPN", detector.backbone, detector.neck)
    timer.method("RPN + NMS", detector, "proposals")
    timer.method("RoI box head + NMS", detector, "detect")
    timer.method("mask head + paste", detector, "paste_masks")
    timer.modules("semantic head", detector.semantic_head)
    pairs_host = timer.wrap("pairs (host)", sgdet_batch)
    post_host = timer.wrap("post-processing (host ranking)", twostage_postprocess)

    def sgdet(apply_fn):
        """One sgdet batch as evaluate_twostage serves it: (outputs,
        post-processed results, the detector's segments, the batch)."""
        det = detector_apply(images, shape)
        batch = pairs_host({"image": images, "image_shape": shape}, det, 64 * 63)
        out = apply_fn(batch)
        res = [post_host(out, batch, b) for b in range(TS_BATCH)]
        return out, res, det, batch

    serving = {}
    nms_expect = None
    try:
        for head, path in TS_SERVE.items():
            cfg = load_config(os.path.join(TS_DIR, path))
            model = build_model(cfg.model, device=dev, seed=31)
            head_timer = PartTimer(timer)
            head_timer.modules("relation backbone + FPN", model.backbone, model.neck)
            head_timer.method("relation frontend (RoI + union features)", model.relation_head,
                              "frontend")
            head_timer.method("context + relation scores", model.relation_head, "predict")
            serving[head] = {}
            for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                if head != "MotifHead" and dname == "f32":
                    continue
                model = model.to(dtype)
                apply_fn = test_cli.make_twostage_apply_fn(model, dev, dtype)
                sgdet(apply_fn)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                nms_mod.nms_sorted.launches = 0
                plain_nms["calls"] = 0
                nms_mod.nms_sorted_plain = counted_plain
                if head == "MotifHead" and dname == "bf16":
                    nms_mod.nms_sorted_cuda = capturing_cuda
                timer.start()
                try:
                    out, res, det, batch = sgdet(apply_fn)
                    torch.cuda.synchronize()
                finally:
                    timer.stop()
                    nms_mod.nms_sorted_plain = orig_plain
                    nms_mod.nms_sorted_cuda = orig_cuda
                launches = nms_mod.nms_sorted.launches
                if head == "MotifHead" and dname == "bf16":
                    nms_expect = launches
                check(launches == 2 and plain_nms["calls"] == 0,
                      f"{head} {dname} sgdet: {launches} nms launches, "
                      f"{plain_nms['calls']} plain calls")
                P = batch["pairs"].shape[1]
                check(P == 64 * 63, f"{P} pairs an image")
                check(tuple(out["rel_scores"].shape) == (TS_BATCH, P, 57)
                      and bool(torch.isfinite(out["rel_scores"]).all())
                      and bool(torch.isfinite(out["refine_scores"]).all()),
                      f"{head} {dname} outputs {tuple(out['rel_scores'].shape)}")
                ms = cuda_ms(torch, lambda: sgdet(apply_fn), 2)
                peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                valid = det[3]
                serving[head][dname] = {
                    "ms_per_batch": ms, "peak_gib": peak, "ms_by_part": timer.ms(),
                    "nms_launches_per_forward": launches,
                    "plain_nms_calls": plain_nms["calls"],
                    "segments_valid_per_image": valid.sum(1).tolist(),
                    "things_kept_per_image": valid[:, :64].sum(1).tolist(),
                    "valid_pairs_per_image": batch["pair_valid"].sum(1).tolist(),
                    "ranked_pairs_per_image": [len(r["rel_pair_idxes"]) for r in res]}
            head_timer.remove()
            del model, apply_fn
            torch.cuda.empty_cache()
    finally:
        timer.remove()
    with torch.inference_mode():
        dets, sem, masks = detector(images, shape, with_masks=True)
        fusion_nodes = graph_nodes(torch, lambda: pfpn_mod.heuristic_fusion_segments(
            dets, masks, sem, T, S))
    motif = serving["MotifHead"]["bf16"]
    parts = ", ".join(f"{k} {v:.1f}" for k, v in motif["ms_by_part"].items())
    log(f"[30] {smi}: sgdet at 800x1344, batch {TS_BATCH}: PanopticFPN R-50 (f32) -> fusion "
        f"-> head (4032 pairs an image): nms launches per forward {nms_expect}, plain calls 0; "
        f"fusion puts {dict(fusion_nodes)} on the card; MotifHead bf16 "
        f"{motif['ms_per_batch']:.1f} ms ({parts}); "
        + "; ".join(f"{h} {d} {v['ms_per_batch']:.1f} ms, peak {v['peak_gib']:.2f} GiB"
                    for h, r in serving.items() for d, v in r.items()))

    # the kernel on the main path's inputs: the RPN's call (and the detections')
    rpn_boxes, rpn_valid, rpn_thr = captured[max(captured)]
    keep_loop_input("nms_rpn", captured[max(captured)])
    keep_loop_input("nms_det", captured[min(captured)])
    keep = nms_mod.nms_sorted_cuda(rpn_boxes, rpn_valid, rpn_thr)
    _, entry = record("nms", nms_expect, lambda: nms_mod.nms_sorted_cuda(rpn_boxes, rpn_valid,
                                                                          rpn_thr),
                      lambda: nms_mod.nms_sorted_plain(rpn_boxes, rpn_valid, rpn_thr),
                      equal_keep, (rpn_boxes, rpn_valid),
                      nms_flops(rpn_boxes, rpn_valid, keep, rpn_thr),
                      f"the RPN's call, B {TS_BATCH}, N {rpn_boxes.shape[1]}, thr {rpn_thr}",
                      phase=29, source="pairnet_torch/csrc/nms.cu",
                      replaces="pairnet_tpu/ops/nms.py:17 (nms: a lax.fori_loop, not a "
                               "pl.pallas_call site)")
    nms_split(entry, keep, rpn_boxes, rpn_valid, rpn_thr)
    entry["ious_swept"] = nms_swept(rpn_boxes, rpn_valid, keep, rpn_thr)
    det_boxes, det_valid, det_thr = captured[min(captured)]
    keep_d = nms_mod.nms_sorted_cuda(det_boxes, det_valid, det_thr)
    _, entry_d = record("nms@detections", None,
                        lambda: nms_mod.nms_sorted_cuda(det_boxes, det_valid, det_thr),
                        lambda: nms_mod.nms_sorted_plain(det_boxes, det_valid, det_thr),
                        equal_keep, (det_boxes, det_valid),
                        nms_flops(det_boxes, det_valid, keep_d, det_thr),
                        f"the detections' class-offset call, N {det_boxes.shape[1]}",
                        phase=29)
    nms_split(entry_d, keep_d, det_boxes, det_valid, det_thr)
    fields = ("ms", "issued_ms", "device_ms", "mask_ms", "sweep_ms", "plain_ms", "bound_ms",
              "bound_by", "kept_per_image", "barriers_per_image")
    nms_entry = {"rpn": {k: entry[k] for k in fields},
                 "detections": {k: entry_d[k] for k in fields}, "cases": cases}

    # --- (31) scoring through the test CLI ---
    scoring = {}
    for mode, engine in (("predcls", "device"), ("predcls", "numpy"), ("sgcls", "device"),
                         ("sgdet", "numpy")):
        nms_mod.nms_sorted.launches = 0
        path, *extra = TS_SCORE[mode]
        metrics = test_cli.main([os.path.join(TS_DIR, path), "--eval", mode,
                                 "--eval-engine", engine, "--batch-size", str(TS_BATCH),
                                 "--device", DEVICE, "--cfg-options", *TS_SCORE_SPLIT, *extra])
        torch.cuda.synchronize()
        check(set(metrics) == TWOSTAGE_KEYS[mode],
              f"{mode} keys {sorted(set(metrics) ^ TWOSTAGE_KEYS[mode])}")
        check(all(math.isfinite(v) for v in metrics.values()), f"{mode} metrics finite")
        if mode == "sgdet":
            check(nms_mod.nms_sorted.launches == 4, f"sgdet scoring: "
                  f"{nms_mod.nms_sorted.launches} nms launches for 2 detector forwards")
        scoring[f"{mode} {engine}"] = {"config": " ".join(TS_SCORE[mode]), "metrics": metrics,
                                       "img_per_s": metrics[f"{mode}_images_per_s"]}
    try:
        test_cli.main([os.path.join(TS_DIR, TS_NO_DISTS), "--eval", "sgcls", "--batch-size",
                       str(TS_BATCH), "--device", DEVICE, "--cfg-options", *TS_SCORE_SPLIT])
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "det_dists" in refused,
          f"{TS_NO_DISTS} scored sgcls without det_dists: {refused}")
    scoring["refused"] = {"config": TS_NO_DISTS, "error": refused}
    log(f"[31] {smi}: test CLI over 4 synthetic 800x1333 images, batch {TS_BATCH}, f32: "
        + "; ".join(f"{k} {v['img_per_s']} img/s" for k, v in scoring.items() if k != "refused")
        + f"; JAX's key sets, values finite; {TS_NO_DISTS} sgcls refused (no det_dists)")

    # --- (32) training through the train CLI ---
    training = {}
    for path in TS_TRAIN:
        work = tempfile.mkdtemp(prefix="chip_smoke_twostage_train_")
        try:
            opts = [*ZOO_TRAIN_SPLIT, "data.samples_per_device=2"]
            cfg = apply_overrides(load_config(os.path.join(TS_DIR, path)), opts)
            init = build_model(cfg.model, device=dev, seed=cfg.get("seed", 10086)).state_dict()
            runs = []
            for extra in (["--max-epochs", "1"], ["--resume", "--max-epochs", "2"]):
                summary = train_cli.main([os.path.join(TS_DIR, path), "--work-dir", work,
                                          "--device", DEVICE, *extra, "--cfg-options", *opts])
                torch.cuda.synchronize()
                check(summary["steps"] == 2, f"{path}: {summary['steps']} steps")
                check(all(math.isfinite(v) for v in summary["last"].values()),
                      f"{path} losses {summary['last']}")
                runs.append({"start_epoch": summary["start_epoch"], "losses": summary["last"],
                             "s_per_step": summary["seconds"] / summary["steps"]})
            trained = torch.load(os.path.join(work, "ckpts", "epoch_2.pt"), map_location=dev,
                                 weights_only=False)["state"]["model"]
            moved = not torch.equal(trained["relation_head.rel_compress.weight"],
                                    init["relation_head.rel_compress.weight"])
            stats = [k for k in init if "running_" in k]
            frozen = all(torch.equal(trained[k], init[k]) for k in stats)
            check(moved and frozen and runs[1]["start_epoch"] == 1,
                  f"{path}: head moved {moved}, {len(stats)} BN statistics unchanged {frozen}")
            training[path] = {"runs": runs, "head_moved": moved, "bn_statistics": len(stats),
                              "bn_statistics_unchanged": frozen}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    log(f"[32] {smi}: train CLI, 4 train images at 800x1333, batch 2, f32, 2 steps then "
        f"--resume: " + "; ".join(f"{p} {[round(r['s_per_step'], 3) for r in t['runs']]} s per "
                                  f"step, BN statistics unchanged ({t['bn_statistics']})"
                                  for p, t in training.items()))
    return {"nms": nms_entry, "serving": serving, "fusion_graph_nodes": dict(fusion_nodes),
            "scoring": scoring, "training": training}


# phase 33: the segmenter of a Mask2Former checkpoint, in the port's Pair-Net names
M2F_SEGMENTER = ("backbone.", "bbox_head.pixel_decoder.", "bbox_head.transformer_decoder.",
                 "bbox_head.query_feat.", "bbox_head.query_embed.", "bbox_head.level_embed.",
                 "bbox_head.cls_embed.", "bbox_head.mask_embed.")
BRIDGE_SEED = 33  # the checkpoints' weights (the train CLI builds its model from the config's)


def bridge_phase(smi, score, launches, reset_launches, count_plain_calls, int4_expect):
    """Phase 33 (see the module doc): reference ``.pth`` warm starts through
    the train CLI's ``--load-from``, then the test CLI on the work dir.
    ``score`` and the launch helpers are main's. Returns the ``bridge``
    JSON entry: the phase's seconds and each file's run.

    The JAX half of the checkpoint bridge (``tools/export_orbax.py``) needs
    orbax, which the card's machine does not have: the orbax -> export ->
    ``pairnet_torch.tools.import_jax`` leg is held by the CPU tests
    (``tests/test_torch_ckpt_bridge.py``), not here."""
    import shutil

    from pairnet_torch.config import load_config
    from pairnet_torch.models.frameworks.psgtr import build_model
    from pairnet_torch.models.layers import FrozenBatchNorm
    from pairnet_torch.tools import train as train_cli
    from pairnet_torch.utils import from_jax

    t_phase = time.perf_counter()
    src = build_model(load_config(SCORE_CONFIG).model, device=torch.device(DEVICE),
                      seed=BRIDGE_SEED)
    sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    # what mmdet's BatchNorm holds and the port's frozen BatchNorm does not
    sd.update({f"{n}.num_batches_tracked": torch.tensor(BRIDGE_SEED) for n, m in
               src.named_modules() if isinstance(m, FrozenBatchNorm)})
    del src
    files = {"reference": sd,
             "mask2former": {k.replace("bbox_head.", "panoptic_head.", 1): v for k, v in sd.items()
                             if k.startswith(M2F_SEGMENTER)}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bridge_")
    orig_load = from_jax.load_pretrained
    runs = {}
    try:
        for name, state_dict in files.items():
            path = os.path.join(tmp, f"{name}.pth")
            torch.save({"meta": {"mmdet_version": "2.25.3", "epoch": 12},
                        "state_dict": state_dict,
                        "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": []}]}},
                       path)
            loaded = {}

            def checked_load(model, load_from, _name=name, _sd=state_dict, _out=loaded):
                """The CLI's load, timed; then every tensor the file names
                equals the file's and every other one its seeded init."""
                init = {k: v.detach().clone() for k, v in model.state_dict().items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig_load(model, load_from)
                torch.cuda.synchronize()
                _out["load_s"] = time.perf_counter() - t0
                state = model.state_dict()
                named = {k.replace("panoptic_head.", "bbox_head.", 1): v for k, v in _sd.items()
                         if not k.endswith(".num_batches_tracked")}
                bad = [k for k, v in named.items() if not torch.equal(state[k].cpu(), v)]
                rest = sorted(set(state) - set(named))
                kept = [k for k in rest if torch.equal(state[k], init[k])]
                check(not bad, f"{_name}: {len(bad)} loaded tensors differ from the file's")
                check(len(kept) == len(rest), f"{_name}: {len(rest) - len(kept)} tensors the "
                                              "file lacks moved from their init")
                if _name == "mask2former":  # PPN and Relation Fusion, at their seeded init
                    check(rest and not any(k.startswith(M2F_SEGMENTER) for k in rest)
                          and any(k.startswith("bbox_head.relation_decoder.") for k in rest)
                          and any(k.startswith("bbox_head.update_importance.") for k in rest),
                          f"mask2former: tensors left at init {rest[:8]}")
                else:
                    check(not rest, f"{_name}: tensors the file lacks {rest[:8]}")
                _out.update(loaded=len(named), kept_init=len(rest),
                            skipped=len(_sd) - len(named))
                return model

            work = os.path.join(tmp, f"work_{name}")
            from_jax.load_pretrained = checked_load
            torch.cuda.synchronize()
            reset_launches()
            count_plain_calls(True)
            try:
                summary = train_cli.main([SCORE_CONFIG, "--work-dir", work, "--device", DEVICE,
                                          "--load-from", path, "--max-epochs", "1",
                                          "--cfg-options", *SCORE_SPLIT])
            finally:
                count_plain_calls(False)
                from_jax.load_pretrained = orig_load
            torch.cuda.synchronize()
            got, steps = launches(), summary["steps"]
            want = {"deform_attn_exact": 6 * steps, "int4": 0,
                    "deform_attn_bwd": {"f32": 6 * steps}, "hungarian": 2 * steps, "plain": {}}
            check(set(loaded) == {"load_s", "loaded", "kept_init", "skipped"},
                  f"{name}: the train CLI did not load {path}")
            check(got == want, f"{name} warm start launches {got}, expected {want}")
            check(all(math.isfinite(v) for v in summary["last"].values()),
                  f"{name} losses {summary['last']}")
            metrics, _, per_fwd = score("sgdet", {}, work_dir=work)
            check(per_fwd == int4_expect, f"scoring the {name} warm start: {per_fwd}")
            runs[name] = {**loaded, "file_mib": os.path.getsize(path) / 2 ** 20,
                          "steps": steps, "s_per_step": summary["seconds"] / steps,
                          "losses": summary["last"], "sgdet": metrics}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"[33] {smi}, {seconds:.1f} s: --load-from a reference .pth (mmcv layout, num_batches_tracked skipped) "
        f"and a Mask2Former one (panoptic_head, segmenter only; PPN and Relation Fusion at "
        f"init), {os.path.relpath(SCORE_CONFIG)} at full width: "
        + "; ".join(f"{n} {r['file_mib']:.1f} MiB loaded in {r['load_s']:.3f} s ({r['loaded']} "
                    f"tensors, {r['kept_init']} at init, {r['skipped']} skipped), "
                    f"{r['steps']} f32 steps of batch 2 at {r['s_per_step']:.3f} s"
                    for n, r in runs.items())
        + "; sgdet (bf16 int4) of each work dir: phase 9's key set, finite")
    return {"seconds": seconds, "runs": runs}


def main():
    # --- (0) the card ---
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from pairnet_torch.bench import gpu_name_and_power_limit, serve, train_batch, train_setup
    from pairnet_torch.flagship import (
        flagship,
        perturb_deform_kernels,
        set_deform_bwd,
        set_deform_impl,
    )
    from pairnet_torch.models import layers as layers_mod
    from pairnet_torch.models import matchers as matchers_mod
    from pairnet_torch.ops import _build
    from pairnet_torch.ops import deform_attn as msda_mod
    from pairnet_torch.ops import deform_attn_bwd as bwd_mod
    from pairnet_torch.ops import deform_attn_exact as exact_mod
    from pairnet_torch.ops.deform_attn import bf16_ulps_off, ms_deform_attn_plain
    from pairnet_torch.ops.deform_attn_bwd import (
        bwd_mismatch,
        deform_attn_bwd,
        ms_deform_attn_bwd_plain,
    )
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.ops import deform_attn_int4 as int4_mod
    from pairnet_torch.ops import deform_attn_int8 as int8_mod
    from pairnet_torch.ops import hungarian as hungarian_mod
    from pairnet_torch.ops import masked_attn as flash_mod
    from pairnet_torch.ops.hungarian import (
        batched_hungarian,
        batched_hungarian_plain,
        prepare,
        solve_n_le_m_cuda,
        solve_n_le_m_plain_steps,
    )
    from pairnet_torch.ops.deform_attn_int4 import (
        int4_gather,
        int4_gather_plain,
        int4_quantize,
        int4_quantize_plain,
    )
    from pairnet_torch.ops.deform_attn_int8 import (
        int8_gather,
        int8_gather_plain,
        int8_quantize,
        int8_quantize_plain,
    )
    from pairnet_torch.ops.masked_attn import (
        masked_flash_attention,
        masked_flash_attention_plain,
    )
    from pairnet_torch.tools.msda_kernels import cuda_ms, graph_nodes, kernel_split
    from pairnet_torch.train import trainer as trainer_mod

    smi = gpu_name_and_power_limit()
    dev = torch.device(DEVICE)
    device_kind = torch.cuda.get_device_name(0)
    log(f"[0] gpu: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {device_kind}")
    wrappers = {"deform_attn_exact": deform_attn_exact, "int4_quantize": int4_quantize,
                "int4_gather": int4_gather}
    served_names = {"deform_attn_exact": ("exact_kernel",),
                    "int4_quantize": ("absmax_kernel", "quantize_kernel"),
                    "int4_gather": ("gather_kernel",)}

    def served_kernels(fn, expect, windows=3):
        """The MSDA calls that one call of ``fn`` runs on the card, by the
        profiler's names of the port's kernels (``served_names``: each
        call's kernels, as many of each): a serving forward replays CUDA
        graphs, whose kernels launch without their wrappers, so the
        wrappers' counts read 0 there.
        A window whose counts differ from ``expect`` is profiled again, up to
        ``windows`` times (the profiler has lost records of a call)."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(windows):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # the exported trace holds every kernel record; ``prof.events()``
            # may leave out those that no operator launched (a graph's)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                             if str(e.get("cat", "")).lower() == "kernel"]
            got = {}
            for call, kernels in served_names.items():
                n = {sum(f"(anonymous namespace)::{k}<" in name for name in names)
                     for k in kernels}
                got[call] = n.pop() if len(n) == 1 else f"uneven {sorted(n)}"
            if got == expect:
                break
        return got

    # --- (1) build ---
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[1] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # --- (2) kernels against their plain versions, wide offsets ---
    # each compare_* checks its kernel's tolerance and returns max |kernel - plain|
    def compare_exact_f32(k, p):
        d = float((k - p).abs().max())
        check(d <= TOL_EXACT_F32, f"deform_attn_exact f32: max|d| {d} > {TOL_EXACT_F32}")
        return d

    def compare_exact_bf16(k, p):
        rel = float((k - p).abs().max() / p.abs().max())
        check(k.dtype == torch.float32 and rel <= TOL_EXACT_BF16_REL,
              f"deform_attn_exact bf16 values: rel {rel} > {TOL_EXACT_BF16_REL}")
        return rel

    def compare_quantize(k, p, name="int4_quantize"):
        check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
              f"{name}: codes and scales not bit-equal to plain")
        return max(float((k[0].int() - p[0].int()).abs().max()), float((k[1] - p[1]).abs().max()))

    def compare_gather(k, p, name="int4_gather"):
        n_over = bf16_ulps_off(k, p)
        check(k.dtype == torch.bfloat16 and n_over == 0,
              f"{name}: {n_over} outputs beyond 1 bf16 ulp of plain")
        return float((k.float() - p.float()).abs().max())

    def compare_gather_f32(k, p):
        rel = float((k - p).abs().max() / p.abs().max())
        check(k.dtype == torch.float32 and rel <= TOL_EXACT_BF16_REL / 10,
              f"int8_gather f32 out: rel {rel} > {TOL_EXACT_BF16_REL / 10}")
        return rel

    def compare_flash(k, p):
        d = float((k - p).abs().max())
        bound = TOL_FLASH * max(1.0, float(p.abs().max()))
        check(k.dtype == torch.float32 and d <= bound, f"masked_attn: max|d| {d} > {bound}")
        return d

    def compare_bwd(k, p):
        err, failures = bwd_mismatch(k, p)
        check(not failures, f"deform_attn_bwd: {failures}")
        return err

    def bwd_inputs(value, bwd):
        """(kernel call, plain call) of the backward instance that runs
        ``bwd`` on values of this dtype."""
        return (lambda v, lc, wt, g: deform_attn_bwd(v, SHAPES, lc, wt, g, bwd),
                lambda v, lc, wt, g: ms_deform_attn_bwd_plain(v, SHAPES, lc, wt, g,
                                                              bf16_grad=bwd == "bf16_grad"))

    v32, locs, w = msda_inputs(CHECK_BATCH, torch.float32, 0, dev)
    e_f32 = compare_exact_f32(deform_attn_exact(v32, SHAPES, locs, w),
                              ms_deform_attn_plain(v32, SHAPES, locs, w))
    vb = v32.to(torch.bfloat16)
    rel_bf16 = compare_exact_bf16(deform_attn_exact(vb, SHAPES, locs, w),
                                  ms_deform_attn_plain(vb, SHAPES, locs, w))
    codes, scales = int4_quantize(vb, SHAPES)
    compare_quantize((codes, scales), int4_quantize_plain(vb, SHAPES))
    e_gather = compare_gather(int4_gather(codes, scales, SHAPES, locs, w),
                              int4_gather_plain(codes, scales, SHAPES, locs, w))
    g_wide = torch.randn((CHECK_BATCH, v32.shape[1], H * D), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    e_bwd = {}
    for inst, (val, bwd) in {"f32": (v32, "exact"), "bf16": (vb, "exact"),
                             "bf16_grad": (vb, "bf16_grad")}.items():
        kernel_fn, plain_fn = bwd_inputs(val, bwd)
        e_bwd[inst] = compare_bwd(kernel_fn(val, locs, w, g_wide), plain_fn(val, locs, w, g_wide))
    e_int8 = {}
    for name, val in (("bf16", vb), ("f32", v32)):
        codes, scales = int8_quantize(val, SHAPES)
        compare_quantize((codes, scales), int8_quantize_plain(val, SHAPES), "int8_quantize")
        e_int8[f"gather bf16 out, {name} codes"] = compare_gather(
            int8_gather(codes, scales, SHAPES, locs, w),
            int8_gather_plain(codes, scales, SHAPES, locs, w), "int8_gather")
        e_int8[f"gather f32 out rel, {name} codes"] = compare_gather_f32(
            int8_gather(codes, scales, SHAPES, locs, w, torch.float32),
            int8_gather_plain(codes, scales, SHAPES, locs, w, torch.float32))
    e_flash = {}
    for Lk in (SHAPES[1][0] * SHAPES[1][1], SHAPES[2][0] * SHAPES[2][1]):
        for dname, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q, k, v, mask = flash_inputs(CHECK_BATCH, Lk, dt, 3, dev)
            e_flash[f"Lk {Lk} {dname}"] = compare_flash(
                masked_flash_attention(q, k, v, mask, H),
                masked_flash_attention_plain(q, k, v, mask, H))
    del q, k, v, mask
    torch.cuda.synchronize()
    log(f"[2] kernel vs plain (batch {CHECK_BATCH}, levels {SHAPES}, wide offsets): exact f32 "
        f"max|d| {e_f32:.3g} (tol {TOL_EXACT_F32}); exact bf16 rel {rel_bf16:.3g} "
        f"(tol {TOL_EXACT_BF16_REL}); int4_quantize codes+scales bit-equal; "
        f"int4_gather max|d| {e_gather:.3g}, all within 1 bf16 ulp; deform_attn_bwd max|d| "
        f"{ {k: f'{v:.3g}' for k, v in e_bwd.items()} } (f32 outputs within "
        f"{bwd_mod.BWD_TOLERANCE} x max|plain|, bf16 dvalue within 1 bf16 ulp); int8_quantize "
        f"codes+scales bit-equal on bf16 and f32 values; int8_gather "
        f"{ {k: f'{v:.3g}' for k, v in e_int8.items()} } (bf16 out within 1 bf16 ulp, f32 out "
        f"within {TOL_EXACT_BF16_REL / 10} x max|plain|); masked_attn max|d| "
        f"{ {k: f'{v:.3g}' for k, v in e_flash.items()} } (tol {TOL_FLASH} x max(1, max|plain|))")
    del v32, vb, locs, w, codes, scales, g_wide

    # capture the MSDA inputs that a forward hands to the kernels, the
    # first encoder layer's per (impl, value dtype)
    captured = {}
    orig_msda = layers_mod.ms_deform_attn

    def capturing(value, shapes, locs, weights, impl=None, bwd="exact"):
        key = (impl, value.dtype)
        if key not in captured:
            captured[key] = tuple(t.detach().clone() for t in (value, locs, weights))
        return orig_msda(value, shapes, locs, weights, impl=impl, bwd=bwd)

    # --- (3) full-width serving, bf16, int4 ---
    B, h4, w4 = BATCH, IMG[0] // 4, IMG[1] // 4
    model = perturb_deform_kernels(flagship(device=dev, dtype=torch.bfloat16, seed=0))
    set_deform_impl(model, "int4")
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((B, *IMG, 3), generator=g, device=dev).to(torch.bfloat16)
    # the first request captures the forward's CUDA graphs (``bench.serve``),
    # running each segment's Python twice: its warm-up and its capture
    expect_launches = {"deform_attn_exact": 0, "int4_quantize": 6, "int4_gather": 6}
    for fn in wrappers.values():
        fn.launches = 0
    layers_mod.ms_deform_attn = capturing
    serve(model, images)  # captures the first encoder layer's inputs
    layers_mod.ms_deform_attn = orig_msda
    torch.cuda.synchronize()
    capture_launches = {n: fn.launches for n, fn in wrappers.items()}
    check(capture_launches == {n: 2 * k for n, k in expect_launches.items()},
          f"capturing request's launches {capture_launches}")
    replayed = []
    serving_launches = served_kernels(lambda: replayed.append(serve(model, images)),
                                      expect_launches)
    out, preds = replayed[-1]
    del replayed
    check(serving_launches == expect_launches, f"serving launches {serving_launches}")
    expect = {"cls": (B, 100, 134), "mask": (B, 100, h4, w4), "rel": (B, 100, 56),
              "importance": (B, 100, 100), "sub_pos": (B, 100), "obj_pos": (B, 100),
              "queries": (B, 100, 256)}
    for key, shape in expect.items():
        check(tuple(out[key].shape) == shape, f"{key} shape {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key].float()).all()), f"{key} finite")
    check(len(preds) == B, f"{len(preds)} predictions")
    for pr in preds:
        check(tuple(pr.pan_seg.shape) == (h4, w4) and tuple(pr.labels.shape) == (200,),
              "prediction shapes")
        check(bool(((pr.r_scores >= 0) & (pr.r_scores <= 1)).all()), "r_scores in [0, 1]")
    log(f"[3] serving batch {B} bf16 int4 at {IMG[0]}x{IMG[1]}: launches {serving_launches} "
        f"(the replay's kernels; the capturing request's wrappers {capture_launches}); "
        f"outputs finite with the expected shapes; {len(preds)} predictions; kept segments "
        f"per image {[int(torch.unique(pr.pan_seg).numel()) for pr in preds]}")

    # --- (4) f32 forward: exact kernel vs plain MSDA ---
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def exact_vs_plain(model32, img32, capture=False):
        """One f32 forward (TF32 off) through the exact kernel against the
        same forward through the plain MSDA: (max |d| per output, decided
        top-k ranks, attention-mask bits the plain run would set otherwise,
        exact launches). The plain run reuses the exact run's attention
        masks, so one borderline sigmoid < 0.5 bit cannot make the runs
        diverge; the bits it would have set differently are counted."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dec = model32.bbox_head.transformer_decoder
        set_deform_impl(model32, "exact")
        masks = Replay(lambda *a: type(dec).attn_mask_small(dec, *a),
                       lambda own, kept: int((own != kept).sum()))
        dec.attn_mask_small = masks
        for fn in wrappers.values():
            fn.launches = 0
        if capture:
            layers_mod.ms_deform_attn = capturing
        with torch.inference_mode():
            out_e = model32(img32)
        layers_mod.ms_deform_attn = orig_msda
        torch.cuda.synchronize()
        n_exact = deform_attn_exact.launches
        check(n_exact == 6, f"exact launches {n_exact}")
        masks.start_replay()
        set_deform_impl(model32, "plain")
        with torch.inference_mode():
            out_p = model32(img32)
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        errs = {}
        for key in ("cls", "mask", "importance", "queries", "rel"):
            ref = out_p[key].float()
            errs[key] = float((out_e[key].float() - ref).abs().max())
            bound = TOL_FORWARD_REL * max(1.0, float(ref.abs().max()))
            check(errs[key] <= bound, f"{key}: exact vs plain {errs[key]} > {bound}")
        ok = decided_ranks(out_p["importance"][0], 100, errs["importance"] * 10 + 1e-6)
        check(torch.equal(out_e["sub_pos"][0][ok], out_p["sub_pos"][0][ok])
              and torch.equal(out_e["obj_pos"][0][ok], out_p["obj_pos"][0][ok]),
              "pair indices at decided ranks")
        return errs, int(ok.sum()), masks.flips, n_exact

    model32 = perturb_deform_kernels(flagship(device=dev, dtype=torch.float32, seed=0))
    fwd_err, n_decided, flips4, exact_launches = exact_vs_plain(model32, images[:1].float(),
                                                                capture=True)
    log(f"[4] f32 batch 1, exact kernel vs plain MSDA (TF32 off): max|d| "
        f"{ {k: f'{v:.3g}' for k, v in fwd_err.items()} } (tol {TOL_FORWARD_REL} x "
        f"max(1, max|plain|)); pair indices equal at {n_decided}/100 decided ranks; "
        f"{flips4} attention-mask bits the plain run would set otherwise; "
        f"exact launches {exact_launches}")
    del model32

    # --- (5) kernels on the main paths' inputs; timings ---
    serve_ms = cuda_ms(torch, lambda: serve(model, images), 3)
    img_per_s = B * 1000.0 / serve_ms
    log(f"[5] serving: {serve_ms:.2f} ms per batch of {B} = {img_per_s:.2f} img/s")

    kernels = []

    def record(name, launches, kernel_fn, plain_fn, compare, in_t, flops, note, phase=5,
               library_fn=None, peak_flops=F32_FLOPS, in_bytes=None, **where):
        """Check the kernel against its plain version on the main path's
        inputs, time both (and ``library_fn``, one PyTorch call of the same
        function, where there is one), and add the kernel's entry
        (``where``: source, replaces) unless ``launches`` is None. Returns
        (the kernel's output, the entry). The bound's operations term runs at
        ``peak_flops``: the rate of the units and type the kernel's products
        use; its bytes term reads ``in_t`` once, or ``in_bytes`` when given
        (the bytes this run's data needs, where it reads only some)."""
        out, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        d = compare(out, ref)
        del ref
        ms = cuda_ms(torch, kernel_fn, 10)
        device_ms = cuda_ms(torch, kernel_fn, 10, spin=True)
        plain_ms = cuda_ms(torch, plain_fn, 2)
        library_ms = None if library_fn is None else cuda_ms(torch, library_fn, 10)
        out_t = out if isinstance(out, tuple) else (out,)
        moved = nbytes(*out_t) + (nbytes(*in_t) if in_bytes is None else in_bytes)
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak_flops * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        entry = {
            "name": name, "route": "cuda", **where, "launches": launches, "max_abs_err": d,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": bound_by, "library_ms": library_ms,
            "bound_terms_ms": {"bytes": t_bytes, "operations": t_ops},
        }
        if launches is not None:
            kernels.append(entry)
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"[{phase}] {name} ({note}): vs plain {d:.3g} within tolerance; {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms{lib}, behind a spin {device_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({bound_by}: bytes "
            f"{t_bytes:.4f}, ops {t_ops:.4f})")
        return out, entry

    def quantize_passes(fn, name, phase=5):
        """The device work of one quantize call: its two passes and no other
        kernel (profiler names), and exactly two kernels and nothing else
        on the card (the call captured as a CUDA graph); kept in the
        kernel's entry."""
        split = kernel_split(torch, fn, 10)
        passes = {p: e for k, e in split.items() for p in ("absmax_kernel", "quantize_kernel")
                  if f"::{p}<" in k}
        nodes = graph_nodes(torch, fn)
        check(len(split) == len(passes) == 2 and nodes == {"kernel": 2},
              f"{name}: kernels {split}, graph nodes per call {nodes}")
        kernels[-1]["kernels_per_call"] = split
        kernels[-1]["graph_nodes_per_call"] = nodes
        log(f"[{phase}] {name}: each call launches each of its two passes once and no fill: "
            + ", ".join(f"{p} {e['ms']:.4f} ms" for p, e in passes.items()))

    L = len(SHAPES)

    def tap_flops(lc):  # ~10 operations per (b, q, h, d, level, point)
        return 10 * lc.shape[0] * lc.shape[1] * H * D * L * P

    v, lc, wt = captured[("exact", torch.float32)]
    record("deform_attn_exact", exact_launches, lambda: deform_attn_exact(v, SHAPES, lc, wt),
           lambda: ms_deform_attn_plain(v, SHAPES, lc, wt), compare_exact_f32, (v, lc, wt),
           tap_flops(lc), "f32 forward batch 1, encoder layer 0, max|d|",
           source="pairnet_torch/csrc/deform_attn_exact.cu",
           replaces="pairnet_tpu/ops/pallas_deform_attn_v6.py:86 (f32), "
                    "pairnet_tpu/ops/pallas_deform_attn_v7.py:88 (bf16)")
    v, lc, wt = captured[("int4", torch.bfloat16)]
    # the exact kernel's bf16 instance (the v7 case) on the serving inputs;
    # checked and logged, no entry: the serving path runs the int4 kernels
    record("deform_attn_exact", None, lambda: deform_attn_exact(v, SHAPES, lc, wt),
           lambda: ms_deform_attn_plain(v, SHAPES, lc, wt), compare_exact_bf16, (v, lc, wt),
           tap_flops(lc), f"bf16 values, bf16 serving batch {B}, encoder layer 0, rel")
    (codes, scales), _ = record(
        "int4_quantize", serving_launches["int4_quantize"], lambda: int4_quantize(v, SHAPES),
        lambda: int4_quantize_plain(v, SHAPES), compare_quantize, (v,), 5 * v.numel(),
        f"bf16 serving batch {B}, encoder layer 0, max|d| of codes and scales",
        source="pairnet_torch/csrc/deform_attn_quant.cu",
        replaces="pairnet_tpu/ops/pallas_deform_attn_v16.py:54")
    quantize_passes(lambda: int4_quantize(v, SHAPES), "int4_quantize")
    record("int4_gather", serving_launches["int4_gather"],
           lambda: int4_gather(codes, scales, SHAPES, lc, wt),
           lambda: int4_gather_plain(codes, scales, SHAPES, lc, wt), compare_gather,
           (codes, scales, lc, wt), tap_flops(lc),
           f"bf16 serving batch {B}, encoder layer 0, max|d|, all within 1 bf16 ulp",
           source="pairnet_torch/csrc/deform_attn_quant.cu",
           replaces="pairnet_tpu/ops/pallas_deform_attn_v16.py:106")

    del model, images, out, preds, codes, scales, v, lc, wt
    captured.clear()
    torch.cuda.empty_cache()

    # --- (6) full-width bf16 training through the MSDA kernels ---
    from pairnet_torch.models.layers import MSDeformAttention
    from pairnet_torch.train.trainer import to_device

    captured_bwd = {}  # value dtype -> the backward's inputs of encoder layer 0
    orig_bwd = bwd_mod.deform_attn_bwd

    def capturing_bwd(value, shapes, locs, weights, g, bwd="exact"):
        # the backward runs the layers last to first: the last call of a
        # step is encoder layer 0's
        captured_bwd[value.dtype] = tuple(t.detach().clone() for t in (value, locs, weights, g))
        return orig_bwd(value, shapes, locs, weights, g, bwd)

    # the wrapper counts its launches on the module's deform_attn_bwd
    capturing_bwd.launches = orig_bwd.launches

    captured_hung = []  # the inputs of the step's two matchers' Hungarian calls
    recorded_hung = []  # (inputs, outputs) of every Hungarian call while recording
    orig_hung = matchers_mod.batched_hungarian

    def capturing_hung(cost, row_mask=None, col_mask=None):
        if len(captured_hung) < 2:
            captured_hung.append(tuple(None if t is None else t.detach().clone()
                                       for t in (cost, row_mask, col_mask)))
        return orig_hung(cost, row_mask, col_mask)

    def recording_hung(cost, row_mask=None, col_mask=None):
        out = orig_hung(cost, row_mask, col_mask)
        recorded_hung.append(((cost.detach().clone(), row_mask, col_mask), out))
        return out

    plain_calls = collections.Counter()
    plain_fns = [(msda_mod, "ms_deform_attn_plain"), (exact_mod, "ms_deform_attn_plain"),
                 (bwd_mod, "ms_deform_attn_bwd_plain"), (hungarian_mod, "solve_n_le_m_plain")]

    def count_plain_calls(on):
        """Count every call of a plain MSDA version while ``on``."""
        for mod, name in plain_fns:
            fn = getattr(mod, name)
            if on:
                def counted(*a, _fn=fn, _name=name, **k):
                    plain_calls[_name] += 1
                    return _fn(*a, **k)
                counted.orig = fn
                setattr(mod, name, counted)
            else:
                setattr(mod, name, fn.orig)

    def reset_launches():
        deform_attn_exact.launches = int4_quantize.launches = int4_gather.launches = 0
        batched_hungarian.launches = 0
        deform_attn_bwd.launches.clear()
        plain_calls.clear()

    def launches():
        return {"deform_attn_exact": deform_attn_exact.launches,
                "int4": int4_quantize.launches + int4_gather.launches,
                "deform_attn_bwd": dict(deform_attn_bwd.launches),
                "hungarian": batched_hungarian.launches, "plain": dict(plain_calls)}

    def finite(metrics):
        return all(bool(torch.isfinite(v)) for v in metrics.values())

    model_t, state, step = train_setup(dev)  # bf16 compute, exact forward and backward
    batch = to_device(train_batch(TRAIN_BATCH, IMG), dev)
    head0 = model_t.bbox_head.rel_cls_embed.weight.detach().clone()
    stem0 = model_t.backbone.conv1.weight.detach().clone()
    layers_mod.ms_deform_attn, bwd_mod.deform_attn_bwd = capturing, capturing_bwd
    matchers_mod.batched_hungarian = capturing_hung
    m_warm = step(state, batch)  # warm-up; captures encoder layer 0's MSDA inputs
    layers_mod.ms_deform_attn, bwd_mod.deform_attn_bwd = orig_msda, orig_bwd
    matchers_mod.batched_hungarian = orig_hung
    torch.cuda.synchronize()
    cum0 = float(state.cum_samples.sum())
    reset_launches()
    syncs0 = batched_hungarian.syncs
    count_plain_calls(True)
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = [step(state, batch) for _ in range(TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    train_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    train_launches = launches()
    train_syncs = batched_hungarian.syncs - syncs0
    n = 6 * TRAIN_STEPS
    check(train_launches == {"deform_attn_exact": n, "int4": 0, "deform_attn_bwd": {"bf16": n},
                             "hungarian": 2 * TRAIN_STEPS, "plain": {}},
          f"training launches {train_launches}")
    check(train_syncs == 0, f"the Hungarian synced with the host {train_syncs} times")
    set_deform_bwd(model_t, "bf16_grad")
    reset_launches()
    metrics.append(step(state, batch))
    torch.cuda.synchronize()
    grad_launches = launches()
    count_plain_calls(False)
    check(grad_launches == {"deform_attn_exact": 6, "int4": 0, "deform_attn_bwd": {"bf16_grad": 6},
                            "hungarian": 2, "plain": {}},
          f"bf16_grad step launches {grad_launches}")
    for m in [m_warm] + metrics:
        check(finite(m) and float(m["grad_norm"]) > 0, f"train metrics {m}")
    check(not torch.equal(model_t.bbox_head.rel_cls_embed.weight, head0), "head weight moved")
    check(torch.equal(model_t.backbone.conv1.weight, stem0), "frozen stem unchanged")
    check(float(state.cum_samples.sum()) > cum0 > 0, "Seesaw counts grew")
    msda_layers = [m for m in model_t.modules() if isinstance(m, MSDeformAttention)]
    offs_grad = [float(m.sampling_offsets.weight.grad.abs().max()) for m in msda_layers]
    check(len(msda_layers) == 6 and min(offs_grad) > 0,
          f"sampling_offsets gradients of the encoder layers {offs_grad}")
    last = {k: float(v) for k, v in metrics[-2].items()}
    train_img_s = TRAIN_BATCH * 1000.0 / train_ms
    log(f"[6] training batch {TRAIN_BATCH} bf16 at {IMG[0]}x{IMG[1]}: {train_ms:.1f} ms per step "
        f"= {train_img_s:.2f} img/s, peak {peak_gib:.2f} GiB; launches in {TRAIN_STEPS} steps "
        f"{train_launches}, bf16_grad step {grad_launches}; Hungarian host syncs {train_syncs}; "
        f"losses finite, grad_norm "
        f"{[round(float(m['grad_norm']), 4) for m in metrics]}; head moved, stem unchanged; "
        f"cum_samples {cum0:.0f} -> {float(state.cum_samples.sum()):.0f}; sampling_offsets "
        f"grad max per layer {[f'{g:.3g}' for g in offs_grad]}; last exact-step losses {last}")
    del model_t, state, step, metrics, m_warm, msda_layers
    torch.cuda.empty_cache()

    # --- (7) f32 train step: MSDA kernels vs plain MSDA ---
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch1 = to_device(train_batch(1, IMG), dev)
    masks_r = Replay(None, lambda own, kept: int((own != kept).sum()))
    pairs_r = Replay(None, lambda own, kept: sum(int((o != k).sum()) for o, k in zip(own, kept)))
    fields = ("r_labels", "r_weights", "sub_ids", "obj_ids", "gt_importance", "query2gt")
    targets_r = Replay(trainer_mod.pairnet_targets, lambda own, kept: sum(
        int((getattr(own, f) != getattr(kept, f)).sum()) for f in fields))
    orig_targets = trainer_mod.pairnet_targets
    runs = {}
    for impl in ("exact", "plain"):
        model_f, state_f, step_f = train_setup(dev, compute_dtype=None)
        set_deform_impl(model_f, impl)
        dec, head = model_f.bbox_head.transformer_decoder, model_f.bbox_head
        masks_r.fn = lambda *a, dec=dec: type(dec).attn_mask_small(dec, *a)
        pairs_r.fn = lambda imp, head=head: type(head).pair_topk(head, imp)
        dec.attn_mask_small, head.pair_topk = masks_r, pairs_r
        trainer_mod.pairnet_targets = targets_r
        if impl == "plain":
            for r in (masks_r, pairs_r, targets_r):
                r.start_replay()
        reset_launches()
        bwd_mod.deform_attn_bwd = capturing_bwd
        if impl == "exact":
            matchers_mod.batched_hungarian = recording_hung
        m = {k: float(v) for k, v in step_f(state_f, batch1).items()}
        bwd_mod.deform_attn_bwd = orig_bwd
        matchers_mod.batched_hungarian = orig_hung
        trainer_mod.pairnet_targets = orig_targets
        torch.cuda.synchronize()
        grads = {f"{name}.{pn}": p.grad.detach().clone()
                 for name, mod in model_f.named_modules() if isinstance(mod, MSDeformAttention)
                 for pn, p in mod.named_parameters()}
        runs[impl] = (m, grads, launches())
        del model_f, state_f, step_f
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (m_k, g_k, l_k), (m_p, g_p, l_p) = runs["exact"], runs["plain"]
    check(l_k["deform_attn_exact"] == 6 and l_k["deform_attn_bwd"] == {"f32": 6}
          and l_k["hungarian"] == 2, f"f32 kernel step launches {l_k}")
    # the plain loop on the kernel run's own costs: the same assignments
    hung_diff = 0
    for (cost, rm, cm), (r2c, c2r) in recorded_hung:
        p_r2c, p_c2r = batched_hungarian_plain(cost, rm, cm)
        hung_diff += int((p_r2c != r2c).sum()) + int((p_c2r != c2r).sum())
    check(len(recorded_hung) == 2 and hung_diff == 0,
          f"{hung_diff} Hungarian assignments differ from the plain loop's")
    check(l_p["deform_attn_exact"] == 0 and not l_p["deform_attn_bwd"],
          f"plain step launches {l_p}")
    loss_err, grad_err, grad_rel = {}, {}, 0.0
    for k, ref in m_p.items():
        loss_err[k] = abs(m_k[k] - ref)
        check(loss_err[k] <= TOL_TRAIN_REL * max(1.0, abs(ref)), f"f32 step {k}: {m_k[k]} vs {ref}")
    check(len(g_k) == len(g_p) == 6 * 8, f"{len(g_k)} MSDA parameter gradients")
    for k, ref in g_p.items():
        d = float((g_k[k] - ref).abs().max())
        scale = float(ref.abs().max())
        grad_err[k] = d
        grad_rel = max(grad_rel, d / max(scale, 1e-30))
        check(d <= TOL_TRAIN_REL * scale, f"f32 step grad {k}: max|d| {d} (max {scale})")
    flips = {"attention-mask bits": masks_r.flips, "pair indices": pairs_r.flips,
             "target entries": targets_r.flips}
    log(f"[7] f32 train step batch 1, MSDA kernels vs plain (TF32 off): losses max|d| "
        f"{max(loss_err.values()):.3g}; {len(g_k)} MSDA parameter gradients max|d| "
        f"{max(grad_err.values()):.3g}, largest relative to their max {grad_rel:.3g} (tol "
        f"{TOL_TRAIN_REL} x max|plain| of each gradient); the plain run would have set "
        f"otherwise: {flips}; kernel-run launches {l_k}; Hungarian assignments that differ "
        f"from the plain loop's on the kernel run's costs: {hung_diff}")
    del runs, g_k, g_p, batch1

    # --- (8) the training kernels on the training paths' inputs ---
    def bwd_ops(lc, value, bwd):
        return BWD_OPS_PER_CORNER[bwd] * value.shape[3] * inside_corners(lc)

    v, lc, wt = captured[("exact", torch.bfloat16)]
    record("deform_attn_exact (bf16 values)", train_launches["deform_attn_exact"],
           lambda: deform_attn_exact(v, SHAPES, lc, wt),
           lambda: ms_deform_attn_plain(v, SHAPES, lc, wt), compare_exact_bf16, (v, lc, wt),
           tap_flops(lc), f"bf16 training batch {TRAIN_BATCH}, encoder layer 0, rel", phase=8,
           source="pairnet_torch/csrc/deform_attn_exact.cu",
           replaces="pairnet_tpu/ops/pallas_deform_attn_v7.py:88")
    kernels[-1]["launches_per_step"] = train_launches["deform_attn_exact"] / TRAIN_STEPS
    bwd_where = {"source": "pairnet_torch/csrc/deform_attn_bwd.cu"}
    rows_56 = ("pairnet_tpu/ops/pallas_deform_bwd2.py:55 (default VJP), "
               "pairnet_tpu/ops/pallas_deform_attn_v6.py:264 (parity anchor)")
    # (instance, value dtype, variant, launches, the steps they came from, path)
    for inst, key, bwd, n_launch, steps, what in (
            ("f32", torch.float32, "exact", l_k["deform_attn_bwd"].get("f32", 0), 1,
             "f32 training batch 1"),
            ("bf16", torch.bfloat16, "exact", train_launches["deform_attn_bwd"].get("bf16", 0),
             TRAIN_STEPS, f"bf16 training batch {TRAIN_BATCH}"),
            ("bf16_grad", torch.bfloat16, "bf16_grad",
             grad_launches["deform_attn_bwd"].get("bf16_grad", 0), 1,
             f"bf16 training batch {TRAIN_BATCH}")):
        v, lc, wt, g = captured_bwd[key]
        kernel_fn, plain_fn = bwd_inputs(v, bwd)
        record(f"deform_attn_bwd ({inst})", n_launch, lambda: kernel_fn(v, lc, wt, g),
               lambda: plain_fn(v, lc, wt, g), compare_bwd, (v, lc, wt, g), bwd_ops(lc, v, bwd),
               f"{what}, encoder layer 0, max|d|", phase=8, **bwd_where,
               replaces=("pairnet_tpu/ops/pallas_deform_bwd3.py:55" if inst == "bf16_grad"
                         else rows_56))
        kernels[-1]["launches_per_step"] = n_launch / steps

    del captured_bwd
    captured.clear()
    torch.cuda.empty_cache()

    # --- (9) score with the CLI: flagship config, bf16, int4 ---
    from pairnet_torch import native
    from pairnet_torch.config import load_config
    from pairnet_torch.tools import test as cli

    plain_fns.extend([(int4_mod, "int4_quantize_plain"), (int4_mod, "int4_gather_plain"),
                      (int8_mod, "int8_quantize_plain"), (int8_mod, "int8_gather_plain"),
                      (flash_mod, "masked_flash_attention_plain")])
    n_dec = load_config(SCORE_CONFIG).model.bbox_head.num_decoder_layers
    # the decoder's layer i attends over level i % L, low to high resolution
    flash_layers = sum(SHAPES[i % L][0] * SHAPES[i % L][1] >= layers_mod.FLASH_MIN_KEYS
                       for i in range(n_dec))
    forwards = [0]
    orig_apply_fn = cli.make_apply_fn

    def counting_apply_fn(*args):
        apply_fn = orig_apply_fn(*args)

        def counted(images):
            forwards[0] += 1
            return apply_fn(images)
        return counted

    flash_caps, flash_calls = {}, collections.Counter()  # (Lk, dtype) -> first inputs, calls
    orig_flash = layers_mod.masked_flash_attention

    def capturing_flash(q, k, v, mask, num_heads):
        key = (k.shape[1], q.dtype)
        flash_calls[key] += 1
        if key not in flash_caps:
            flash_caps[key] = tuple(t.detach().clone() for t in (q, k, v, mask))
        return orig_flash(q, k, v, mask, num_heads)

    def score_counts():
        return {"int4_quantize": int4_quantize.launches, "int4_gather": int4_gather.launches,
                "int8_quantize": dict(int8_quantize.launches),
                "int8_gather": dict(int8_gather.launches),
                "masked_attn": masked_flash_attention.launches,
                "deform_attn_exact": deform_attn_exact.launches, "plain": dict(plain_calls)}

    def score(what, env, dtype="bf16", capture=False, work_dir=None, config=SCORE_CONFIG,
              extra=(), split_opts=SCORE_SPLIT, device=DEVICE):
        """One run of ``pairnet_torch.tools.test.main`` on ``config`` and the
        split of ``split_opts`` with the environment ``env`` (on the
        checkpoint of ``work_dir`` if given, else random weights) and the
        ``extra`` arguments, on ``device`` (None: the CLI's default): its
        metrics after the key-set and finiteness checks, and the kernel
        launches of the run per forward."""
        saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN")}
        os.environ.update(env)
        cli.make_apply_fn = counting_apply_fn
        if capture:
            layers_mod.ms_deform_attn = capturing
            layers_mod.masked_flash_attention = capturing_flash
        torch.cuda.synchronize()
        int4_quantize.launches = int4_gather.launches = deform_attn_exact.launches = 0
        masked_flash_attention.launches = 0
        int8_quantize.launches.clear()
        int8_gather.launches.clear()
        plain_calls.clear()
        forwards[0] = 0
        count_plain_calls(True)
        try:
            metrics = cli.main([config, *([work_dir] if work_dir else []), "--eval", what,
                                "--batch-size", str(BATCH), "--dtype", dtype,
                                *(["--device", device] if device else []), *extra,
                                "--cfg-options", *split_opts])
            torch.cuda.synchronize()
        finally:
            count_plain_calls(False)
            cli.make_apply_fn = orig_apply_fn
            layers_mod.ms_deform_attn, layers_mod.masked_flash_attention = orig_msda, orig_flash
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        counts = score_counts()
        nf = forwards[0]
        check(nf == -(-SCORE_IMAGES // BATCH), f"{nf} forwards for {SCORE_IMAGES} images")
        keys = SGDET_KEYS if what == "sgdet" else PQ_KEYS
        check(set(metrics) == keys, f"{what} metric keys {sorted(set(metrics) ^ keys)} differ")
        check(all(math.isfinite(v) for v in metrics.values()), f"{what} metrics {metrics}")
        per_fwd = {k: ({i: n / nf for i, n in v.items()} if isinstance(v, dict) else v / nf)
                   for k, v in counts.items() if k != "plain"}
        per_fwd["plain"] = counts["plain"]
        return metrics, counts, per_fwd

    int4_expect = {"int4_quantize": 6, "int4_gather": 6, "int8_quantize": {}, "int8_gather": {},
                   "masked_attn": 0, "deform_attn_exact": 0, "plain": {}}
    runs = {}
    for what in ("sgdet", "PQ"):
        metrics, counts, per_fwd = score(what, {})
        check(per_fwd == int4_expect, f"int4 {what} scoring launches per forward {per_fwd}")
        runs[f"bf16 int4 {what}"] = (metrics, counts, per_fwd)
    log(f"[9] scored {os.path.relpath(SCORE_CONFIG)} on {SCORE_IMAGES} synthetic 800x1333 images, batch {BATCH}, "
        f"bf16, int4 (native preprocessing {native.available()}): sgdet "
        f"{runs['bf16 int4 sgdet'][0]['sgdet_images_per_s']} img/s, PQ "
        f"{runs['bf16 int4 PQ'][0]['PQ_images_per_s']} img/s; metric key sets as the JAX "
        f"engines', values finite; launches per forward {runs['bf16 int4 sgdet'][2]}")

    # --- (10) score with the int8 kernels and the flash cross-attention ---
    for name, env, what, dtype in (
            ("bf16 int8 flash sgdet", {"PAIRNET_DEFORM_IMPL": "pallas_v12"}, "sgdet", "bf16"),
            ("bf16 int8 flash PQ", {"PAIRNET_DEFORM_IMPL": "pallas_v12"}, "PQ", "bf16"),
            ("bf16 int8 (v14) flash sgdet", {"PAIRNET_DEFORM_IMPL": "pallas_v14"}, "sgdet", "bf16"),
            ("f32 int8 flash sgdet", {"PAIRNET_DEFORM_IMPL": "pallas_v12"}, "sgdet", "f32")):
        metrics, counts, per_fwd = score(what, {**env, "PAIRNET_FLASH_ATTN": "1"}, dtype,
                                         capture=name in ("bf16 int8 flash sgdet",
                                                          "f32 int8 flash sgdet"))
        inst = "bf16" if dtype == "bf16" else "f32"
        expect = {"int4_quantize": 0, "int4_gather": 0, "int8_quantize": {inst: 6},
                  "int8_gather": {"bf16": 6}, "masked_attn": flash_layers,
                  "deform_attn_exact": 0, "plain": {}}
        check(per_fwd == expect, f"{name} launches per forward {per_fwd}, expected {expect}")
        runs[name] = (metrics, counts, per_fwd)
    log(f"[10] scored with PAIRNET_DEFORM_IMPL=pallas_v12 / pallas_v14 and PAIRNET_FLASH_ATTN=1: "
        f"launches per forward {runs['bf16 int8 flash sgdet'][2]} (flash: {flash_layers} of "
        f"{n_dec} decoder layers have >= {layers_mod.FLASH_MIN_KEYS} keys), f32 run "
        f"{runs['f32 int8 flash sgdet'][2]}; flash calls by (keys, dtype) {dict(flash_calls)}; "
        f"sgdet {runs['bf16 int8 flash sgdet'][0]['sgdet_images_per_s']} img/s")

    # --- (11) the new kernels on the scoring path's inputs; timings ---
    c_bf16, c_f32 = runs["bf16 int8 flash sgdet"][1], runs["f32 int8 flash sgdet"][1]
    n_before = len(kernels)
    quant_src = "pairnet_torch/csrc/deform_attn_quant.cu"
    for inst, (v, lc, wt) in (("bf16", captured[("int8", torch.bfloat16)]),
                              ("f32", captured[("int8", torch.float32)])):
        c = c_bf16 if inst == "bf16" else c_f32
        what = f"{inst} scoring batch {BATCH}, encoder layer 0"
        (codes, scales), _ = record(
            f"int8_quantize ({inst} values)", c["int8_quantize"].get(inst, 0),
            lambda: int8_quantize(v, SHAPES), lambda: int8_quantize_plain(v, SHAPES),
            lambda k, p: compare_quantize(k, p, "int8_quantize"), (v,), 5 * v.numel(),
            f"{what}, max|d| of codes and scales", phase=11, source=quant_src,
            replaces="pairnet_tpu/ops/pallas_deform_attn_v12.py:54")
        quantize_passes(lambda: int8_quantize(v, SHAPES), f"int8_quantize ({inst} values)", 11)
        if inst == "bf16":
            record("int8_gather (bf16 out)", c["int8_gather"].get("bf16", 0),
                   lambda: int8_gather(codes, scales, SHAPES, lc, wt),
                   lambda: int8_gather_plain(codes, scales, SHAPES, lc, wt),
                   lambda k, p: compare_gather(k, p, "int8_gather"), (codes, scales, lc, wt),
                   tap_flops(lc), f"{what}, max|d|, all within 1 bf16 ulp", phase=11,
                   source=quant_src, replaces="pairnet_tpu/ops/pallas_deform_attn_v12.py:118 "
                   "(v12), pairnet_tpu/ops/pallas_deform_attn_v14.py:57 (v14)")
            # the f32-output instance: the parity anchors v10 / v11, on no path
            record("int8_gather (f32 out)", c["int8_gather"].get("f32", 0),
                   lambda: int8_gather(codes, scales, SHAPES, lc, wt, torch.float32),
                   lambda: int8_gather_plain(codes, scales, SHAPES, lc, wt, torch.float32),
                   compare_gather_f32, (codes, scales, lc, wt), tap_flops(lc),
                   f"{what}, rel", phase=11, source=quant_src,
                   replaces="pairnet_tpu/ops/pallas_deform_attn_v10.py:93, "
                            "pairnet_tpu/ops/pallas_deform_attn_v11.py:61")
    import torch.nn.functional as F

    for dt, c in ((torch.bfloat16, c_bf16), (torch.float32, c_f32)):
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        lks = sorted(lk for lk, d in flash_caps if d == dt)
        for Lk in lks:
            q, k, v, mask = flash_caps[(Lk, dt)]
            B_ = mask.shape[0]
            q4, k4, v4 = (t.float().reshape(B_, H, t.shape[1], D) for t in (q, k, v))
            attend = ~mask[:, None]
            flops = 4 * q.shape[0] * q.shape[1] * Lk * D
            record(f"masked_attn ({dname}, Lk {Lk})", 0,
                   lambda: masked_flash_attention(q, k, v, mask, H),
                   lambda: masked_flash_attention_plain(q, k, v, mask, H), compare_flash,
                   (q, k, v, mask), flops,
                   f"{dname} scoring batch {BATCH}, first decoder layer with {Lk} keys, "
                   f"max|d|, products at {TC_FLOPS[dt] / 1e12:.0f} TFLOP/s", phase=11,
                   library_fn=lambda: F.scaled_dot_product_attention(q4, k4, v4, attend),
                   peak_flops=TC_FLOPS[dt], source="pairnet_torch/csrc/masked_attn.cu",
                   replaces="pairnet_tpu/ops/pallas_masked_attn.py:45")
            # PR 3's bound, the operations at the f32 rate of the CUDA cores
            kernels[-1]["bound_ms_f32_rate"] = max(kernels[-1]["bound_terms_ms"]["bytes"],
                                                   flops / F32_FLOPS * 1e3)
        # one entry per instance: per-call numbers averaged over the key
        # lengths in the proportion of the path's calls
        per_lk = {Lk: kernels.pop(-len(lks) + i) for i, Lk in enumerate(lks)}
        calls = {Lk: flash_calls[(Lk, dt)] for Lk in lks}
        share = {Lk: n / sum(calls.values()) for Lk, n in calls.items()}
        entry = dict(per_lk[lks[0]], name=f"masked_attn ({dname})",
                     launches=c["masked_attn"],
                     max_abs_err=max(e["max_abs_err"] for e in per_lk.values()))
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
            entry[key] = sum(share[Lk] * e[key] for Lk, e in per_lk.items())
        entry["bound_by"] = ("operations" if all(e["bound_by"] == "operations"
                                                 for e in per_lk.values()) else "bytes")
        entry["per_lk"] = {str(Lk): {key: e[key] for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_terms_ms",
            "bound_ms_f32_rate")} for Lk, e in per_lk.items()}
        for key in ("bound_terms_ms", "bound_ms_f32_rate"):
            entry.pop(key)
        entry["calls_per_lk"] = {str(Lk): n for Lk, n in calls.items()}
        kernels.append(entry)
    for entry in kernels[n_before:]:
        entry["launches_per_forward"] = entry["launches"] / -(-SCORE_IMAGES // BATCH)

    # the host's share of scoring: the loader (PNG decoding, resize,
    # normalization, GT masks) and the full-resolution GT of the split
    from pairnet_torch.config import apply_overrides
    from pairnet_torch.data.pipeline import Loader
    from pairnet_torch.evaluation.runner import load_groundtruths
    from pairnet_torch.train.builder import build_dataset, build_pipeline_cfg

    score_cfg = apply_overrides(load_config(SCORE_CONFIG), list(SCORE_SPLIT))
    split = build_dataset(score_cfg, "test")
    t0 = time.perf_counter()
    for _ in Loader(split, build_pipeline_cfg(score_cfg, train=False), BATCH):
        pass
    loader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_groundtruths(split)
    gt_s = time.perf_counter() - t0
    log(f"[11] host work of scoring {len(split)} images: loader {loader_s:.3f} s, "
        f"full-resolution GT {gt_s:.3f} s")
    evaluation = {
        "config": os.path.relpath(SCORE_CONFIG), "images": SCORE_IMAGES, "hw": [800, 1333],
        "padded": list(IMG), "batch": BATCH, "host_s": {"loader": loader_s, "groundtruth": gt_s},
        "runs": {name: {"metrics": m, "launches_per_forward": pf} for name, (m, _, pf) in runs.items()},
    }
    log(f"[11] scoring img/s (CLI, end to end: loading, forward, post-processing, canvas "
        f"resize, matching): " + ", ".join(
            f"{name} {m.get('sgdet_images_per_s', m.get('PQ_images_per_s'))}"
            for name, (m, _, _) in runs.items()))

    # --- (12) the Hungarian kernel against the plain loop ---
    def hung_case(kind, B, n, m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        if kind == "ties":
            cost = torch.randint(0, 4, (B, n, m), generator=g, device=dev).float()
        else:
            cost = torch.randn((B, n, m), generator=g, device=dev)
        rm = torch.ones((B, n), dtype=torch.bool, device=dev)
        cm = torch.ones((B, m), dtype=torch.bool, device=dev)
        if kind == "padded":
            rm[1::2, n - n // 3:] = False
            cm[::2, m - m // 4:] = False
        if kind == "triplets":  # PSGTr's HTriMatcher: 3 and 5 of the GT slots valid
            cost = 5 * cost
            cm = torch.arange(m, device=dev)[None] < torch.tensor([3, 5] * (B // 2),
                                                                  device=dev)[:, None]
        if kind == "nan entry":
            cost[:, n // 2, m // 3] = float("nan")
        return cost, rm, cm

    step_calls = {"mask matcher": captured_hung[0], "id matcher": captured_hung[1]}
    hung_cases = {**step_calls,
                  "ties 4x100x100": hung_case("ties", 4, 100, 100, 11),
                  "padded 4x64x100": hung_case("padded", 4, 64, 100, 12),
                  "n < m 4x64x100": hung_case("normal", 4, 64, 100, 13),
                  "n > m 4x100x64": hung_case("normal", 4, 100, 64, 14),
                  "step shape 4x100x100": hung_case("normal", 4, 100, 100, 15),
                  "nan entry 4x100x100": hung_case("nan entry", 4, 100, 100, 16),
                  "padded 12x100x100": hung_case("triplets", 12, 100, 100, 18)}
    hung_err, hung_plain_ms = {}, {}
    for name, (c, rm, cm) in hung_cases.items():
        pc = prepare(c, rm, cm)[0]
        got, (r2c, steps) = batched_hungarian(c, rm, cm), solve_n_le_m_cuda(pc)
        (want_r2c, want_steps), hung_plain_ms[name] = plain_with_ms(
            lambda: solve_n_le_m_plain_steps(pc))
        # the plain loop's row2col through the wrapper's own post-processing
        want = hungarian_mod._assign(lambda _: want_r2c, c, rm, cm)
        torch.cuda.synchronize()
        hung_err[name] = (sum(int((g != w).sum()) for g, w in zip(got, want))
                          + int((r2c != want_r2c).sum()) + int((steps != want_steps).sum()))
        check(hung_err[name] == 0, f"hungarian {name}: {hung_err[name]} assignments or search "
              "step counts differ from the plain loop's")
    nan_row = hung_case("normal", 2, 3, 3, 17)[0]
    nan_row[0, 1] = float("nan")
    nan_r2c, nan_steps = solve_n_le_m_cuda(nan_row)
    # after a degenerate search two columns may claim one row: the plain
    # loop's scatter keeps the higher column on the CPU, either on the card
    want_r2c, want_steps = solve_n_le_m_plain_steps(nan_row.cpu())
    nan_r2c, nan_steps = nan_r2c.cpu(), nan_steps.cpu()
    check(torch.equal(nan_r2c, want_r2c) and torch.equal(nan_steps, want_steps),
          f"hungarian, a whole NaN row: row2col {nan_r2c.tolist()}, steps {nan_steps.tolist()}; "
          f"the plain loop's {want_r2c.tolist()}, {want_steps.tolist()}")
    log(f"[12] hungarian kernel vs plain loop, row2col, col2row and every problem's search "
        f"steps equal on { {k: tuple(v[0].shape) for k, v in hung_cases.items()} }; a whole NaN "
        f"row too: row2col {nan_r2c.tolist()}, search steps {nan_steps.tolist()}")

    def scipy_host_ms(c, rm, cm):
        """scipy's linear_sum_assignment per image on the valid submatrix,
        with the copy of the costs to the host (what the reference did)."""
        from scipy.optimize import linear_sum_assignment

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost_h, rm_h, cm_h = (t.cpu().numpy() for t in (c.float(), rm, cm))
        for b in range(cost_h.shape[0]):
            linear_sum_assignment(cost_h[b][rm_h[b]][:, cm_h[b]])
        return (time.perf_counter() - t0) * 1e3

    hung_times, hung_inputs = {}, {}
    for name in ("mask matcher", "id matcher", "n < m 4x64x100", "step shape 4x100x100",
                 "padded 12x100x100"):
        c, rm, cm = hung_cases[name]
        rm = torch.ones(c.shape[:2], dtype=torch.bool, device=dev) if rm is None else rm
        pc = hung_inputs[name] = prepare(c, rm, cm)[0]
        _, steps = solve_n_le_m_cuda(pc)
        B_, n_, m_ = pc.shape
        t_bytes = (pc.numel() * 4 + B_ * n_ * 8 + B_ * 4) / HBM_BYTES_PER_S * 1e3
        hung_times[name] = {
            "solved_as": [B_, n_, m_],
            "ms": cuda_ms(torch, lambda: solve_n_le_m_cuda(pc), 20),
            "device_ms": cuda_ms(torch, lambda: solve_n_le_m_cuda(pc), 20, spin=True),
            "wrapper_ms": cuda_ms(torch, lambda: batched_hungarian(c, rm, cm), 20),
            "plain_ms": hung_plain_ms[name],
            "bound_ms": t_bytes,
            "search_steps": int(steps.sum()), "search_steps_max": int(steps.max()),
            "scipy_host_ms": scipy_host_ms(c, rm, cm),
        }
        e = hung_times[name]
        e["ns_per_step"] = e["device_ms"] * 1e6 / e["search_steps_max"]
        log(f"[12] hungarian {name}, solved as {B_}x{n_}x{m_}: kernel {e['ms']:.4f} ms (behind a "
            f"spin {e['device_ms']:.4f}), wrapper {e['wrapper_ms']:.4f}, plain loop "
            f"{e['plain_ms']:.2f} ms, bound {t_bytes:.6f} ms (bytes); search steps "
            f"{e['search_steps']} in all, {e['search_steps_max']} in the longest problem "
            f"({e['ns_per_step']:.0f} ns a step); scipy on the host with the copy "
            f"{e['scipy_host_ms']:.3f} ms")
    keep_loop_input("short_step", hung_inputs)
    step_times = [hung_times[k] for k in step_calls]
    kernels.append({
        "name": "hungarian", "route": "cuda", "source": "pairnet_torch/csrc/hungarian.cu",
        "replaces": "pairnet_tpu/ops/hungarian.py:36 (_solve_n_le_m, a lax.while_loop under "
                    "jit and vmap; not a pallas_call site)",
        "launches": train_launches["hungarian"], "launches_per_step": 2,
        "max_abs_err": float(max(hung_err.values())),
        **{k: sum(e[k] for e in step_times) / 2
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None,
        "search_steps_per_call": sum(e["search_steps"] for e in step_times) / 2,
        "per_call": hung_times,
    })

    # --- (13) train with the CLI at full width ---
    from pairnet_torch.tools import train as train_cli

    train_split = build_dataset(score_cfg, "train")
    train_pipe = build_pipeline_cfg(score_cfg, train=True)
    check(train_pipe.crop_prob == 0.5 and train_pipe.flip_prob == 0.5
          and len(train_pipe.train_scales) == 11, f"train pipeline {train_pipe}")
    cli_runs = []
    saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN",
                                                  "PAIRNET_DEBUG_NANS")}
    os.environ["PAIRNET_DEBUG_NANS"] = "1"  # the Trainer's guard on every step's losses
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for extra in (["--max-epochs", "1"], ["--resume", "--max-epochs", "2"]):
            torch.cuda.synchronize()
            reset_launches()
            syncs0 = batched_hungarian.syncs
            count_plain_calls(True)
            try:
                summary = train_cli.main([SCORE_CONFIG, "--work-dir", work, "--device", DEVICE,
                                          *extra, "--cfg-options", *SCORE_SPLIT])
            finally:
                count_plain_calls(False)
            torch.cuda.synchronize()
            got, steps = launches(), summary["steps"]
            syncs = batched_hungarian.syncs - syncs0
            want = {"deform_attn_exact": 6 * steps, "int4": 0,
                    "deform_attn_bwd": {"f32": 6 * steps}, "hungarian": 2 * steps, "plain": {}}
            check(got == want, f"train CLI {extra} launches {got}, expected {want}")
            check(syncs == 0, f"train CLI: the Hungarian synced with the host {syncs} times")
            check(all(math.isfinite(v) for v in summary["last"].values()),
                  f"train CLI losses {summary['last']}")
            cli_runs.append({"argv": extra, "start_epoch": summary["start_epoch"],
                             "steps": steps, "s_per_step": summary["seconds"] / steps,
                             "launches_per_step": {k: (v / steps if isinstance(v, int) else
                                                       {i: n / steps for i, n in v.items()})
                                                   for k, v in got.items() if k != "plain"},
                             "hungarian_host_syncs": syncs, "losses": summary["last"]})
        check([(r["start_epoch"], r["steps"]) for r in cli_runs] == [(0, 4), (1, 4)],
              f"train CLI runs {cli_runs}")
        ckpts = sorted(os.listdir(os.path.join(work, "ckpts")))
        check(ckpts == ["epoch_1.pt", "epoch_2.pt"], f"checkpoints {ckpts}")
        cli_metrics, _, cli_per_fwd = score("sgdet", {}, work_dir=work)
        check(cli_per_fwd == int4_expect, f"scoring the trained checkpoint: {cli_per_fwd}")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in Loader(train_split, train_pipe, 2, train=True, seed=10086))
    train_loader_s = time.perf_counter() - t0
    s_step = sum(r["s_per_step"] for r in cli_runs) / 2
    run_steps = [(r["start_epoch"], r["steps"], round(r["s_per_step"], 3)) for r in cli_runs]
    log(f"[13] train CLI on {os.path.relpath(SCORE_CONFIG)}, {len(train_split)} train images, "
        f"batch 2, f32, crop 0.5, 11 scales, flip 0.5: runs {run_steps} "
        f"(start epoch, steps, s per step); launches per step {cli_runs[0]['launches_per_step']}; "
        f"Hungarian host syncs {[r['hungarian_host_syncs'] for r in cli_runs]}; checkpoints "
        f"{ckpts}; sgdet on epoch_2.pt: key set as phase "
        f"9's, finite; the loader alone: {train_loader_s:.3f} s for the epoch's {n_batches} "
        f"batches ({train_loader_s / n_batches / s_step:.3f} of a step's time)")

    # --- (14) serving Pair-Net Swin-B at full width, bf16, int4 ---
    from pairnet_torch.bench import span_breakdown
    from pairnet_torch.data import png
    from pairnet_torch.models.backbones.swin import WindowMSA
    from pairnet_torch.models.frameworks.psgtr import build_model
    from pairnet_torch.tools import vis_results

    def int4_counts():
        return {"int4_quantize": int4_quantize.launches, "int4_gather": int4_gather.launches,
                "deform_attn_exact": deform_attn_exact.launches, "plain": dict(plain_calls)}

    int4_serving = {"int4_quantize": 6, "int4_gather": 6, "deform_attn_exact": 0, "plain": {}}
    # a served forward's kernels, read from the card at a replay, and the
    # wrappers' counts at the capturing request (each segment warmed up,
    # then captured), where the plain versions would be called
    int4_replay = {k: v for k, v in int4_serving.items() if k != "plain"}
    int4_capture = {**{k: 2 * v for k, v in int4_replay.items()}, "plain": {}}

    def check_served(out, preds, n, what):
        for key, shape in {"cls": (n, 100, 134), "rel": (n, 100, 56), "importance": (n, 100, 100),
                           "sub_pos": (n, 100), "obj_pos": (n, 100)}.items():
            check(tuple(out[key].shape) == shape, f"{what}: {key} shape {tuple(out[key].shape)}")
        for key in ("cls", "mask", "rel", "importance", "queries"):
            check(bool(torch.isfinite(out[key].float()).all()), f"{what}: {key} finite")
        check(bool(((out["sub_pos"] >= 0) & (out["sub_pos"] < 100) & (out["obj_pos"] >= 0)
                    & (out["obj_pos"] < 100)).all()), f"{what}: pair indices")
        check(len(preds) == n and all(tuple(pr.labels.shape) == (200,) for pr in preds),
              f"{what}: 100 pairs per image")

    model_s = perturb_deform_kernels(flagship(device=dev, dtype=torch.bfloat16, seed=0,
                                              backbone="swinb"))
    set_deform_impl(model_s, "int4")
    g = torch.Generator(device=dev).manual_seed(1)
    images_s = torch.randn((B, *IMG, 3), generator=g, device=dev).to(torch.bfloat16)
    reset_launches()
    count_plain_calls(True)
    layers_mod.ms_deform_attn = capturing
    serve(model_s, images_s)  # captures the graphs and the first encoder layer's inputs
    layers_mod.ms_deform_attn = orig_msda
    torch.cuda.synchronize()
    count_plain_calls(False)
    swin_capture = int4_counts()
    check(swin_capture == int4_capture, f"Swin-B capturing request's launches {swin_capture}")
    replayed = []
    swin_serving_launches = {**served_kernels(lambda: replayed.append(serve(model_s, images_s)),
                                              int4_replay), "plain": swin_capture["plain"]}
    out, preds = replayed[-1]
    del replayed
    check(swin_serving_launches == int4_serving,
          f"Swin-B serving launches {swin_serving_launches}")
    check_served(out, preds, B, "Swin-B serving")
    # the int4 kernels again on the inputs this path gave them
    v, lc, wt = captured[("int4", torch.bfloat16)]
    codes, scales = int4_quantize(v, SHAPES)
    compare_quantize((codes, scales), int4_quantize_plain(v, SHAPES))
    swin_gather_err = compare_gather(int4_gather(codes, scales, SHAPES, lc, wt),
                                     int4_gather_plain(codes, scales, SHAPES, lc, wt))
    del v, lc, wt, codes, scales, out, preds
    captured.clear()
    swin_ms = cuda_ms(torch, lambda: serve(model_s, images_s), 3)
    swin_spans = span_breakdown(lambda: serve(model_s, images_s), dev)["spans"]
    swin_stages = {k: v["device_ms"] for k, v in swin_spans.items()}
    # the backbone alone: its kernels by the profiler, and the window
    # attention (WindowMSA: qkv, scores, bias and mask, softmax, AV, proj)
    # as a profiler scope
    from torch.profiler import ProfilerActivity, profile, record_function

    x_nchw = images_s.permute(0, 3, 1, 2).contiguous()

    def backbone():
        with torch.inference_mode():
            model_s.backbone(x_nchw)

    orig_wmsa = WindowMSA.forward

    def scoped_wmsa(self, *a, **k):
        with record_function("swin_window_attention"):
            return orig_wmsa(self, *a, **k)

    WindowMSA.forward = scoped_wmsa
    try:
        backbone()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            backbone()
            torch.cuda.synchronize()
    finally:
        WindowMSA.forward = orig_wmsa
    # the scope's device time: the kernels launched inside it (None if the
    # profiler attributes none to it)
    wmsa_ms = max((getattr(e, "device_time_total", 0) or 0 for e in prof.key_averages()
                   if e.key == "swin_window_attention"), default=0) / 1e3 or None
    by_kernel = collections.defaultdict(lambda: [0.0, 0])  # kernel name -> [ms, launches]
    for e in prof.events():
        for k in e.kernels:
            by_kernel[k.name][0] += k.duration / 1e3
            by_kernel[k.name][1] += 1
    top = sorted(((ms, n, name) for name, (ms, n) in by_kernel.items()), reverse=True)
    bb_prof = {"kernel_ms": sum(r[0] for r in top), "kernels_launched": sum(r[1] for r in top),
               "top": [{"ms": ms, "calls": n, "name": name[:120]} for ms, n, name in top]}
    kinds = collections.Counter()  # the backbone's kernel ms by kind of kernel
    for row in bb_prof["top"]:
        name = row["name"].lower()
        kinds["conv" if "conv" in name or "fprop" in name
              else "matmul" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass"))
              else "softmax" if "softmax" in name
              else "layer_norm" if "layer_norm" in name
              else "copies, rolls and casts" if any(w in name for w in ("copy", "roll", "cat"))
              else "other elementwise"] += row["ms"]
    wmsa_share = None if wmsa_ms is None else wmsa_ms / bb_prof["kernel_ms"]
    swin_img_s = B * 1000.0 / swin_ms
    log(f"[14] Swin-B serving batch {B} bf16 int4 at {IMG[0]}x{IMG[1]}: launches "
        f"{swin_serving_launches}; outputs finite, 100 pairs per image; int4 kernels on this "
        f"path's inputs: codes+scales bit-equal, gather max|d| {swin_gather_err:.3g} within 1 "
        f"bf16 ulp; {swin_ms:.2f} ms per batch = {swin_img_s:.2f} img/s; stage ms "
        f"{ {k: round(v, 3) for k, v in swin_stages.items()} }; backbone kernels "
        f"{bb_prof['kernel_ms']:.2f} ms in {bb_prof['kernels_launched']} launches, by kind "
        f"{ {k: round(v, 3) for k, v in kinds.items()} }; window attention (profiler scope) "
        f"{wmsa_ms} ms = {wmsa_share} of the backbone's kernel time (a note)")
    del model_s, x_nchw, prof
    torch.cuda.empty_cache()

    # --- (15) f32 Swin-B forward: exact kernel vs plain MSDA ---
    model32 = perturb_deform_kernels(flagship(device=dev, dtype=torch.float32, seed=0,
                                              backbone="swinb"))
    swin_err, swin_decided, flips15, swin_exact = exact_vs_plain(model32, images_s[:1].float())
    log(f"[15] Swin-B f32 batch 1, exact kernel vs plain MSDA (TF32 off): max|d| "
        f"{ {k: f'{v:.3g}' for k, v in swin_err.items()} } (tol {TOL_FORWARD_REL} x "
        f"max(1, max|plain|)); pair indices equal at {swin_decided}/100 decided ranks; "
        f"{flips15} attention-mask bits the plain run would set otherwise; exact launches "
        f"{swin_exact}")
    del model32
    torch.cuda.empty_cache()

    # --- (16) score Swin-B with the CLI, save the predictions, visualise them ---
    work = tempfile.mkdtemp(prefix="chip_smoke_vis_")
    try:
        # phase 9's split with PSG's 133 class and 56 predicate names (its
        # own 7 and 5 first), so that every label the model predicts has a
        # name to draw: the same images and annotations
        named = os.path.join(work, "split")
        root = os.path.normpath(split.img_prefix)
        os.makedirs(named)
        for entry in os.listdir(root):
            if entry != "psg.json":
                os.symlink(os.path.join(root, entry), os.path.join(named, entry))
        with open(os.path.join(root, "psg.json")) as f:
            ann = json.load(f)
        n_names = len(ann["thing_classes"]) + len(ann["stuff_classes"])
        ann["stuff_classes"] += [f"class_{i}" for i in range(n_names, 133)]
        ann["predicate_classes"] += [f"predicate_{i}"
                                     for i in range(len(ann["predicate_classes"]), 56)]
        with open(os.path.join(named, "psg.json"), "w") as f:
            json.dump(ann, f)
        named_opts = (f"data.dataset.data_root={named}",)
        pkl = os.path.join(work, "results.pkl")
        swin_metrics, _, swin_per_fwd = score("sgdet", {}, config=SWIN_CONFIG,
                                              extra=["--save-results", pkl], split_opts=named_opts)
        check(swin_per_fwd == int4_expect, f"Swin-B scoring launches per forward {swin_per_fwd}")
        viz = os.path.join(work, "viz")
        t0 = time.perf_counter()
        n_vis = vis_results.main([SWIN_CONFIG, pkl, "--out-dir", viz, "--cfg-options",
                                  *named_opts])
        vis_s = time.perf_counter() - t0
        check(n_vis == SCORE_IMAGES, f"{n_vis} visualisations")
        widths = collections.Counter()
        for i, rec in enumerate(split.data[:n_vis]):
            path = os.path.join(viz, f"{i:06d}.png")
            pic = png.read(path)
            Wi, Hi = rec.width, rec.height
            check(pic.shape in ((Hi, 3 * Wi + Hi, 3), (Hi, 2 * Wi + Hi, 3)),
                  f"{path}: shape {pic.shape} for a {Hi}x{Wi} image")
            widths["3W + H" if pic.shape[1] == 3 * Wi + Hi else "2W + H"] += 1
            for ext in (".dot", ".triplets.txt"):
                check(os.path.getsize(path + ext) > 0, f"{path}{ext} empty")
        check("PIL" not in sys.modules, "PIL was imported")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    log(f"[16] scored {os.path.relpath(SWIN_CONFIG)} on phase 9's split (PSG's 133 class and "
        f"56 predicate names) with --save-results "
        f"(the numpy oracle): sgdet {swin_metrics['sgdet_images_per_s']} img/s, key set as "
        f"phase 9's, finite; launches per forward {swin_per_fwd}; vis_results wrote {n_vis} "
        f"PNGs ({dict(widths)}) with .dot and .triplets.txt in {vis_s:.2f} s; PIL not loaded")

    # --- (17) train Swin-B with the CLI ---
    swin_cfg = load_config(SWIN_CONFIG)
    saved = {k: os.environ.pop(k, None) for k in ("PAIRNET_DEFORM_IMPL", "PAIRNET_FLASH_ATTN",
                                                  "PAIRNET_DEBUG_NANS")}
    os.environ["PAIRNET_DEBUG_NANS"] = "1"
    work = tempfile.mkdtemp(prefix="chip_smoke_swin_train_")
    try:
        torch.cuda.synchronize()
        reset_launches()
        syncs0 = batched_hungarian.syncs
        count_plain_calls(True)
        try:
            summary = train_cli.main([SWIN_CONFIG, "--work-dir", work, "--device", DEVICE,
                                      "--max-epochs", "1", "--cfg-options", *SCORE_SPLIT])
        finally:
            count_plain_calls(False)
        torch.cuda.synchronize()
        got, steps = launches(), summary["steps"]
        syncs = batched_hungarian.syncs - syncs0
        want = {"deform_attn_exact": 6 * steps, "int4": 0, "deform_attn_bwd": {"f32": 6 * steps},
                "hungarian": 2 * steps, "plain": {}}
        check(steps == 4, f"Swin-B train CLI ran {steps} steps")
        check(got == want, f"Swin-B train CLI launches {got}, expected {want}")
        check(syncs == 0, f"Swin-B train CLI: the Hungarian synced with the host {syncs} times")
        check(all(math.isfinite(v) for v in summary["last"].values()),
              f"Swin-B train CLI losses {summary['last']}")
        # the trained checkpoint against the CLI's seeded init
        init = build_model(swin_cfg.model, device=dev, seed=swin_cfg.get("seed", 10086))
        init = init.state_dict()
        trained = torch.load(os.path.join(work, "ckpts", "epoch_1.pt"), map_location=dev,
                             weights_only=True)["state"]["model"]
        moved = {f"stage {st}": any(not torch.equal(trained[k], init[k]) for k in init
                                    if k.startswith(f"backbone.stages.{st}."))
                 for st in range(4)}
        moved["relative_position_bias_table"] = any(
            not torch.equal(trained[k], init[k]) for k in init
            if k.endswith("relative_position_bias_table"))
        check(all(moved.values()), f"Swin-B parameters moved: {moved}")
        del init, trained
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    swin_s_step = summary["seconds"] / steps
    swin_train = {"steps": steps, "s_per_step": swin_s_step,
                  "launches_per_step": {k: (v / steps if isinstance(v, int) else
                                            {i: n / steps for i, n in v.items()})
                                        for k, v in got.items() if k != "plain"},
                  "hungarian_host_syncs": syncs, "losses": summary["last"], "moved": moved}
    log(f"[17] train CLI on {os.path.relpath(SWIN_CONFIG)}, {len(train_split)} train images, "
        f"batch 2, f32: {steps} steps, {swin_s_step:.3f} s per step; launches per step "
        f"{swin_train['launches_per_step']}; Hungarian host syncs {syncs}; losses finite; "
        f"moved {moved}")

    # --- (18) the other Pair-Net heads at full width ---
    cfg_dir = os.path.dirname(SCORE_CONFIG)
    head_cases = {
        "attn": (os.path.join(cfg_dir, "pairnet_attn_mapper_r50_psg.py"), []),
        "fc": (os.path.join(cfg_dir, "pairnet_fc_mapper_r50_psg.py"), []),
        "direct": (os.path.join(cfg_dir, "pairnet_direct_r50_psg.py"), []),
        "conv_small": (SCORE_CONFIG, ["model.bbox_head.mapper=conv_small"]),
        "conv_base": (SCORE_CONFIG, ["model.bbox_head.mapper=conv_base"]),
    }
    images2 = images_s[:2]
    heads = {}
    for name, (path, opts) in head_cases.items():
        hcfg = apply_overrides(load_config(path), opts)
        model_h = perturb_deform_kernels(build_model(hcfg.model, device=dev).to(torch.bfloat16))
        set_deform_impl(model_h, "int4")
        reset_launches()
        count_plain_calls(True)
        serve(model_h, images2)  # captures the graphs
        torch.cuda.synchronize()
        count_plain_calls(False)
        capture = int4_counts()
        check(capture == int4_capture, f"{name} head capturing request's launches {capture}")
        replayed = []
        counts = {**served_kernels(lambda: replayed.append(serve(model_h, images2)),
                                   int4_replay), "plain": capture["plain"]}
        out, preds = replayed[-1]
        del replayed
        check(counts == int4_serving, f"{name} head serving launches {counts}")
        check_served(out, preds, 2, f"{name} head")
        heads[name] = {"config": os.path.relpath(path), "cfg_options": opts, "launches": counts,
                       "ms_per_batch_of_2": cuda_ms(torch, lambda: serve(model_h, images2), 2)}
        del model_h, out, preds
    torch.cuda.empty_cache()
    log(f"[18] heads at full width, batch 2 bf16 int4: "
        + ", ".join(f"{n} {h['ms_per_batch_of_2']:.2f} ms" for n, h in heads.items())
        + f"; launches per forward {int4_serving} each; outputs finite, 100 pairs per image")
    del images_s, images2

    parallel = parallel_phases(smi, tf32, cli_runs[0]["losses"],
                               {what: evaluation["runs"][f"bf16 int4 {what}"]["metrics"]
                                for what in ("sgdet", "PQ")},
                               score, int4_expect, launches, reset_launches, count_plain_calls)
    zoo = zoo_phases(smi, tf32, score, int4_expect, launches, reset_launches, count_plain_calls)
    compare = {"exact_f32": compare_exact_f32, "exact_bf16": compare_exact_bf16,
               "quantize": compare_quantize, "gather": compare_gather, "bwd": compare_bwd}
    bbox, bbox_kernels = bbox_phases(smi, tf32, record, compare, count_plain_calls, plain_calls)
    kernels.extend(bbox_kernels)
    twostage = twostage_phases(smi, record)
    bridge = bridge_phase(smi, score, launches, reset_launches, count_plain_calls, int4_expect)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": {"batch": B, "hw": list(IMG), "dtype": "bf16", "impl": "int4",
                                  "ms_per_batch": serve_ms, "img_per_s": img_per_s}}))
    print(json.dumps({"training": {
        "batch": TRAIN_BATCH, "hw": list(IMG), "compute_dtype": "bf16",
        "msda": "exact forward, exact backward", "ms_per_step": train_ms,
        "img_per_s": train_img_s, "peak_memory_gib": peak_gib,
        "launches_per_step": {
            "deform_attn_exact": train_launches["deform_attn_exact"] / TRAIN_STEPS,
            "deform_attn_bwd": train_launches["deform_attn_bwd"]["bf16"] / TRAIN_STEPS,
            "hungarian": train_launches["hungarian"] / TRAIN_STEPS},
        "hungarian_host_syncs": train_syncs / TRAIN_STEPS,
        "losses": last, "f32_kernel_vs_plain": {
            "loss_max_abs_err": max(loss_err.values()),
            "msda_grad_max_abs_err": max(grad_err.values()), "msda_grad_max_rel_err": grad_rel,
            "replayed": flips}}}))
    print(json.dumps({"evaluation": evaluation}))
    print(json.dumps({"train_cli": {
        "config": os.path.relpath(SCORE_CONFIG), "train_images": len(train_split), "batch": 2,
        "compute_dtype": "f32", "runs": cli_runs, "loader_s_per_epoch": train_loader_s,
        "sgdet": cli_metrics}}))
    print(json.dumps({"swin": {
        "serving": {"batch": B, "hw": list(IMG), "dtype": "bf16", "impl": "int4",
                    "ms_per_batch": swin_ms, "img_per_s": swin_img_s, "stage_ms": swin_stages,
                    "launches": swin_serving_launches,
                    "backbone_kernel_ms": bb_prof["kernel_ms"],
                    "backbone_kernels_launched": bb_prof["kernels_launched"],
                    "backbone_kernel_ms_by_kind": dict(kinds),
                    "window_attention_ms": wmsa_ms,
                    "window_attention_share_of_backbone": wmsa_share,
                    "backbone_top_kernels": bb_prof["top"][:12]},
        "f32_exact_vs_plain": {"max_abs_err": swin_err, "decided_ranks": swin_decided,
                               "mask_bits_replayed": flips15, "exact_launches": swin_exact},
        "scoring": {"config": os.path.relpath(SWIN_CONFIG), "metrics": swin_metrics,
                    "launches_per_forward": swin_per_fwd, "vis_pngs": n_vis, "vis_s": vis_s},
        "train_cli": swin_train, "heads": heads}}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"bbox": bbox}))
    print(json.dumps({"twostage": twostage}))
    print(json.dumps({"bridge": bridge}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
