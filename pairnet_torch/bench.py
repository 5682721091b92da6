"""Benchmarks of the port on one GPU: Pair-Net serving and training.

Serving, the counterpart of ``bench.py::bench_eval``: the forward pass plus
the post-processing (panoptic fusion and triplet ranking) of every image,
at 800x1344, batch 8, every float parameter and buffer in bf16, the int4
MSDA kernels, on Pair-Net R-50 or (``--model swinb``, the JAX bench's
``BENCH_MODEL=swinb``) Pair-Net Swin-B. Training (``--train``), the
counterpart of ``bench.py::bench_train``, which is R-50 only: the full
train step (forward, on-device targets, losses, backward, clip, AdamW) at
800x1344, batch 4, bf16 compute over f32 masters, the exact MSDA kernels
forward and backward, on the seeded batch of ``bench.py`` (24 segments, 40
relations, 12544 points). Timed with CUDA events; prints one JSON line;
``--breakdown`` adds the port's spans over one more batch or step
(:func:`span_breakdown`). Needs a GPU::

    python -m pairnet_torch.bench [--model r50|swinb] [--impl int4|exact] [--breakdown]
    python -m pairnet_torch.bench --train [--breakdown]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from pairnet_torch.flagship import (
    flagship,
    perturb_deform_kernels,
    resolve_device,
    set_deform_impl,
)
from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess
from pairnet_torch.utils import serve_graph, tracing

IMAGE_HW, BATCH, ITERS = (800, 1344), 8, 5
DEVICE_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")  # the profiler's device categories
TRAIN_BATCH, TRAIN_ITERS, NUM_POINTS = 4, 3, 12544
NUM_CLASSES, NUM_RELATIONS = 133, 56


def serve(model, images, num_things: int = 80):
    """Forward + post-processing of every image: (outputs, predictions).

    The forward runs as replays of CUDA graphs where the images are on CUDA
    and the model is Pair-Net in eval mode (``utils/serve_graph.py``),
    captured at the first request of each input shape, dtype, device and
    MSDA implementation; elsewhere eagerly. The results are those of the
    eager forward, bit for bit, and the outputs returned are the request's
    own. The graphs are cut at module boundaries, so the pre-hooks and
    forward hooks of these modules run on every request: the model,
    ``backbone``, ``bbox_head``, ``bbox_head.pixel_decoder``,
    ``bbox_head.transformer_decoder`` and each of its ``layers``. A hook on
    a module inside them runs only at a capture. The post-processing is
    eager."""
    with tracing.unit("serve"), torch.inference_mode():
        out = serve_graph.forward(model, images)
        with tracing.span("postprocess"):
            preds = [pairnet_postprocess(out, b, num_things) for b in range(images.shape[0])]
    return out, preds


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_serving(model, images, iters: int) -> float:
    """Milliseconds per served batch, by CUDA events over ``iters`` batches."""
    serve(model, images)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        serve(model, images)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def span_breakdown(fn, device) -> dict:
    """The port's spans (``utils/tracing.py``) in one call of ``fn`` after a
    warm-up call, from ``torch.profiler`` with the tracer on: ``spans``,
    for each span its ``calls``, ``host_ms`` (wall time on the host) and,
    on the card, ``device_ms`` and ``kernels`` (the device time and count of
    the kernels and copies launched inside it, children included, by time
    and from any thread: autograd's device thread launches the backward's);
    ``counts``, the difference of ``tracing.snapshot()`` over the call."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    fn()
    sync()
    was = tracing.enabled()
    tracing.enable(True)
    before = tracing.snapshot()
    try:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            fn()
            sync()
    finally:
        tracing.enable(was)
    counts = tracing.difference(before, tracing.snapshot())
    # a device record goes to the spans that held the runtime call that
    # launched it (by correlation id), as in portbench/program.py: a
    # replayed CUDA graph's kernels have no operator of their own to hang from
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    spans, launched, records = [], {}, []
    for e in events:
        cat, name, start = str(e.get("cat", "")).lower(), e.get("name", ""), float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(tracing.PREFIX):
            spans.append((start, start + float(e["dur"]), name[len(tracing.PREFIX):]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launched[corr] = start
        elif cat in DEVICE_RECORDS:
            records.append((float(e["dur"]), corr))
    rows = {}
    for start, end, name in spans:
        row = rows.setdefault(name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                     "kernels": 0})
        row["calls"] += 1
        row["host_ms"] += (end - start) / 1e3
    for dur, corr in records:
        at = launched.get(corr)
        for start, end, name in spans:
            if at is not None and start <= at < end:
                rows[name]["device_ms"] += dur / 1e3
                rows[name]["kernels"] += 1
    return {"spans": rows, "counts": counts}


def train_batch(batch_size: int, hw=IMAGE_HW, G: int = 24, R: int = 40, seed: int = 0) -> dict:
    """The seeded host batch of ``bench.py::bench_train``: a normal image,
    G segments with random labels and masks (pixels on with p 0.2, shipped
    as bool), R random relations, all valid."""
    H, W = hw
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(batch_size, H, W, 3)).astype(np.float32),
        "gt_labels": rng.integers(0, NUM_CLASSES, size=(batch_size, G)).astype(np.int32),
        "gt_masks": rng.uniform(size=(batch_size, G, H // 4, W // 4)) > 0.8,
        "gt_valid": np.ones((batch_size, G), bool),
        "gt_rels": np.stack([rng.integers(0, G, (batch_size, R)),
                             rng.integers(0, G, (batch_size, R)),
                             rng.integers(1, NUM_RELATIONS, (batch_size, R))], -1).astype(np.int32),
        "rel_valid": np.ones((batch_size, R), bool),
    }


def train_setup(device, compute_dtype=torch.bfloat16):
    """(model, state, step): the f32 flagship with perturbed deformable
    kernels, the exact MSDA forward and backward, its AdamW state and the
    train step."""
    from pairnet_torch.train.optim import build_optimizer
    from pairnet_torch.train.trainer import TrainState, make_train_step

    model = set_deform_impl(perturb_deform_kernels(flagship(device=device)), "exact")
    optimizer = build_optimizer(model)
    state = TrainState(model, optimizer, NUM_RELATIONS)
    step = make_train_step(model, optimizer, {"num_points": NUM_POINTS}, compute_dtype)
    return model, state, step


def time_train(step, state, batch, iters: int) -> tuple[float, int]:
    """(milliseconds per train step by CUDA events over ``iters`` steps
    after a warm-up, peak device bytes allocated during them)."""
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, torch.cuda.max_memory_allocated()


def train_main(breakdown: bool) -> dict:
    from pairnet_torch.train.trainer import to_device

    device = resolve_device(None)
    _, state, step = train_setup(device)
    batch = to_device(train_batch(TRAIN_BATCH), device)
    ms, peak = time_train(step, state, batch, TRAIN_ITERS)
    (H, W), B = IMAGE_HW, TRAIN_BATCH
    result = {
        "metric": f"train_images_per_sec_pairnet_r50_{H}x{W}",
        "value": B * 1000.0 / ms,
        "unit": "img/s",
        "ms_per_step": ms,
        "batch": B,
        "compute_dtype": "bf16",
        "msda": "exact forward, exact backward",
        "peak_memory_gib": peak / 2 ** 30,
        "device": torch.cuda.get_device_name(device),
        "gpu": gpu_name_and_power_limit(),
    }
    if breakdown:
        result.update(span_breakdown(lambda: step(state, batch), device))
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("r50", "swinb"), default="r50",
                    help="serving backbone: ResNet-50 or Swin-B (training is R-50 only)")
    ap.add_argument("--impl", choices=("int4", "exact"), default="int4",
                    help="serving MSDA kernels: int4 (bf16 serving default) or exact")
    ap.add_argument("--train", action="store_true",
                    help="time the train step instead of serving")
    ap.add_argument("--breakdown", action="store_true",
                    help="also report the port's spans in one batch (one step with "
                         "--train) and the counters over it")
    args = ap.parse_args(argv)
    if args.train:
        if args.model != "r50":
            ap.error("--train times Pair-Net R-50 only, as the JAX train bench")
        return train_main(args.breakdown)

    device = resolve_device(None)
    (H, W), B = IMAGE_HW, BATCH
    model = perturb_deform_kernels(flagship(device=device, dtype=torch.bfloat16,
                                            backbone=args.model))
    set_deform_impl(model, args.impl)
    g = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((B, H, W, 3), generator=g, device=device).to(torch.bfloat16)
    ms = time_serving(model, images, ITERS)
    result = {
        "metric": f"images_per_sec_pairnet_{args.model}_sgdet_e2e_{H}x{W}",
        "value": B * 1000.0 / ms,
        "unit": "img/s",
        "ms_per_batch": ms,
        "batch": B,
        "dtype": "bf16",
        "impl": args.impl,
        "device": torch.cuda.get_device_name(device),
        "gpu": gpu_name_and_power_limit(),
    }
    if args.breakdown:
        result.update(span_breakdown(lambda: serve(model, images), device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
