"""Serving benchmark of the port: Pair-Net R-50 sgdet inference on one GPU.

Counterpart of ``bench.py::bench_eval``: the forward pass plus the
post-processing (panoptic fusion and triplet ranking) of every image, at
800x1344, batch 8, every float parameter and buffer in bf16, the int4 MSDA
kernels. Timed with CUDA events; prints one JSON line. Needs a GPU::

    python -m pairnet_torch.bench [--impl int4|exact] [--breakdown]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from pairnet_torch.flagship import flagship, perturb_deform_kernels, resolve_device, set_deform_impl
from pairnet_torch.models.heads.pairnet_inference import pairnet_postprocess

IMAGE_HW, BATCH, ITERS = (800, 1344), 8, 5


def serve(model, images, num_things: int = 80):
    """Forward + post-processing of every image: (outputs, predictions)."""
    with torch.inference_mode():
        out = model(images)
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


STAGES = ("backbone", "bbox_head.pixel_decoder", "bbox_head.transformer_decoder", "bbox_head")
STAGE_NAMES = ("backbone", "pixel_decoder", "mask2former_decoder", "ppn_and_relation",
               "postprocess")


def stage_ms(model, images) -> dict:
    """Device milliseconds of each stage of one served batch: CUDA events
    recorded at the stage boundaries (forward hooks), so each span is the
    device timeline between two boundaries, idle gaps included."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 2)]
    modules = dict(model.named_modules())
    handles = [
        modules[name].register_forward_hook(lambda *_, ev=ev: ev.record())
        for name, ev in zip(STAGES, events[1:])
    ]
    try:
        torch.cuda.synchronize()
        events[0].record()
        serve(model, images)
        events[-1].record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {n: a.elapsed_time(b) for n, a, b in zip(STAGE_NAMES, events, events[1:])}


def device_profile(model, images, top: int = 12) -> dict:
    """Kernel time of one served batch from ``torch.profiler`` (CUDA
    activity only): the sum over all kernels, and the ``top`` kernels by
    their own device time."""
    from torch.profiler import ProfilerActivity, profile

    serve(model, images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(model, images)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return {
        "kernel_ms": sum(r[0] for r in rows),
        "kernels_launched": sum(r[1] for r in rows),
        "top": [{"ms": ms, "calls": n, "name": k[:120]} for ms, n, k in rows[:top]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("int4", "exact"), default="int4",
                    help="MSDA kernels: int4 (bf16 serving default) or exact")
    ap.add_argument("--breakdown", action="store_true",
                    help="also report device ms per stage and the profiler's kernel time")
    args = ap.parse_args(argv)

    device = resolve_device(None)
    (H, W), B = IMAGE_HW, BATCH
    model = perturb_deform_kernels(flagship(device=device, dtype=torch.bfloat16))
    set_deform_impl(model, args.impl)
    g = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((B, H, W, 3), generator=g, device=device).to(torch.bfloat16)
    ms = time_serving(model, images, ITERS)
    result = {
        "metric": f"images_per_sec_pairnet_r50_sgdet_e2e_{H}x{W}",
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
        result["stage_ms"] = stage_ms(model, images)
        prof = device_profile(model, images)
        result["device_busy_share"] = prof["kernel_ms"] / ms
        result["profile"] = prof
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
