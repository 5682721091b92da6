#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line then):
  0. the card: nvidia-smi name and power limit; no CUDA -> fail.
  1. build the CUDA kernels from pairnet_torch/csrc (one nvcc each, in parallel).
  2. hold every kernel against its plain PyTorch version at the pixel
     decoder's encoder geometry of an 800x1344 image, batch 2, with wide
     sampling offsets (many taps out of the plane).
  3. serve full-width Pair-Net R-50 (800x1344, batch 8, bf16, int4 MSDA):
     counts each kernel's launches in that run, checks the outputs.
  4. an f32 forward (batch 1, TF32 off) through the exact kernel against
     the same forward through the plain MSDA.
  5. each kernel against its plain version again, on the inputs the main
     paths gave it (first encoder layer: batch 8 bf16 serving for the int4
     kernels, batch 1 f32 for the exact one), with the tolerances of phase 2;
     timings with CUDA events: serving img/s, each kernel and its plain
     version on those inputs, and each kernel's bound.
Then one JSON line of kernels, the card's name and power limit, and the
final line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import sys
import time

import torch

IMG = (800, 1344)
SHAPES = tuple((IMG[0] // s, IMG[1] // s) for s in (32, 16, 8))  # the encoder's levels
BATCH, CHECK_BATCH = 8, 2  # serving batch; batch of the kernel-vs-plain checks
DEVICE = "cuda:0"
H, D, P = 8, 32, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
TOL_EXACT_F32 = 1e-4  # max |kernel - plain|, f32 values
TOL_EXACT_BF16_REL = 1e-3  # max |kernel - plain| / max |plain|, bf16 values
TOL_FORWARD_REL = 1e-3  # phase 4: max |exact - plain| / max(1, max |plain|)


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run unless ``ok`` (not an ``assert``: it holds under -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def decided_ranks(values, k, tol):
    s = torch.sort(values.double().flatten(), descending=True).values[: k + 1]
    gap = (s[:-1] - s[1:]).abs()
    before = torch.cat([gap.new_tensor([float("inf")]), gap[: k - 1]])
    return (before > tol) & (gap[:k] > tol)


def main():
    # --- (0) the card ---
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    from pairnet_torch.bench import gpu_name_and_power_limit, serve
    from pairnet_torch.flagship import flagship, perturb_deform_kernels, set_deform_impl
    from pairnet_torch.models import layers as layers_mod
    from pairnet_torch.ops import _build
    from pairnet_torch.ops.deform_attn import ms_deform_attn_plain
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.ops.deform_attn_int4 import (
        bf16_ulps_off,
        int4_gather,
        int4_gather_plain,
        int4_quantize,
        int4_quantize_plain,
    )

    smi = gpu_name_and_power_limit()
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    log(f"[0] gpu: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    wrappers = {"deform_attn_exact": deform_attn_exact, "int4_quantize": int4_quantize,
                "int4_gather": int4_gather}

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

    def compare_quantize(k, p):
        check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
              "int4_quantize: codes and scales not bit-equal to plain")
        return max(float((k[0].int() - p[0].int()).abs().max()), float((k[1] - p[1]).abs().max()))

    def compare_gather(k, p):
        n_over = bf16_ulps_off(k, p)
        check(n_over == 0, f"int4_gather: {n_over} outputs beyond 1 bf16 ulp of plain")
        return float((k.float() - p.float()).abs().max())

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
    torch.cuda.synchronize()
    log(f"[2] kernel vs plain (batch {CHECK_BATCH}, levels {SHAPES}, wide offsets): exact f32 "
        f"max|d| {e_f32:.3g} (tol {TOL_EXACT_F32}); exact bf16 rel {rel_bf16:.3g} "
        f"(tol {TOL_EXACT_BF16_REL}); int4_quantize codes+scales bit-equal; "
        f"int4_gather max|d| {e_gather:.3g}, all within 1 bf16 ulp")
    del v32, vb, locs, w, codes, scales

    # capture the MSDA inputs that a forward hands to the kernels
    captured = {}
    orig_msda = layers_mod.ms_deform_attn

    def capturing(value, shapes, locs, weights, impl=None):
        if impl not in captured:
            captured[impl] = (value.clone(), locs.clone(), weights.clone())
        return orig_msda(value, shapes, locs, weights, impl=impl)

    # --- (3) full-width serving, bf16, int4 ---
    B, h4, w4 = BATCH, IMG[0] // 4, IMG[1] // 4
    model = perturb_deform_kernels(flagship(device=dev, dtype=torch.bfloat16, seed=0))
    set_deform_impl(model, "int4")
    g = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((B, *IMG, 3), generator=g, device=dev).to(torch.bfloat16)
    layers_mod.ms_deform_attn = capturing
    serve(model, images)  # warm-up; captures the first encoder layer's inputs
    layers_mod.ms_deform_attn = orig_msda
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    out, preds = serve(model, images)
    torch.cuda.synchronize()
    serving_launches = {n: fn.launches for n, fn in wrappers.items()}
    check(serving_launches == {"deform_attn_exact": 0, "int4_quantize": 6, "int4_gather": 6},
          f"serving launches {serving_launches}")
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
    log(f"[3] serving batch {B} bf16 int4 at {IMG[0]}x{IMG[1]}: launches {serving_launches}; "
        f"outputs finite with the expected shapes; {len(preds)} predictions; kept segments "
        f"per image {[int(torch.unique(pr.pan_seg).numel()) for pr in preds]}")

    # --- (4) f32 forward: exact kernel vs plain MSDA ---
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = perturb_deform_kernels(flagship(device=dev, dtype=torch.float32, seed=0))
    img32 = images[:1].float()
    dec = model32.bbox_head.transformer_decoder
    masks, flips = [], [0]
    set_deform_impl(model32, "exact")
    dec.attn_mask_small = lambda *a: masks.append(type(dec).attn_mask_small(dec, *a)) or masks[-1]
    for fn in wrappers.values():
        fn.launches = 0
    layers_mod.ms_deform_attn = capturing
    with torch.inference_mode():
        out_e = model32(img32)
    layers_mod.ms_deform_attn = orig_msda
    torch.cuda.synchronize()
    exact_launches = deform_attn_exact.launches
    check(exact_launches == 6, f"exact launches {exact_launches}")
    # the plain run reuses the exact run's attention masks, so one
    # borderline sigmoid < 0.5 bit cannot make the runs diverge; the bits
    # it would have set differently are counted
    replay = iter(list(masks))

    def replayed(*a):
        own, kept = type(dec).attn_mask_small(dec, *a), next(replay)
        flips[0] += int((own != kept).sum())
        return kept

    dec.attn_mask_small = replayed
    set_deform_impl(model32, "plain")
    with torch.inference_mode():
        out_p = model32(img32)
    torch.cuda.synchronize()
    fwd_err = {}
    for key in ("cls", "mask", "importance", "queries", "rel"):
        ref = out_p[key].float()
        fwd_err[key] = float((out_e[key].float() - ref).abs().max())
        bound = TOL_FORWARD_REL * max(1.0, float(ref.abs().max()))
        check(fwd_err[key] <= bound, f"{key}: exact vs plain {fwd_err[key]} > {bound}")
    ok = decided_ranks(out_p["importance"][0], 100, fwd_err["importance"] * 10 + 1e-6)
    check(torch.equal(out_e["sub_pos"][0][ok], out_p["sub_pos"][0][ok])
          and torch.equal(out_e["obj_pos"][0][ok], out_p["obj_pos"][0][ok]),
          "pair indices at decided ranks")
    log(f"[4] f32 batch 1, exact kernel vs plain MSDA (TF32 off): max|d| "
        f"{ {k: f'{v:.3g}' for k, v in fwd_err.items()} } (tol {TOL_FORWARD_REL} x "
        f"max(1, max|plain|)); pair indices equal at {int(ok.sum())}/100 decided ranks; "
        f"{flips[0]} attention-mask bits the plain run would set otherwise; "
        f"exact launches {exact_launches}")
    del model32, out_e, out_p, masks
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # --- (5) kernels on the main paths' inputs; timings ---
    serve_ms = cuda_ms(lambda: serve(model, images), 3)
    img_per_s = B * 1000.0 / serve_ms
    log(f"[5] serving: {serve_ms:.2f} ms per batch of {B} = {img_per_s:.2f} img/s")

    kernels = []

    def record(name, launches, kernel_fn, plain_fn, compare, in_t, flops, note, **where):
        """Check the kernel against its plain version on the main path's
        inputs, time both, and add the kernel's entry (``where``: source,
        replaces) unless ``launches`` is None."""
        out, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        d = compare(out, ref)
        del ref
        ms = cuda_ms(kernel_fn, 20)
        plain_ms = cuda_ms(plain_fn, 3)
        out_t = out if isinstance(out, tuple) else (out,)
        t_bytes = nbytes(*in_t, *out_t) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        if launches is not None:
            kernels.append({
                "name": name, "route": "cuda", **where, "launches": launches, "max_abs_err": d,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": bound_by, "library_ms": None,
            })
        log(f"[5] {name} ({note}): vs plain {d:.3g} within tolerance; {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms ({bound_by}: bytes "
            f"{t_bytes:.4f}, ops {t_ops:.4f})")
        return out

    L = len(SHAPES)

    def tap_flops(lc):  # ~10 operations per (b, q, h, d, level, point)
        return 10 * lc.shape[0] * lc.shape[1] * H * D * L * P

    v, lc, wt = captured["exact"]
    record("deform_attn_exact", exact_launches, lambda: deform_attn_exact(v, SHAPES, lc, wt),
           lambda: ms_deform_attn_plain(v, SHAPES, lc, wt), compare_exact_f32, (v, lc, wt),
           tap_flops(lc), "f32 forward batch 1, encoder layer 0, max|d|",
           source="pairnet_torch/csrc/deform_attn_exact.cu",
           replaces="pairnet_tpu/ops/pallas_deform_attn_v6.py:86 (f32), "
                    "pairnet_tpu/ops/pallas_deform_attn_v7.py:88 (bf16)")
    v, lc, wt = captured["int4"]
    # the exact kernel's bf16 instance (the v7 case) on the serving inputs;
    # checked and logged, no entry: the serving path runs the int4 kernels
    record("deform_attn_exact", None, lambda: deform_attn_exact(v, SHAPES, lc, wt),
           lambda: ms_deform_attn_plain(v, SHAPES, lc, wt), compare_exact_bf16, (v, lc, wt),
           tap_flops(lc), f"bf16 values, bf16 serving batch {B}, encoder layer 0, rel")
    codes, scales = record(
        "int4_quantize", serving_launches["int4_quantize"], lambda: int4_quantize(v, SHAPES),
        lambda: int4_quantize_plain(v, SHAPES), compare_quantize, (v,), 5 * v.numel(),
        f"bf16 serving batch {B}, encoder layer 0, max|d| of codes and scales",
        source="pairnet_torch/csrc/deform_attn_int4.cu",
        replaces="pairnet_tpu/ops/pallas_deform_attn_v16.py:54")
    record("int4_gather", serving_launches["int4_gather"],
           lambda: int4_gather(codes, scales, SHAPES, lc, wt),
           lambda: int4_gather_plain(codes, scales, SHAPES, lc, wt), compare_gather,
           (codes, scales, lc, wt), tap_flops(lc),
           f"bf16 serving batch {B}, encoder layer 0, max|d|, all within 1 bf16 ulp",
           source="pairnet_torch/csrc/deform_attn_int4.cu",
           replaces="pairnet_tpu/ops/pallas_deform_attn_v16.py:106")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": {"batch": B, "hw": list(IMG), "dtype": "bf16", "impl": "int4",
                                  "ms_per_batch": serve_ms, "img_per_s": img_per_s}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
