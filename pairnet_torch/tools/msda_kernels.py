"""Time the MSDA kernels of one checkout (the exact forward, the quantized
gathers, the int4/int8 quantize and the backward) on the inputs of the bf16
training step, and timing-only variants of the backward source. Needs a
GPU::

    python pairnet_torch/tools/msda_kernels.py [--tree DIR] [--variants kernel,store,...]
        [--inputs FILE] [--save-outputs FILE | --compare-outputs FILE]

``--tree`` is the root of the checkout whose ``pairnet_torch`` is imported
and built (default: the one holding this file), so one copy of the script
times another commit's kernels. The inputs are those that encoder layer 0
hands to the MSDA backward in one bf16 train step of
``python -m pairnet_torch.bench --train`` (batch 4, 800x1344; the same
value, locations and weights reach the forward). With ``--inputs`` they are
captured and written there on the first run and read back on later runs,
so that two checkouts run on the same tensors. Cases: the exact forward
on the bf16 values at batch 4 and on f32 copies of batch 1; the quantized
gathers (int4, int8 with bf16 and f32 output) on those bf16 values' codes
at batch 4; the three quantize instances (int4 and int8 on the bf16
values, int8 on f32 copies) at batch 4 and on the values repeated to batch
8, the serving batch; the backward's f32 instance at batch 1, its bf16 and
bf16_grad instances at batch 4.

Variants (of the backward only) are text edits of the tree's ``csrc/deform_attn_bwd.cu``, built
beside it under ``_build/variants``. Their results are wrong; they are only
timed, to see what sets the backward's pace:
  kernel   the source as it is
  store    every atomic add into dvalue in device memory made a plain store
           to the same address
  const    every value load made a constant
  store+const  both

Every variant is timed twice, in turns (A B B A), 10 calls each time, by
CUDA events: ``ms`` as the host issues the calls, and ``device_ms`` with
the calls queued behind a spin of the card, so a kernel shorter than its
wrapper's host work is timed at the card's pace. Each quantize case is
also profiled (``torch.profiler``, 10 calls after 2 warm-up calls): every
kernel it launches, fills included, with its device ms per launch and its
launches per call. ``--save-outputs`` keeps each case's outputs; ``--compare-outputs`` reads
such a file (another tree's) and reports max |d| and bit-equality per case.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

# (variant -> text edits); an edit applies where its text occurs, and each
# variant must change the source
EDITS = {
    "store": (
        ("atomicAdd(dvb + tok[c] * row + d, prod);", "dvb[tok[c] * row + d] = prod;"),
        ("atomicAdd(reinterpret_cast<float4*>(p), ", "*reinterpret_cast<float4*>(p) = ("),
        ("atomicAdd(reinterpret_cast<float4*>(p + half), ",
         "*reinterpret_cast<float4*>(p + half) = ("),
    ),
    "const": (
        ("to_f32(vb[tok[c] * row + d])", "1.0f"),
        ("load_lane8(vb + tok[k] * row, half)", "Lane8<T>{}"),
    ),
}
EDITS["store+const"] = EDITS["store"] + EDITS["const"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--variants", default="kernel")
    ap.add_argument("--inputs", help="captured inputs: written if missing, else read")
    ap.add_argument("--save-outputs")
    ap.add_argument("--compare-outputs")
    return ap.parse_args(argv)


SPIN_CYCLES = 10_000_000  # ~5 ms of an H100's clock: the host queues 10 calls meanwhile


def cuda_ms(torch, fn, iters, spin=False):
    """Mean ms of ``fn()`` over ``iters`` calls after one warm-up (CUDA
    events). With ``spin`` the calls queue behind a spin of the card, so
    the time is the card's, not the host's issuing of the calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split(torch, fn, calls, windows=3):
    """Each kernel (fills and copies included) that ``calls`` calls of
    ``fn`` launch, by ``torch.profiler``'s device events after 2 warm-up
    calls, the card synchronised after each call: its mean device ms per
    launch and its launches per call. The profiler has lost one call's
    kernel records in 10, and once every device record of a window (H100,
    torch 2.11), so the exact count of a call's launches is
    :func:`graph_nodes`'s, and a window with no device record at all is
    profiled again, up to ``windows`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total_us, count = {}, {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type.name == "CUDA":
                key = e.name[:80]
                total_us[key] = total_us.get(key, 0.0) + e.time_range.elapsed_us()
                count[key] = count.get(key, 0) + 1
        if count:
            break
    return {key: {"ms": total_us[key] / 1e3 / n, "launches_per_call": n / calls}
            for key, n in count.items()}


# cudaGraphNodeType
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def _cudart(torch):
    """The CUDA runtime library that PyTorch loaded."""
    import ctypes
    import glob
    import os

    root = os.path.dirname(torch.__file__)
    for pattern in (os.path.join(root, "lib", "libcudart.so*"),
                    os.path.join(root, "..", "nvidia", "cuda_runtime", "lib", "libcudart.so*")):
        found = sorted(glob.glob(pattern))
        if found:
            return ctypes.CDLL(found[0])
    raise FileNotFoundError(f"no libcudart beside torch ({root})")


def graph_nodes(torch, fn):
    """The operations one call of ``fn`` puts on the card, by type
    (``{"kernel": n, "memset": n, ...}``): the call captured into a CUDA
    graph on a side stream, after two calls on that stream so that its
    per-stream state (the quantize's workspace) exists, and the graph's
    nodes read from the CUDA runtime. Exact, where profiler records can be
    lost."""
    import collections
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    rt = _cudart(torch)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cudaGraphGetNodes failed")
    kinds = collections.Counter()
    for node in nodes:
        t = ctypes.c_int(-1)
        if rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cudaGraphNodeGetType failed")
        kinds[GRAPH_NODE_TYPES.get(t.value, f"type {t.value}")] += 1
    return dict(kinds)


def capture_inputs(torch, dev):
    """(shapes, value, locs, weights, g) of encoder layer 0's MSDA backward
    in one bf16 train step of the training bench."""
    from pairnet_torch.bench import TRAIN_BATCH, train_batch, train_setup
    from pairnet_torch.ops import deform_attn_bwd as bwd_mod
    from pairnet_torch.train.trainer import to_device

    got = {}
    orig = bwd_mod.deform_attn_bwd

    def capturing(value, shapes, locs, weights, g, bwd="exact"):
        # the backward runs the layers last to first: the last call is layer 0's
        got["in"] = (shapes, *(t.detach().clone() for t in (value, locs, weights, g)))
        return orig(value, shapes, locs, weights, g, bwd)

    capturing.launches = orig.launches
    model, state, step = train_setup(dev)
    batch = to_device(train_batch(TRAIN_BATCH), dev)
    bwd_mod.deform_attn_bwd = capturing
    try:
        step(state, batch)
    finally:
        bwd_mod.deform_attn_bwd = orig
    torch.cuda.synchronize()
    del model, state, step, batch
    torch.cuda.empty_cache()
    return got["in"]


def variant_libs(bwd_mod, build_mod, names):
    """The backward library of each variant, built from the edited source."""
    orig_csrc = build_mod.CSRC
    src = (orig_csrc / "deform_attn_bwd.cu").read_text()
    libs = {}
    for name in names:
        text = src
        if name != "kernel":
            for old, new in EDITS[name]:
                text = text.replace(old, new)
            if text == src:
                raise SystemExit(f"variant {name!r} changes nothing in {orig_csrc}")
        d = build_mod.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        for header in orig_csrc.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / "deform_attn_bwd.cu").write_text(text)
        build_mod.CSRC = d
        build_mod._libs.pop("deform_attn_bwd", None)
        bwd_mod._lib.cache_clear()
        try:
            libs[name] = bwd_mod._lib()
        finally:
            build_mod.CSRC = orig_csrc
            build_mod._libs.pop("deform_attn_bwd", None)
            bwd_mod._lib.cache_clear()
    return libs


def main(argv=None):
    args = parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import pairnet_torch
    from pairnet_torch.bench import gpu_name_and_power_limit
    from pairnet_torch.ops import _build
    from pairnet_torch.ops import deform_attn_bwd as bwd_mod
    from pairnet_torch.ops.deform_attn_exact import deform_attn_exact
    from pairnet_torch.ops.deform_attn_int4 import int4_gather, int4_quantize
    from pairnet_torch.ops.deform_attn_int8 import int8_gather, int8_quantize

    if Path(pairnet_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"imported {pairnet_torch.__file__}, not the tree {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("msda_kernels: needs a GPU")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.inputs and Path(args.inputs).exists():
        saved = torch.load(args.inputs, map_location=dev)
        shapes, value, locs, w, g = (saved["shapes"], saved["value"], saved["locs"],
                                     saved["weights"], saved["g"])
    else:
        shapes, value, locs, w, g = capture_inputs(torch, dev)
        if args.inputs:
            Path(args.inputs).parent.mkdir(parents=True, exist_ok=True)
            torch.save({"shapes": shapes, "value": value, "locs": locs, "weights": w, "g": g},
                       args.inputs)
    v1 = value[:1].float()
    v8 = value.repeat(2, 1, 1, 1)  # the serving batch
    codes4, scales4 = int4_quantize(value, shapes)
    codes8, scales8 = int8_quantize(value, shapes)
    fwd_cases = {
        "exact bf16 b4": lambda: deform_attn_exact(value, shapes, locs, w),
        "exact f32 b1": lambda: deform_attn_exact(v1, shapes, locs[:1], w[:1]),
        "int4 gather b4": lambda: int4_gather(codes4, scales4, shapes, locs, w),
        "int8 gather bf16 b4": lambda: int8_gather(codes8, scales8, shapes, locs, w),
        "int8 gather f32 b4": lambda: int8_gather(codes8, scales8, shapes, locs, w,
                                                  torch.float32),
    }
    quant_cases = {}
    for b, vb in ((4, value), (8, v8)):
        quant_cases[f"int4 quantize bf16 b{b}"] = lambda vb=vb: int4_quantize(vb, shapes)
        quant_cases[f"int8 quantize bf16 b{b}"] = lambda vb=vb: int8_quantize(vb, shapes)
        quant_cases[f"int8 quantize f32 b{b}"] = (
            lambda vf=vb.float(): int8_quantize(vf, shapes))
    fwd_cases.update(quant_cases)
    bwd_cases = {"bwd f32 b1": (v1, locs[:1], w[:1], g[:1], "exact"),
                 "bwd bf16 b4": (value, locs, w, g, "exact"),
                 "bwd bf16_grad b4": (value, locs, w, g, "bf16_grad")}

    names = args.variants.split(",")
    orig_lib = bwd_mod._lib
    libs = variant_libs(bwd_mod, _build, names)
    current = [libs[names[0]]]
    bwd_mod._lib = lambda: current[0]

    def run_bwd(case):
        return bwd_mod.deform_attn_bwd(case[0], shapes, case[1], case[2], case[3], case[4])

    bwd_fns = {key: (lambda case=case: run_bwd(case)) for key, case in bwd_cases.items()}
    times = {t: {n: {} for n in names} for t in ("ms", "device_ms")}
    for r in range(2):
        for name in (names if r % 2 == 0 else names[::-1]):
            current[0] = libs[name]
            cases = {**fwd_cases, **bwd_fns} if name == "kernel" else bwd_fns
            for key, fn in cases.items():
                for t, spin in (("ms", False), ("device_ms", True)):
                    times[t][name].setdefault(key, []).append(cuda_ms(torch, fn, 10, spin))

    def means(by_name):
        return {n: {k: sum(t) / len(t) for k, t in c.items()} for n, c in by_name.items()}

    result = {"gpu": gpu_name_and_power_limit(), "device": torch.cuda.get_device_name(0),
              "tree": str(tree), "shapes": shapes, **times,
              "mean_ms": means(times["ms"]), "mean_device_ms": means(times["device_ms"])}
    if "kernel" in libs:
        current[0] = libs["kernel"]
        result["quantize_kernels"] = {key: kernel_split(torch, fn, 10)
                                      for key, fn in quant_cases.items()}
    if "kernel" in libs and (args.save_outputs or args.compare_outputs):
        outs = {}
        for key, fn in fwd_cases.items():
            out = fn()
            outs[key] = out if isinstance(out, tuple) else (out,)
        outs.update({key: run_bwd(case) for key, case in bwd_cases.items()})
        torch.cuda.synchronize()
        if args.save_outputs:
            torch.save({k: [t.cpu() for t in v] for k, v in outs.items()}, args.save_outputs)
        if args.compare_outputs:
            ref = torch.load(args.compare_outputs)
            result["compare"] = {
                key: {"bit_equal": all(torch.equal(a.cpu(), b) for a, b in zip(outs[key], ref[key])),
                      "max_abs_diff": [float((a.cpu().float() - b.float()).abs().max())
                                       for a, b in zip(outs[key], ref[key])]}
                for key in outs}
    bwd_mod._lib = orig_lib
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
