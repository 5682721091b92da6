"""Time the kernels that stand for JAX device loops (``csrc/hungarian.cu``'s
two instances and ``csrc/nms.cu``) against another checkout's, on one card,
in turns. Needs a GPU::

    python pairnet_torch/tools/loop_kernels.py --parent DIR [--inputs FILE]
        [--cases short,long,nms] [--rounds 2] [--out FILE]

``--parent`` is the root of another checkout; its ``hungarian.cu`` and
``nms.cu`` are built with this tree's nvcc flags under
``pairnet_torch/_build/parent/`` and called through their C entries (the
NMS entry with or without the scratch pointer, whichever that source
has). ``--inputs`` is a file that ``chip_smoke.py`` writes when
``CHIP_SMOKE_LOOP_INPUTS`` names it: the short instance's prepared costs
from phase 12 (the flagship step's two matchers, the synthetic step
shape, 12 x 100 x 100 padded to a few valid columns) and phase 24 (the
zoo matchers' first costs), phase 28's encoder-matcher costs (2 x 64 x
22,323) for the long instance, and phase 30's RPN (2 x 4,819 boxes) and
detection (2 x 256) NMS calls. Without it the inputs are seeded ones of
those shapes. ``--cases`` picks which of the three to run.

Each case checks that both checkouts give the plain version's results
(assignments and every problem's search steps, keep masks), then times
the parent's call and this tree's in turns (parent, this, this, parent
for 2 rounds), 10 calls each: ``ms`` by CUDA events as the host issues
them, ``device_ms`` queued behind a spin of the card. It also reports
each call's kernels by the profiler (device ms and launches per call),
the Hungarian's search steps and ns a step (device ms over the longest
problem's steps), the cluster size of this tree's long instance, and
``scipy.optimize.linear_sum_assignment`` on the host over the long
instance's costs. Prints one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

_P, _I = ctypes.c_void_p, ctypes.c_int


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the checkout to compare with")
    ap.add_argument("--inputs", help="chip_smoke.py's saved loop-kernel inputs")
    ap.add_argument("--cases", default="short,long,nms", help="of short, long, nms")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON result here")
    return ap.parse_args(argv)


def parent_libs(build_mod, tree: Path) -> dict:
    """The parent's hungarian and nms libraries, built from its sources."""
    orig = (build_mod.CSRC, build_mod.BUILD_DIR)
    build_mod.CSRC = tree / "pairnet_torch" / "csrc"
    build_mod.BUILD_DIR = orig[1] / "parent"
    try:
        paths = build_mod.build(("hungarian", "nms"))
    finally:
        build_mod.CSRC, build_mod.BUILD_DIR = orig
    libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
    h = libs["hungarian"]
    h.hungarian_solve.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    h.hungarian_solve.restype = _I
    h.hungarian_solve_long.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
    h.hungarian_solve_long.restype = _I
    h.hungarian_long_workspace.argtypes = [_I, _I]
    h.hungarian_long_workspace.restype = ctypes.c_longlong
    n = libs["nms"]
    n.scratch = hasattr(n, "nms_scratch_bytes")
    n.nms_sorted.argtypes = [_P] * (4 if n.scratch else 3) + [_I, _I, ctypes.c_float, _P]
    n.nms_sorted.restype = _I
    if n.scratch:
        n.nms_scratch_bytes.argtypes = [_I, _I]
        n.nms_scratch_bytes.restype = ctypes.c_longlong
    return libs


def seeded_inputs(torch, dev):
    """Inputs of the path's shapes. The short instance: normal costs of the
    flagship step's two matchers (4 x 24 x 100, 4 x 40 x 100) and of 4 x
    100 x 100, and 12 x 100 x 100 (PSGTr's HTriMatcher: 6 layers x 2
    images) with 3 and 5 valid columns, the rest PAD_COST, all prepared as
    the wrapper prepares them. The long instance: costs 2 x 64 x 22,323
    whose rows share a preference over the columns (a column term plus a
    tenth of a row-column term, normal), so that searches run long as the
    matcher's do. NMS: boxes over an 800 x 1344 image sorted by a random
    score, a tenth invalid, for the RPN's call (2 x 4,819, thr 0.7) and the
    detections' (2 x 256, 0.5)."""
    from pairnet_torch.ops.hungarian import prepare
    from pairnet_torch.ops.nms import score_order

    g = torch.Generator(device=dev).manual_seed(14)
    short = {f"normal {B}x{n}x{m}": torch.randn((B, n, m), generator=g, device=dev)
             for B, n, m in ((4, 24, 100), (4, 40, 100), (4, 100, 100))}
    valid = torch.arange(100, device=dev)[None] < torch.tensor([3, 5] * 6, device=dev)[:, None]
    short["padded 12x100x100"] = prepare(5 * torch.randn((12, 100, 100), generator=g, device=dev),
                                         None, valid)[0]
    cost = (torch.randn((2, 1, 22323), generator=g, device=dev)
            + 0.1 * torch.randn((2, 64, 22323), generator=g, device=dev))

    def boxes(n, thr):
        xy = torch.rand((2, n, 2), generator=g, device=dev) * torch.tensor([1344.0, 800.0],
                                                                            device=dev)
        wh = 8 + torch.rand((2, n, 2), generator=g, device=dev) * 300
        b = torch.cat([xy, xy + wh], -1)
        valid = torch.rand((2, n), generator=g, device=dev) > 0.1
        order = score_order(torch.rand((2, n), generator=g, device=dev), valid)
        return (torch.gather(b, 1, order[..., None].expand(-1, -1, 4)).contiguous(),
                torch.gather(valid, 1, order).contiguous(), thr)

    return {"short_step": short, "hungarian_long": cost, "nms_rpn": boxes(4819, 0.7),
            "nms_det": boxes(256, 0.5)}


def main(argv=None):
    args = parse_args(argv)
    import torch

    from pairnet_torch.bench import gpu_name_and_power_limit
    from pairnet_torch.ops import _build
    from pairnet_torch.ops import nms as nms_mod
    from pairnet_torch.ops.hungarian import (
        SHORT_COLS,
        batched_hungarian,
        long_cluster,
        solve_n_le_m_cuda,
        solve_n_le_m_plain_steps,
    )
    from pairnet_torch.tools.msda_kernels import cuda_ms, kernel_split

    if not torch.cuda.is_available():
        raise SystemExit("loop_kernels: needs a GPU")
    dev = torch.device("cuda:0")
    inputs = (torch.load(args.inputs, map_location=dev) if args.inputs
              else seeded_inputs(torch, dev))
    libs = parent_libs(_build, Path(args.parent).resolve())
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_hungarian(cost):
        B, n, m = cost.shape
        h = libs["hungarian"]
        row2col = torch.empty((B, n), dtype=torch.long, device=dev)
        steps = torch.empty((B,), dtype=torch.int32, device=dev)
        if m <= SHORT_COLS:
            status = h.hungarian_solve(cost.data_ptr(), row2col.data_ptr(), steps.data_ptr(),
                                       B, n, m, stream())
        else:
            ws = torch.empty((B * h.hungarian_long_workspace(n, m),), dtype=torch.int32,
                             device=dev)
            status = h.hungarian_solve_long(cost.data_ptr(), row2col.data_ptr(),
                                            steps.data_ptr(), B, n, m, ws.data_ptr(), stream())
        _build.check(status, "parent hungarian")
        return row2col, steps

    def hungarian_case(cost):
        """Both checkouts against the plain loop (row2col and each problem's
        search steps), and the two calls to time."""
        syncs = batched_hungarian.syncs
        want, want_steps = solve_n_le_m_plain_steps(cost)
        got_p, steps_p = parent_hungarian(cost)
        got_c, steps_c = solve_n_le_m_cuda(cost)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in ((got_p, want), (got_c, want),
                                                   (steps_p, want_steps), (steps_c, want_steps)))
        return {"shape": list(cost.shape), "equal_to_plain": equal,
                "plain_syncs": batched_hungarian.syncs - syncs,
                "search_steps": steps_c.tolist(),
                "fns": {"parent": lambda: parent_hungarian(cost),
                        "this": lambda: solve_n_le_m_cuda(cost)}}

    def parent_nms(boxes, valid, thr):
        B, n, _ = boxes.shape
        lib = libs["nms"]
        v8 = valid.to(torch.uint8)
        keep = torch.empty((B, n), dtype=torch.uint8, device=dev)
        ptrs = [boxes.data_ptr(), v8.data_ptr(), keep.data_ptr()]
        if lib.scratch:
            scratch = torch.empty((lib.nms_scratch_bytes(B, n),), dtype=torch.uint8, device=dev)
            ptrs.append(scratch.data_ptr())
        _build.check(lib.nms_sorted(*ptrs, B, n, float(thr), stream()), "parent nms")
        return keep.bool()

    which = set(args.cases.split(","))
    cases = {}
    if "short" in which:
        for group in ("short_step", "short_zoo"):
            for name, cost in inputs.get(group, {}).items():
                cases[f"hungarian_short {name}"] = hungarian_case(cost)
    if "long" in which:
        cost = inputs["hungarian_long"]
        cases["hungarian_long"] = case = hungarian_case(cost)
        from scipy.optimize import linear_sum_assignment

        host = cost.cpu().numpy()
        t0 = time.perf_counter()
        for b in range(host.shape[0]):
            linear_sum_assignment(host[b])
        case["scipy_host_ms"] = (time.perf_counter() - t0) * 1e3
        case["cluster_ctas"] = long_cluster(cost.shape[2])
    for key in ("nms_rpn", "nms_det") if "nms" in which else ():
        boxes, valid, thr = inputs[key]
        want = nms_mod.nms_sorted_plain(boxes, valid, thr)
        got_p = parent_nms(boxes, valid, thr)
        got_c = nms_mod.nms_sorted_cuda(boxes, valid, thr)
        torch.cuda.synchronize()
        cases[key] = {
            "shape": list(boxes.shape[:2]), "thr": thr, "kept": want.sum(1).tolist(),
            "equal_to_plain": bool(torch.equal(got_p, want) and torch.equal(got_c, want)),
            "fns": {"parent": lambda b=boxes, v=valid, t=thr: parent_nms(b, v, t),
                    "this": lambda b=boxes, v=valid, t=thr: nms_mod.nms_sorted_cuda(b, v, t)}}

    for case in cases.values():
        fns = case.pop("fns")
        times = {t: {"parent": [], "this": []} for t in ("ms", "device_ms")}
        for r in range(args.rounds):
            for who in (("parent", "this") if r % 2 == 0 else ("this", "parent")):
                times["ms"][who].append(cuda_ms(torch, fns[who], 10))
                times["device_ms"][who].append(cuda_ms(torch, fns[who], 10, spin=True))
        case.update(times)
        case["kernels"] = {who: kernel_split(torch, fn, 10) for who, fn in fns.items()}
    for name, case in cases.items():
        if name.startswith("hungarian"):
            case["ns_per_step"] = {who: min(t) * 1e6 / max(max(case["search_steps"]), 1)
                                   for who, t in case["device_ms"].items()}
    result = {"gpu": gpu_name_and_power_limit(), "device": torch.cuda.get_device_name(0),
              "parent": str(Path(args.parent).resolve()),
              "inputs": args.inputs or "seeded", "cases": cases}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    ok = all(c["equal_to_plain"] for c in cases.values())
    if not ok:
        raise SystemExit("loop_kernels: a kernel's result differs from its plain version")
    return result


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    main()
