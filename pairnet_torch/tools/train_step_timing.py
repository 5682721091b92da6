"""Time the R-50 train step of ``python -m pairnet_torch.bench --train`` one
step at a time, to compare two checkouts in paired runs. Needs a GPU::

    python pairnet_torch/tools/train_step_timing.py [--tree DIR] [--steps N] [--out FILE]

``--tree`` is the root of the checkout whose ``pairnet_torch`` is imported
and built (default: the one holding this file), so one copy of the script
times another commit's step. The step, model and seeded batch are the
bench's (batch 4, 800x1344, bf16 compute over f32 masters, the exact MSDA
kernels forward and backward). After two warm-up steps, each of ``--steps``
steps is timed alone, the card idle before it:

* ``wall_ms``: the host's clock from the call to the card's end of the
  step (the bench's number, one step at a time);
* ``device_ms``: CUDA events around the step on the card;
* ``issue_ms``: the host's clock until the call returns, its work queued;
* ``host_cpu_ms``: the CPU time of the calling thread over that call: the
  host work the step costs, which a host-bound step waits on.

Then one more step under ``cProfile`` counts the Python function calls a
step makes (the same for the same code, whatever the clock). Prints one JSON
line with the medians, the means, the quartiles and every step's numbers,
and writes it to ``--out`` when given. (Where the thread's CPU clock ticks
coarsely, as at 10 ms on some hosts, compare the means of ``host_cpu_ms``.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def quartiles(xs: list) -> list:
    s = sorted(xs)
    return [s[len(s) // 4], s[len(s) // 2], s[(3 * len(s)) // 4]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="root of the checkout to time")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import cProfile
    import pstats

    import torch

    import pairnet_torch
    from pairnet_torch.bench import TRAIN_BATCH, gpu_name_and_power_limit, train_batch, train_setup
    from pairnet_torch.flagship import resolve_device
    from pairnet_torch.train.trainer import to_device

    if not os.path.abspath(pairnet_torch.__file__).startswith(os.path.abspath(args.tree)):
        raise RuntimeError(f"imported {pairnet_torch.__file__}, not the tree {args.tree}")
    device = resolve_device(None)
    _, state, step = train_setup(device)
    batch = to_device(train_batch(TRAIN_BATCH), device)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rows = {"wall_ms": [], "device_ms": [], "issue_ms": [], "host_cpu_ms": []}
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        start.record()
        step(state, batch)
        end.record()
        t1, c1 = time.perf_counter(), time.thread_time()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows["wall_ms"].append((t2 - t0) * 1e3)
        rows["device_ms"].append(start.elapsed_time(end))
        rows["issue_ms"].append((t1 - t0) * 1e3)
        rows["host_cpu_ms"].append((c1 - c0) * 1e3)
    prof = cProfile.Profile()
    prof.enable()
    step(state, batch)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    result = {
        "tree": os.path.abspath(args.tree), "steps": args.steps, "batch": TRAIN_BATCH,
        "gpu": gpu_name_and_power_limit(),
        "median": {k: quartiles(v)[1] for k, v in rows.items()},
        "mean": {k: sum(v) / len(v) for k, v in rows.items()},
        "quartiles": {k: quartiles(v) for k, v in rows.items()},
        "python_calls_per_step": stats.total_calls,
        "per_step": rows,
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
