"""One run of one benchmark cell of the port (``pairnet_torch``) on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (weights and inputs from the seed,
the system, the warm-up of the cell's shapes) counts as ``setup_s`` from
the start of this process; then the window measures for ``--seconds``;
then the reference check. The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, also printed as the last lines of standard error. Exits
non-zero with no result when there is no card, when the cell asks for
more cards than there are, or when a module of the JAX stack or of the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from portbench.harness import forbidden_modules  # noqa: E402
from portbench.registry import Bench  # noqa: E402

CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def use_checkout_caches(root):
    """Point every kernel and compile cache that torch or a library it
    loads would write at a fixed directory inside the checkout (the port
    builds its own kernels into ``pairnet_torch/_build/`` there)."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".portbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float = T0):
    """(the result line's object, the record) of one run of ``name`` on
    ``device``. The check for a card is ``main``'s."""
    use_checkout_caches(bench.root)
    cell = bench.cell(name)
    kind = importlib.import_module(f"portbench.kinds.{cell.mix['kind']}")
    rec = kind.run(cell, seed, seconds, trace, device, t0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = bench.reader(m["name"])(rec) if trace else rec.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "cpu" if rec.device_kind == "cpu" else "gpu", "kind": rec.device_kind, "count": rec.device_count,
           "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    return result, rec


def power_limit() -> str:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    print(f"portbench: card {power_limit()}", file=sys.stderr)
    result, _ = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         "cuda:0")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the JAX stack or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
