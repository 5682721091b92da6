"""The port's own spans (``pairnet.*``, ``pairnet_torch/utils/tracing.py``)
in a profiled window, reduced to per-span figures, and the readers'
arithmetic over them.

Attribution is by time, not by thread. The program's spans cut the
timeline into stretches, each held by the spans whose intervals cover it.
A device-idle stretch, a CUDA runtime or driver-API call, and a device record
(through the runtime call that launched it, by correlation id) go to every
span that holds them; the ``self_`` figures to the innermost alone. The
units are the ``pairnet.serve`` and ``pairnet.train.step`` spans: what lies
outside every unit is the harness's and is left out.

The harness's traced run (``--trace 1``) ends with two passes over its
traced units with the port's tracer on (``trace.traced_program``): it keeps
the growth of the port's counters over the first as ``program_counts`` and
the summary of the second, profiled, as ``trace.program``; the readers
(``portbench/metrics/``) take their metrics from those. This module's
command makes one such run and prints the span table, the counts a unit
and the run's result line::

    python3 -m portbench.program --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import re
from bisect import bisect_right
from dataclasses import asdict, dataclass, field

import numpy as np

from portbench.trace import DEVICE_CATS, _union

PREFIX = "pairnet."
UNITS = ("serve", "train.step")
CALL_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchCooperativeKernel|cudaGraphLaunch)")
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"})


@dataclass
class SpanFigures:
    """One program span's figures over the window, every call summed."""

    calls: int = 0
    host_ms: float = 0.0  # the calls' wall time on the host
    device_ms: float = 0.0  # device records launched inside
    kernels: int = 0  # kernel records launched inside
    idle_ms: float = 0.0  # device idle inside
    launches: int = 0  # kernel-launch calls inside
    syncs: int = 0  # host-blocking calls inside
    self_idle_ms: float = 0.0
    self_launches: int = 0
    self_syncs: int = 0


@dataclass
class ProgramSummary:
    units: int  # unit spans in the window
    spans: dict = field(default_factory=dict)  # name without the prefix -> SpanFigures

    def per_unit(self, fig: str, *names: str):
        """``fig`` of ``names`` summed, a unit; None if one is missing."""
        rows = [self.spans.get(n) for n in names]
        if not self.units or not all(rows):
            return None
        return sum(getattr(r, fig) for r in rows) / self.units

    def unit_figure(self, fig: str):
        """``fig`` of the unit spans, a unit."""
        return self.per_unit(fig, *[u for u in UNITS if u in self.spans])

    def table(self) -> str:
        head = ("span", "calls", "host ms", "device ms", "idle ms", "self idle", "launches",
                "syncs")
        rows = [f"{n:<24} {r.calls:>6} {r.host_ms:>10.3f} {r.device_ms:>10.3f} "
                f"{r.idle_ms:>10.3f} {r.self_idle_ms:>10.3f} {r.launches:>9} {r.syncs:>6}"
                for n, r in sorted(self.spans.items())]
        return "\n".join([" ".join(head)] + rows)


def summarize(events: list) -> ProgramSummary | None:
    """The program's spans in a chrome trace's events (microsecond
    timestamps), or None if it holds no unit span."""
    spans, device, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = str(e.get("cat", "")).lower(), e.get("name", "")
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((s, t, name[len(PREFIX):]))
        elif cat in DEVICE_CATS:
            device.append((s, t, cat, corr))
        elif cat in CALL_CATS:
            calls.append((s, name, corr))
    units = [sp for sp in spans if sp[2] in UNITS]
    if not units:
        return None
    out = ProgramSummary(units=len(units))
    for s, t, name in spans:
        row = out.spans.setdefault(name, SpanFigures())
        row.calls += 1
        row.host_ms += (t - s) * 1e-3

    # the stretches between span boundaries; each held by the spans covering it
    bounds = np.unique([b for s, t, _ in spans for b in (s, t)])
    starts = np.array([s for s, _, _ in spans])
    ends = np.array([t for _, t, _ in spans])
    names = [n for _, _, n in spans]
    held = []  # per stretch: (names holding it, the innermost's name) or None
    for a, b in zip(bounds[:-1], bounds[1:]):
        cover = np.flatnonzero((starts <= a) & (ends >= b))
        if not any(names[i] in UNITS for i in cover):
            held.append(None)
            continue
        inner = cover[np.argmin(ends[cover] - starts[cover])]
        held.append(({names[i] for i in cover}, names[inner]))

    def stretch(t):
        k = bisect_right(bounds, t) - 1
        return held[k] if 0 <= k < len(held) else None

    # device idle in each stretch: its length less the busy time in it
    busy = _union((s, t) for s, t, _, _ in device)
    b0 = np.array([s for s, _ in busy] or [0.0])
    b1 = np.array([t for _, t in busy] or [0.0])
    done = np.concatenate([[0.0], np.cumsum(b1 - b0)])

    def busy_before(t):  # busy time before t
        k = np.searchsorted(b0, t, side="right")
        return done[k - 1] + min(t, b1[k - 1]) - b0[k - 1] if k else 0.0

    for (a, b), h in zip(zip(bounds[:-1], bounds[1:]), held):
        if h is None:
            continue
        idle = ((b - a) - (busy_before(b) - busy_before(a))) * 1e-3
        for n in h[0]:
            out.spans[n].idle_ms += idle
        out.spans[h[1]].self_idle_ms += idle

    # CUDA runtime and driver-API calls; device records through their launching call
    launched_at = {}
    for s, name, corr in calls:
        h = stretch(s)
        if corr is not None:
            launched_at[corr] = h
        if h is None:
            continue
        launch, sync = LAUNCH.match(name) is not None, name in SYNCS
        for n in h[0]:
            out.spans[n].launches += launch
            out.spans[n].syncs += sync
        out.spans[h[1]].self_launches += launch
        out.spans[h[1]].self_syncs += sync
    for s, t, cat, corr in device:
        h = launched_at.get(corr)
        if h is None:
            continue
        for n in h[0]:
            out.spans[n].device_ms += (t - s) * 1e-3
            out.spans[n].kernels += cat == "kernel"
    return out


# --- the readers' arithmetic: a record's ``trace.program`` (the summary of
# the profiled pass with the tracer on) and ``program_counts`` (the
# difference of the port's ``tracing.snapshot()`` over the unprofiled one);
# None where it has none


def of(rec) -> ProgramSummary | None:
    return getattr(getattr(rec, "trace", None), "program", None)


def idle_ms(rec, *names: str):
    """Device-idle ms a unit inside the spans ``names``, summed."""
    p = of(rec)
    return None if p is None else p.per_unit("idle_ms", *names)


def unit_figure(rec, fig: str):
    p = of(rec)
    return None if p is None else p.unit_figure(fig)


def per_unit_count(rec, key: str, scale: float = 1.0):
    """The window's count ``key`` a unit (the unit spans the tracer
    counted in the same window), times ``scale``."""
    counts = getattr(rec, "program_counts", None) or {}
    units = next((counts[f"{u}.units"] for u in UNITS if counts.get(f"{u}.units")), 0)
    if not units or key not in counts:
        return None
    return counts[key] * scale / units


def unit_cpu_ms(rec):
    """The process CPU ms a unit span took, every thread's."""
    counts = getattr(rec, "program_counts", None) or {}
    unit = next((u for u in UNITS if counts.get(f"{u}.units")), None)
    return None if unit is None else per_unit_count(rec, f"{unit}.cpu_ns", 1e-6)


# --- the command


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from portbench.registry import Bench
    from portbench.run import run_cell

    ap = argparse.ArgumentParser(description="a traced run of a cell and the port's figures")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench.program: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    result, rec = run_cell(bench, args.workload, args.seed, args.seconds, True, "cuda:0")
    units = max(rec.trace_units, 1)
    figures = {"counts_per_unit": {k: v / units for k, v in rec.program_counts.items() if v}}
    summary = of(rec)
    if summary is not None:
        print(summary.table(), file=sys.stderr)
        figures["spans"] = {n: asdict(r) for n, r in summary.spans.items()}
        figures["units"] = summary.units
    print(json.dumps({"workload": args.workload, "seed": args.seed, **figures, **result}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
