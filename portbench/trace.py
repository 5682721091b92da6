"""The traced window: ``torch.profiler`` over a few units of work, reduced
to what the per-layer readers and the result's ``breakdown`` need.

The window is the harness's own ``portbench.window`` annotation, which
ends after a synchronise, so every device record of its work lies inside
it. Busy time is the union of the kernel, memcpy and memset intervals in
it (overlaps count once). Idle gaps are the stretches of the window with
no device record, labelled with what the host was doing at their middle:
the harness's outermost annotation and the innermost host event (the
200 longest gaps; the rest are summed under one label). The port's own
spans in the same events go to ``program`` (``portbench/program.py``);
they are there only while the port's tracer is on, which
:func:`traced_program` switches on for passes of its own, after the
window. A window that holds no device record is profiled again, up to
three more times.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "portbench.window"
TRIES = 4
LABELLED_GAPS = 200  # the longest gaps are labelled one by one, the rest summed


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)  # (name, seconds) of every kernel record
    device_ops: list = field(default_factory=list)  # [name, seconds], the 10 longest in total
    idle_gaps: list = field(default_factory=list)  # [label, seconds], the 10 longest in total
    empty_windows: int = 0
    program: object = None  # program.ProgramSummary of the port's spans in the window, or None

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """(total seconds, records) of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for n, d in self.kernels if rx.search(n)]
        return sum(hits), len(hits)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list) -> TraceSummary | None:
    """A summary of a chrome trace's events (microsecond timestamps), or
    None if it holds no window annotation or no device record in it."""
    windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, t = e["ts"], e["ts"] + e["dur"]
        if cat in DEVICE_CATS and t > w0 and s < w1:
            dev.append((max(s, w0), min(t, w1), cat, e["name"]))
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((s, t, cat, e["name"]))
    if not dev:
        return None
    busy = _union((s, t) for s, t, _, _ in dev)
    op_time = defaultdict(float)
    for s, t, _, name in dev:
        op_time[name] += (t - s) * 1e-6
    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gap_time = defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    hs = np.array([h[0] for h in host] or [0.0])
    ht = np.array([h[1] for h in host] or [-1.0])
    for g0, g1 in gaps[:LABELLED_GAPS]:
        mid = 0.5 * (g0 + g1)
        over = [host[i] for i in np.flatnonzero((hs <= mid) & (ht >= mid))]
        ours = [h for h in over if h[2] == "user_annotation" and h[3].startswith("portbench.")]
        outer = max(ours, key=lambda h: h[1] - h[0])[3] if ours else "harness"
        inner = min(over, key=lambda h: h[1] - h[0])[3] if over else "no host event"
        gap_time[f"{outer} / {inner}"] += (g1 - g0) * 1e-6
    if len(gaps) > LABELLED_GAPS:
        gap_time[f"the {len(gaps) - LABELLED_GAPS} shorter gaps"] = sum(
            g1 - g0 for g0, g1 in gaps[LABELLED_GAPS:]) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    from portbench import program  # imports this module

    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(t - s for s, t in busy) * 1e-6,
        kernels=[(n, (t - s) * 1e-6) for s, t, c, n in dev if c == "kernel"],
        device_ops=top(op_time),
        idle_gaps=top(gap_time),
        program=program.summarize(events),
    )


def traced(work, sync) -> TraceSummary | None:
    """Profile ``work()`` (a few units) inside the window annotation, then
    ``sync()``; again while the window holds no device record. Prints the
    number of empty windows on standard error."""
    from torch.profiler import ProfilerActivity, profile, record_function

    summary, empty = None, 0
    for _ in range(TRIES):
        sync()
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(WINDOW):
                    work()
                    sync()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                summary = summarize(json.load(f).get("traceEvents", []))
        if summary is not None:
            break
        empty += 1
        time.sleep(0.1)
    print(f"portbench: traced windows without a device record: {empty}", file=sys.stderr)
    if summary is not None:
        summary.empty_windows = empty
    return summary


def traced_program(work, sync):
    """The port's own figures over ``work()`` with its tracer on
    (``sut.tracer``): the growth of its counters over one pass, unprofiled,
    and the summary of its spans over a second pass, profiled (or None).
    The passes come after the measured and the traced windows, so the
    tracer's cost (its spans, and the process CPU clock read at each unit's
    ends) moves no other reading."""
    from portbench import sut

    with sut.tracer():
        sync()
        before = sut.snapshot()
        work()
        sync()
        counts = sut.counts_since(before)
        summary = traced(work, sync)
    return counts, None if summary is None else summary.program
