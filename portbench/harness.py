"""What the run kinds share: the run's record, device clocks, the stage
spans of the traced run and the guard against the JAX package."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "pairnet_tpu")


@dataclass
class Record:
    """What a run measured and checked; the metric readers read it."""

    attempted: int = 0
    failed: int = 0
    end_to_end: dict = field(default_factory=dict)  # metric name -> value
    spans: dict = field(default_factory=dict)  # span name -> ms of each unit of the window
    images: int = 0  # images completed in the window
    window_s: float = 0.0
    flops_per_image: float = 0.0  # counted from the configuration's shapes
    peak_window_bytes: int = 0
    memory_peak_bytes: int = 0
    trace: object = None  # trace.TraceSummary of the traced window, or None
    trace_units: int = 0  # units of work inside the traced window
    counts: dict = field(default_factory=dict)  # per-layer counts from shapes (e.g. MSDA bounds)
    program_counts: dict = field(default_factory=dict)  # traced runs: the port's counters' growth, tracer on
    checks: dict = field(default_factory=dict)  # name -> (value, limit); correct iff value <= limit
    device_kind: str = ""
    device_count: int = 1

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


class Device:
    """Events, synchronise and memory readings on the card, or host-clock
    stand-ins on the CPU (the harness's own tests)."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def event(self):
        """A recorded event; ``ms(a, b)`` reads the span between two."""
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def pin(self, t):
        return t.pin_memory() if self.cuda else t

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def free(self):
        if self.cuda:
            self.torch.cuda.empty_cache()

    def name(self) -> str:
        return self.torch.cuda.get_device_name(self.device) if self.cuda else "cpu"


class Spans:
    """Events at the boundaries of named parts, recorded by forward hooks on
    the system's modules and by the harness; each unit's span of a part is
    the device timeline between its boundary and the previous one, gaps
    included. A module missing from the model leaves its part out."""

    def __init__(self, dev: Device, model=None, boundaries=()):
        self.dev = dev
        self.marks: list[list[tuple[str, object]]] = []
        self.handles = []
        if model is not None:
            modules = dict(model.named_modules())
            for part, module in boundaries:
                if module in modules:
                    self.handles.append(modules[module].register_forward_hook(
                        lambda *_, part=part: self.mark(part)))

    def start(self):
        self.marks.append([("start", self.dev.event())])

    def mark(self, part: str):
        if self.marks:
            self.marks[-1].append((part, self.dev.event()))

    def close(self) -> dict:
        for h in self.handles:
            h.remove()
        self.dev.sync()
        out: dict[str, list[float]] = {}
        for unit in self.marks:
            for (_, a), (part, b) in zip(unit, unit[1:]):
                out.setdefault(part, []).append(self.dev.ms(a, b))
        return out


class SetupParts:
    """Seconds of each part of the set-up since ``t0`` (the process's
    start), printed on standard error: what only a change to the system
    could shorten shows here."""

    def __init__(self, t0: float, dev: Device):
        self.t0, self.dev, self.last, self.parts = t0, dev, t0, []
        self.mark("imports and start")

    def mark(self, name: str):
        self.dev.sync()
        now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def done(self) -> float:
        self.mark("last")
        print("portbench: set-up s: " + ", ".join(f"{n} {s:.3f}" for n, s in self.parts),
              file=sys.stderr)
        return self.last - self.t0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: ``pairnet_torch`` is not ``pairnet_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@contextmanager
def no_tf32():
    """TF32 off for the plain reference's float32 products, restored after."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def rel_err(a, b) -> float:
    """|a - b| / |b| in float32 (L2 over every entry)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))
