"""Shared arithmetic of the per-layer metric readers
(``portbench/metrics/<metric>.py``). Each returns None where the run holds
nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

from statistics import fmean

from portbench.counts.flops import BF16_DENSE_FLOPS

MSDA_FORWARD = r"\b(absmax|quantize|gather|exact)_kernel\b"  # csrc/deform_attn_{quant,exact}.cu
MSDA_BACKWARD = r"\b(bwd|cast_bf16)_kernel\b"  # csrc/deform_attn_bwd.cu


def span_ms(rec, *parts: str):
    """Mean ms a unit of the window spent in ``parts``: each between its
    boundary and the previous one."""
    values = [rec.spans.get(p) for p in parts]
    if not all(values):
        return None
    return fmean(sum(v) for v in zip(*values))


def idle_percent(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_percent(rec):
    """Model FLOPs of the window's images (the forward's, times 3 in a
    training step: forward and backward) over the window's seconds, as a
    share of the dense bf16 peak."""
    if not rec.images or not rec.flops_per_image or rec.window_s <= 0:
        return None
    return 100.0 * rec.counts.get("passes", 1.0) * rec.flops_per_image * rec.images / rec.window_s / BF16_DENSE_FLOPS


def roofline_percent(rec, pattern: str):
    """The least time of the traced window's MSDA calls (from shapes) over
    the device time of the kernels matching ``pattern``."""
    t = rec.trace
    if t is None or "msda_least_s" not in rec.counts:
        return None
    seconds, n = t.kernel_seconds(pattern)
    if n == 0 or seconds <= 0:
        return None
    calls = rec.trace_units * rec.counts["msda_calls_per_unit"]
    return 100.0 * calls * rec.counts["msda_least_s"] / seconds


def peak_gib(rec):
    return rec.peak_window_bytes / 2 ** 30 if rec.peak_window_bytes else None
