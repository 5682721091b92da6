"""The port's spans and counters, behind one switch that is off by default.

``span(name)`` marks a layer of the program. Off, it is one flag test that
returns a shared null context. On, it is
``torch.profiler.record_function("pairnet." + name)``: under a profiler the
span lands in the same trace as the kernels, copies and runtime calls it
causes, on one clock; without one it costs RecordFunction's bookkeeping.
``unit(name)`` is the span of one unit of work (a served batch, a train
step); while on, it also adds the process CPU time over the span, every
thread's (the autograd engine's launches the backward), to the unit's total.

``snapshot()`` reads the totals by name: the units', the counters that
the ops keep on their functions (``.launches``, ``.long_launches``,
``.syncs``, ``.steps``) and the program's own (``COUNTS``, counted with
``count``, on or off). ``enable`` is the only switch.
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import time
from collections.abc import Mapping

import torch

PREFIX = "pairnet."
COUNTERS = ("launches", "long_launches", "syncs", "steps")
# serving forwards that captured CUDA graphs, replayed them, or ran without
# them (``utils/serve_graph.py``)
COUNTS = ("serve_graph.captures", "serve_graph.replays", "serve_graph.eager")

_NULL = contextlib.nullcontext()
_on = False
_units: dict[str, list[int]] = {}  # unit name -> [units, process CPU ns]
_counts = dict.fromkeys(COUNTS, 0)


def enable(on: bool) -> None:
    """Turn the spans, and the units' CPU time, on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context marking the layer ``name`` (see the module's docstring)."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def unit(name: str):
    """:func:`span` of one unit of work, adding its process CPU time."""
    if not _on:
        return _NULL
    return _unit(name)


@contextlib.contextmanager
def _unit(name: str):
    with torch.profiler.record_function(PREFIX + name):
        t0 = time.process_time_ns()
        try:
            yield
        finally:
            total = _units.setdefault(name, [0, 0])
            total[0] += 1
            total[1] += time.process_time_ns() - t0


def count(name: str) -> None:
    """Add one to the program's count ``name`` (one of ``COUNTS``)."""
    _counts[name] += 1


def snapshot() -> dict[str, int]:
    """The totals so far: ``<unit>.units`` and ``<unit>.cpu_ns`` of each
    unit, the program's ``COUNTS``, and ``<function>.<counter>`` of every
    function of the port's ops modules that keeps one
    (``<function>.<counter>.<instance>`` for a count kept per kernel
    instance). A count kept on the device (the Hungarian's ``steps``) is
    read to the host here: read it outside a timed window."""
    out = {}
    for name, (n, ns) in _units.items():
        out[f"{name}.units"], out[f"{name}.cpu_ns"] = n, ns
    out.update(_counts)
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("pairnet_torch.ops.") or mod is None:
            continue
        for fname, fn in list(vars(mod).items()):
            if not inspect.isfunction(fn) or fn.__module__ != mod_name:
                continue
            for counter in COUNTERS:
                value = getattr(fn, counter, None)
                if isinstance(value, Mapping):
                    out.update({f"{fname}.{counter}.{k}": int(v) for k, v in value.items()})
                elif value is not None:
                    out[f"{fname}.{counter}"] = int(value)
    return out


def difference(before: dict, after: dict) -> dict[str, int]:
    """``after - before``, name by name (a name new in ``after`` from 0)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}
