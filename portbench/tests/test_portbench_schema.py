"""A run's last line keeps the contract's schema: driven on the CPU at
tiny sizes (the check for a card is the command's, not the cell's)."""

import json
import time

import pytest

from portbench.registry import Bench
from portbench.run import run_cell

CELLS = ("tiny_r50.serve_b8", "tiny_swin.serve_b1", "tiny_r50.train_b4")


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny_root, cell, trace):
    bench = Bench(tiny_root)
    result, rec = run_cell(bench, cell, 2 ** 31 + 7, 0.3, bool(trace), "cpu",
                           t0=time.perf_counter())
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    spec = bench.cell(cell)
    expected = spec.per_layer if trace else spec.end_to_end
    units = {m["name"]: m["unit"] for m in expected}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(units)
    else:
        spans = {"serve": "backbone_ms", "latency": "backbone_ms", "train": "forward_ms"}
        assert any(n.startswith(tuple(spans.values())) for n in line["metrics"])
        assert "breakdown" not in line  # the CPU's trace holds no device record
