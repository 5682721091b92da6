"""The command on the card: one short run of a cell, its last line, and a
traced one with a device record (``-m cuda``; skipped without a card)."""

import json
import subprocess
import sys

import pytest

from portbench.registry import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ("0", "1"))
def test_cell_on_the_card(cuda_device, trace):
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "pairnet_r50.serve_b1", "--seed", "2147483659", "--seconds", "2",
                          "--trace", trace], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1 and line["device"]["memory_peak_bytes"] > 0
    if trace == "1":
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and "backbone_ms.latency" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"latency_p95_ms", "setup_s"}
