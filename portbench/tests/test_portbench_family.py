"""A second model family, added to a copy of the checkout by files and
``BENCHMARK.json`` entries alone (``tiny.add_stub_family``), serves a tiny
cell through the harness: its boundaries mark the stage spans, its check
judges the run, and the result line keeps the contract's schema."""

import json
import shutil
import time

import pytest

from portbench.registry import ROOT, Bench
from portbench.run import run_cell
from portbench.tests.tiny import add_stub_family, make_root


@pytest.fixture(scope="module")
def stub_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family")
    checkout = tmp / "checkout"
    shutil.copytree(ROOT / "portbench", checkout / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", checkout)
    add_stub_family(checkout)
    return make_root(tmp / "tiny", checkout)


@pytest.mark.parametrize("trace", (0, 1))
def test_a_second_family_serves_a_tiny_cell(stub_root, trace):
    bench = Bench(stub_root)
    result, rec = run_cell(bench, "tiny_stub.serve_b1", 2 ** 31 + 11, 0.3, bool(trace), "cpu",
                           t0=time.perf_counter())
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["checks"]["family_stub"] == {"value": 0.0, "limit": 0.0}
    assert set(line["checks"]) == {"family_stub", *bench.cell("tiny_stub.serve_b1")
                                   .config["limits"]["serve"]}
    if trace:
        assert "trunk" in rec.spans and "backbone" not in rec.spans
        assert "host_cpu_ms.latency" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"latency_p95_ms", "setup_s"}
