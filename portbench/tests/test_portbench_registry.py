"""The registry finds every configuration, model family, traffic mix and
metric reader that BENCHMARK.json names, and a cell, a family and its tiny
configuration are added by files and entries alone."""

import json
import re
import shutil

import pytest

from portbench.registry import ROOT, Bench, family_name
from portbench.tests.tiny import add_stub_family, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNITS = {"img/s", "ms", "s", "%", "GiB", "count"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return Bench()


def test_every_cell_resolves(bench):
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert (ROOT / "portbench" / "kinds" / f"{cell.mix['kind']}.py").is_file()
        assert (ROOT / "portbench" / "families" / f"{family_name(cell.config)}.py").is_file()
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]


def test_every_metric_has_a_reader(bench):
    for m in bench.spec["per_layer"]:
        assert callable(bench.reader(m["name"])), m["name"]


def test_contract_shape(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["unit"] in UNITS and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES, m["name"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in spec["workloads"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells and ("workloads" not in moved or w in moved["workloads"]), m["name"]
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_cell_is_added_by_files_alone(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert not (root / "portbench" / "families" / "stub.py").exists()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "portbench" / "mixes" / "serve_b8.json").read_text())
    (root / "portbench" / "mixes" / "serve_b2.json").write_text(json.dumps(dict(mix, batch=2)))
    (root / "portbench" / "metrics" / "answer.serve2.py").write_text(
        "def read(rec):\n    return 42.0\n")
    spec["workloads"].append({"name": "pairnet_r50.serve_b2", "config": "pairnet_r50",
                              "traffic": "serve_b2", "chips": 1, "why": "batch 2"})
    spec["per_layer"].append({"name": "answer.serve2", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "test", "moves": "setup_s",
                              "workloads": ["pairnet_r50.serve_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root)
    cell = bench.cell("pairnet_r50.serve_b2")
    assert cell.mix["batch"] == 2 and cell.config["name"] == "pairnet_r50"
    assert [m["name"] for m in cell.per_layer] == ["answer.serve2"]
    assert bench.reader("answer.serve2")(None) == 42.0
    # a quantity split by the metric it moves shares the reader of its name,
    # unless the split has a file of its own
    (root / "portbench" / "metrics" / "answer.py").write_text("def read(rec):\n    return 7.0\n")
    assert bench.reader("answer.train")(None) == 7.0
    assert bench.reader("answer.serve2")(None) == 42.0
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.serve")
    with pytest.raises(KeyError):
        Bench().cell("pairnet_r50.serve_b2")
    # a model family, its configuration and its tiny configuration
    add_stub_family(root)
    bench = Bench(root)
    cell = bench.cell("stub_r50.serve_b1")
    assert family_name(cell.config) == "stub" and cell.family.BOUNDARIES[0] == ("trunk", "backbone")
    assert [m["name"] for m in cell.end_to_end] == ["latency_p95_ms", "setup_s"]
    assert bench.cell("pairnet_r50.serve_b1").family.BOUNDARIES[0] == ("backbone", "backbone")
    tiny = Bench(make_root(tmp_path / "tiny", root))
    cell = tiny.cell("tiny_stub.serve_b1")
    assert cell.config["name"] == "tiny_stub" and cell.family.BOUNDARIES[0][0] == "trunk"
    assert "tiny_stub.serve_b8" not in {w["name"] for w in tiny.spec["workloads"]}
    with pytest.raises(FileNotFoundError):
        bench.family("no_such_family")
