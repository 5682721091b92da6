"""A copy of the benchmark at tiny sizes, for the harness's CPU tests: a
checkout's ``portbench`` under a temporary root, beside a
``BENCHMARK.json`` whose cells run the tiny configurations of
``portbench/tests/tiny_configs/`` (Pair-Net: R-50 at base width 8, a
4-block Swin, on 64x96 images, in float32) under the checkout's traffic
mixes and metrics. Each tiny configuration takes every cell of a
configuration of its family; a family brings its tiny cells with a file
there."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.registry import family_name

PORTBENCH = Path(__file__).resolve().parent.parent
TINY = {p.stem: json.loads(p.read_text())
        for p in sorted((PORTBENCH / "tests" / "tiny_configs").glob("*.json"))}
TINY_HEAD = TINY["tiny_r50"]["model"]["head"]
BACKBONES = {name: cfg["model"]["backbone"] for name, cfg in TINY.items()
             if family_name(cfg) == "pairnet"}


def make_root(tmp: Path, checkout: Path = PORTBENCH.parent) -> Path:
    """A checkout-like root under ``tmp`` with the tiny configurations of
    ``checkout`` and, for each cell of ``checkout``'s ``BENCHMARK.json``,
    one cell a tiny configuration of the same family."""
    root = Path(tmp) / "root"
    shutil.copytree(checkout / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    families = {c["name"]: family_name(json.loads((checkout / c["file"]).read_text()))
                for c in bench["configs"]}
    tiny = {p.stem: json.loads(p.read_text())
            for p in sorted((checkout / "portbench" / "tests" / "tiny_configs").glob("*.json"))}
    configs = []
    for name, cfg in tiny.items():
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": name, "source": "tiny", "file": f"portbench/configs/{name}.json",
                        "reduced": [], "why": "tiny"})
    cells, origin = {}, {}  # tiny cell -> its entry, the checkout's cells it stands for
    for w in bench["workloads"]:
        for name, cfg in tiny.items():
            if family_name(cfg) == families[w["config"]]:
                cell = f"{name}.{w['traffic']}"
                cells.setdefault(cell, dict(w, name=cell, config=name))
                origin.setdefault(cell, set()).add(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c, ws in origin.items() if ws & set(m["workloads"])]
    bench.update(configs=configs, workloads=list(cells.values()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


STUB_FAMILY = '''"""A second model family for the harness's tests: Pair-Net's pieces under
another name, its first stage span renamed and one more check."""

from portbench.families import pairnet
from portbench.families.pairnet import Taps, build, shape_counts, stand_in, weights  # noqa: F401

BOUNDARIES = (("trunk", "backbone"),) + pairnet.BOUNDARIES[1:]


def reference_check(cell, seed, dev, kept, pool):
    return dict(pairnet.reference_check(cell, seed, dev, kept, pool), family_stub=(0.0, 0.0))
'''


def add_stub_family(checkout: Path) -> None:
    """Add to ``checkout`` a model family ``stub`` (``STUB_FAMILY``), its
    configuration ``stub_r50``, its tiny configuration ``tiny_stub`` and a
    cell ``stub_r50.serve_b1`` with the latency metrics, by new files and
    ``BENCHMARK.json`` entries alone."""
    pb = checkout / "portbench"
    (pb / "families" / "stub.py").write_text(STUB_FAMILY)
    for src, name in ((pb / "configs" / "pairnet_r50.json", "stub_r50"),
                      (pb / "tests" / "tiny_configs" / "tiny_r50.json", "tiny_stub")):
        cfg = dict(json.loads(src.read_text()), name=name, family="stub")
        (src.parent / f"{name}.json").write_text(json.dumps(cfg))
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "stub_r50", "source": "test", "reduced": [], "why": "test",
                            "file": "portbench/configs/stub_r50.json"})
    spec["workloads"].append({"name": "stub_r50.serve_b1", "config": "stub_r50",
                              "traffic": "serve_b1", "chips": 1, "why": "a second family"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "pairnet_r50.serve_b1" in m.get("workloads", ()):
            m["workloads"].append("stub_r50.serve_b1")
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
