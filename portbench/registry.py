"""Finds what ``BENCHMARK.json`` names: a cell's configuration file, its
model family (``portbench/families/<family>.py``, the configuration's
``family``, else ``pairnet``), its traffic mix
(``portbench/mixes/<traffic>.json``), the code that runs it
(``portbench/kinds/<kind>.py``, the mix's ``kind``) and each metric's
reader (``portbench/metrics/<metric>.py``, or ``<name>.py`` for a metric
``<name>.<suffix>``). A cell, a mix, a configuration, a family or a metric
is added with files and entries alone."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout: BENCHMARK.json's directory
DEFAULT_FAMILY = "pairnet"  # of a configuration without a ``family`` key


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    family: object  # the module portbench/families/<family>.py
    mix: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def family_name(config: dict) -> str:
    return config.get("family", DEFAULT_FAMILY)


def _load(path: Path, name: str):
    """The module of the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = json.loads((self.root / configs[w["config"]]["file"]).read_text())
        mix = json.loads((self.root / "portbench" / "mixes" / f"{w['traffic']}.json").read_text())
        return Cell(
            name=name, chips=int(w["chips"]), config=config,
            family=self.family(family_name(config)), mix=mix,
            end_to_end=[m for m in self.spec["end_to_end"] if _applies(m, name)],
            per_layer=[m for m in self.spec["per_layer"] if _applies(m, name)],
        )

    def family(self, name: str):
        """The module ``portbench/families/<name>.py`` of the checkout."""
        path = self.root / "portbench" / "families" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no model family {name!r} in {path.parent}")
        return _load(path, f"portbench_family_{name}")

    def reader(self, metric: str):
        """The ``read(record)`` function of ``portbench/metrics/<metric>.py``,
        or for ``<name>.<suffix>`` (a quantity split by the end-to-end metric
        it moves) of ``<name>.py`` where there is no file of its own."""
        folder = self.root / "portbench" / "metrics"
        path = folder / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = folder / f"{metric.rsplit('.', 1)[0]}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader for metric {metric!r} in {folder}")
        return _load(path, f"portbench_metric_{metric}").read
