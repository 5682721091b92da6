"""A copy of the benchmark at tiny sizes, for the harness's CPU tests: the
repository's ``portbench`` under a temporary root, beside a
``BENCHMARK.json`` whose cells run tiny Pair-Nets (R-50 at base width 8,
a 4-block Swin) on 64x96 images, with the repository's traffic mixes and
metrics."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
TINY_HEAD = dict(num_classes=7, num_relations=5, num_obj_query=20, num_rel_query=16,
                 embed_dims=32, num_heads=4, num_decoder_layers=3, num_relation_layers=2,
                 num_feat_levels=3, pixel_decoder_layers=1, pixel_decoder_ffn=64,
                 decoder_ffn=64, relation_ffn=64, relation_ffn_drop=0.1, mapper="conv_tiny")
TINY_TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap_median": 1e-3,
                     "assign_gap": 1e-4, "targets_mismatch": 0}
BACKBONES = {
    "tiny_r50": {"type": "ResNet", "depth": 50, "base_width": 8},
    "tiny_swin": {"type": "SwinTransformer", "embed_dim": 16, "depths": [1, 1, 2, 1],
                  "num_heads": [1, 2, 4, 8], "window": 4},
}


def make_root(tmp: Path, seconds_mix: dict | None = None) -> Path:
    """A checkout-like root under ``tmp`` with the tiny configurations and
    one cell per (tiny configuration, repository mix)."""
    root = Path(tmp) / "root"
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    base = json.loads((PORTBENCH / "configs" / "pairnet_r50.json").read_text())
    configs = []
    for name, bb in BACKBONES.items():
        cfg = copy.deepcopy(base)
        cfg.update(name=name, image_hw=[64, 96], num_things=4)
        cfg["model"] = {"backbone": bb, "head": TINY_HEAD}
        # the tiny cells compute in float32, where the reference follows the
        # system to rounding (bf16 at these widths strays further than the
        # full-width cells' limits allow)
        cfg["serve"] = {"dtype": "float32", "msda": "exact"}
        cfg["train"]["compute_dtype"] = "float32"
        cfg["limits"]["train"] = TINY_TRAIN_LIMITS
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append({"name": name, "source": "tiny", "file": f"portbench/configs/{name}.json",
                        "reduced": [], "why": "tiny"})
    cells = []
    for w in bench["workloads"]:
        for name in BACKBONES:
            cells.append(dict(w, name=f"{name}.{w['traffic']}", config=name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c["name"] for c in cells
                              if any(c["traffic"] == t.split(".", 1)[1]
                                     for t in m["workloads"])]
    bench.update(configs=configs, workloads=cells)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
