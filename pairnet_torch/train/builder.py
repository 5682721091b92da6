"""Config -> dataset / pipeline / model assembly for the CLIs (the port's
counterpart of ``pairnet_tpu/train/builder.py``)."""

from __future__ import annotations

import os
from pathlib import Path

from pairnet_torch.config import Config
from pairnet_torch.config.registry import DATASETS
from pairnet_torch.data.pipeline import PipelineConfig
from pairnet_torch.data.psg import PSGDataset  # noqa: F401  (registers PSGDataset)
from pairnet_torch.data.sg import BalancedRelationDataset  # also registers the box datasets
from pairnet_torch.models.frameworks.psgtr import build_model

# synthetic fixtures are cached here, keyed by their generator options
SYNTHETIC_ROOT = Path(__file__).resolve().parent.parent / "_build" / "synthetic"


def build_pipeline_cfg(cfg: Config, train: bool) -> PipelineConfig:
    p = dict(cfg.data.pipeline)
    if not train:
        p.pop("train_scales", None)
        p["flip_prob"] = 0.0
        p["crop_prob"] = 0.0
    p["target_size"] = tuple(p["target_size"])
    if "train_scales" in p:
        p["train_scales"] = tuple(p["train_scales"])
    return PipelineConfig(**p)


def synthetic_root(opts: dict) -> str:
    """The fixture of the generator options ``opts``, generated on first
    use: written under a private name, then renamed into place, so that
    processes that race for it all find a whole one."""
    tag = "_".join(f"{k}{opts[k]}" for k in sorted(opts))
    root = SYNTHETIC_ROOT / tag
    if not (root / "psg.json").exists():
        from pairnet_torch.data.synthetic import make_synthetic_psg

        tmp = SYNTHETIC_ROOT / f".{tag}.{os.getpid()}"
        make_synthetic_psg(str(tmp), **opts)
        try:
            os.rename(tmp, root)
        except OSError:  # another process put it there first
            import shutil

            shutil.rmtree(tmp)
    return str(root)


def build_dataset(cfg: Config, split: str):
    """The dataset of ``cfg.data.dataset``. ``synthetic=True`` with an empty
    ``data_root`` gives the default 8-image fixture, ``synthetic=dict(...)``
    passes generator options (num_images, height, width, ...); a box-only
    dataset (VG, OIV6) reads it as a box-only split named by its
    ``ann_file``. With ``balanced=dict(oversample_thr=...)`` the train
    split is wrapped in the balanced relation sampler."""
    d = dict(cfg.data.dataset)
    ds_type = d.pop("type", "PSGDataset")
    synthetic = d.pop("synthetic", False)
    balanced = d.pop("balanced", None)
    if synthetic and not d.get("data_root"):
        opts = dict(synthetic) if isinstance(synthetic, dict) else {}
        opts.setdefault("num_images", 8)
        opts.setdefault("num_test", 3)
        opts.setdefault("seed", 1)
        d["data_root"] = synthetic_root(opts)
        if ds_type in DATASETS and getattr(DATASETS.get(ds_type), "detection_method",
                                           None) == "bbox":
            from pairnet_torch.data.synthetic import write_box_only_split

            write_box_only_split(d["data_root"], d.get("ann_file", "psg.json"))
    if ds_type not in DATASETS:
        raise NotImplementedError(f"dataset type {ds_type!r} is not ported yet (ROADMAP "
                                  "queue A)")
    ds = DATASETS.get(ds_type)(split=split, **d)
    if balanced and split == "train":
        ds = BalancedRelationDataset(ds, **dict(balanced))
    return ds


def build_detector(cfg: Config, device=None, seed: int = 0):
    return build_model(cfg.model, device=device, seed=seed)
